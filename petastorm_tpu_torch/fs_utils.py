"""Filesystem/URL resolution: one dataset URL (or a list of them) in,
(filesystem, path or paths) out.

``file://`` URLs (and bare paths) resolve to fsspec's local filesystem; any
other fsspec scheme (``s3://``, ``gs://``, ``memory://`` ...) goes through
``fsspec.core.url_to_fs``. ``hdfs://`` needs the namenode HA resolver, which
this package does not have yet, and is refused.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union
from urllib.parse import urlparse


def normalize_dir_url(dataset_url: str) -> str:
    """Require a string, default bare paths to ``file://``, strip trailing
    slashes."""
    if not isinstance(dataset_url, str):
        raise ValueError(f"dataset_url must be a string, got {type(dataset_url)}")
    dataset_url = dataset_url.rstrip("/")
    if not urlparse(dataset_url).scheme:
        dataset_url = "file://" + dataset_url
    return dataset_url


def normalize_dataset_url_or_urls(url_or_urls):
    """:func:`normalize_dir_url` of one URL, or of each URL of a non-empty
    list."""
    if isinstance(url_or_urls, (list, tuple)):
        if not url_or_urls:
            raise ValueError("empty url list")
        return [normalize_dir_url(u) for u in url_or_urls]
    return normalize_dir_url(url_or_urls)


class FilesystemResolver:
    """Resolves a dataset URL into an fsspec filesystem plus a bare path.

    :param dataset_url: e.g. ``file:///tmp/ds``, ``s3://bucket/ds``,
        ``memory://ds``
    :param storage_options: keyword arguments of the fsspec filesystem
        (credentials, endpoints, ...); the local filesystem takes none
    :param filesystem: a filesystem to use as it is (no resolution)
    """

    def __init__(self, dataset_url: str, storage_options: Optional[dict] = None,
                 filesystem=None):
        self._dataset_url = normalize_dir_url(dataset_url)
        self._parsed = urlparse(self._dataset_url)
        scheme = self._parsed.scheme
        if filesystem is not None:
            self._filesystem = filesystem
            self._path = (self._parsed.path if scheme in ("file", "")
                          else self._parsed.netloc + self._parsed.path)
            return
        import fsspec
        if scheme == "file":
            self._filesystem = fsspec.filesystem("file")
            self._path = self._parsed.path
        elif scheme == "hdfs":
            raise ValueError(f"{self._dataset_url}: hdfs:// stores are not supported by "
                             f"petastorm_tpu_torch yet")
        else:
            self._filesystem, self._path = fsspec.core.url_to_fs(self._dataset_url,
                                                                 **(storage_options or {}))

    def filesystem(self):
        return self._filesystem

    def get_dataset_path(self) -> str:
        return self._path

    @property
    def parsed_dataset_url(self):
        return self._parsed


def get_filesystem_and_path_or_paths(
        url_or_urls: Union[str, Sequence[str]], storage_options: Optional[dict] = None,
        filesystem=None) -> Tuple[object, Union[str, list]]:
    """One URL, or a list of URLs that share their scheme and netloc (they
    are read through one filesystem), -> (filesystem, path or paths);
    ``storage_options`` and ``filesystem`` as :class:`FilesystemResolver`."""
    urls = normalize_dataset_url_or_urls(url_or_urls)
    url_list = urls if isinstance(urls, list) else [urls]
    if len({urlparse(u)[:2] for u in url_list}) != 1:
        raise ValueError(f"All dataset URLs must share scheme and netloc, got {url_list}")
    fs = FilesystemResolver(url_list[0], storage_options=storage_options,
                            filesystem=filesystem).filesystem()
    paths = [fs._strip_protocol(u) for u in url_list]
    return fs, (paths if isinstance(urls, list) else paths[0])
