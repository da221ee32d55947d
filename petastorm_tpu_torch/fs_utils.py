"""Filesystem/URL resolution: one dataset URL (or a list of them) in,
(filesystem, path or paths) out.

``file://`` URLs (and bare paths) resolve to fsspec's local filesystem;
``hdfs://`` goes through the HA namenode resolver and connector
(:mod:`petastorm_tpu_torch.hdfs.namenode`): a nameservice becomes its
namenodes, and calls fail over between them; any other fsspec scheme
(``s3://``, ``gs://``, ``memory://`` ...) goes through
``fsspec.core.url_to_fs``.
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
        ``hdfs://nameservice1/ds``, ``hdfs:///ds`` (``fs.defaultFS``),
        ``memory://ds``
    :param hadoop_configuration: Hadoop properties for the HA namenode
        resolution of an ``hdfs://`` URL (default: the configuration files
        that ``HADOOP_CONF_DIR`` or ``HADOOP_HOME`` point to)
    :param storage_options: keyword arguments of the fsspec filesystem
        (credentials, endpoints, ...), or of ``pyarrow.fs.HadoopFileSystem``
        for ``hdfs://``; the local filesystem takes none
    :param filesystem: a filesystem to use as it is (no resolution)
    :param user: the HDFS user to connect as
    """

    def __init__(self, dataset_url: str, hadoop_configuration=None,
                 storage_options: Optional[dict] = None, filesystem=None,
                 user: Optional[str] = None):
        self._dataset_url = normalize_dir_url(dataset_url)
        self._parsed = urlparse(self._dataset_url)
        scheme = self._parsed.scheme
        if filesystem is not None:
            self._filesystem = filesystem
            # An hdfs netloc is a namenode or a nameservice, never a path.
            self._path = (self._parsed.path if scheme in ("file", "", "hdfs")
                          else self._parsed.netloc + self._parsed.path)
            return
        if scheme == "file":
            import fsspec
            self._filesystem = fsspec.filesystem("file")
            self._path = self._parsed.path
        elif scheme == "hdfs":
            from petastorm_tpu_torch.hdfs.namenode import HdfsConnector, HdfsNamenodeResolver
            resolver = HdfsNamenodeResolver(hadoop_configuration)
            if self._parsed.netloc:
                namenodes = (resolver.resolve_hdfs_name_service(self._parsed.netloc)
                             or [self._parsed.netloc])
            else:
                namenodes = resolver.resolve_default_hdfs_service()[1]
            self._filesystem = HdfsConnector.connect_to_either_namenode(
                namenodes, user=user, storage_options=storage_options or {})
            self._path = self._parsed.path
        else:
            import fsspec
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
        url_or_urls: Union[str, Sequence[str]], hadoop_configuration=None,
        storage_options: Optional[dict] = None,
        filesystem=None) -> Tuple[object, Union[str, list]]:
    """One URL, or a list of URLs that share their scheme and netloc (they
    are read through one filesystem), -> (filesystem, path or paths);
    ``hadoop_configuration``, ``storage_options`` and ``filesystem`` as
    :class:`FilesystemResolver`."""
    urls = normalize_dataset_url_or_urls(url_or_urls)
    url_list = urls if isinstance(urls, list) else [urls]
    parsed = [urlparse(u) for u in url_list]
    if len({p[:2] for p in parsed}) != 1:
        raise ValueError(f"All dataset URLs must share scheme and netloc, got {url_list}")
    fs = FilesystemResolver(url_list[0], hadoop_configuration=hadoop_configuration,
                            storage_options=storage_options,
                            filesystem=filesystem).filesystem()

    def _strip(url, parsed_url):
        if hasattr(fs, "_strip_protocol"):
            return fs._strip_protocol(url)
        # An hdfs netloc names a namenode, never part of the path; an object
        # store addresses by bucket, which stays in the path.
        if parsed_url.scheme in ("file", "", "hdfs") or not parsed_url.netloc:
            return parsed_url.path
        return parsed_url.netloc + parsed_url.path

    paths = [_strip(u, p) for u, p in zip(url_list, parsed)]
    return fs, (paths if isinstance(urls, list) else paths[0])
