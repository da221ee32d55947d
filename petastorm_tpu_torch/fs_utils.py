"""Filesystem/URL resolution: one dataset URL in, (filesystem, path) out.

``file://`` URLs (and bare paths) resolve to fsspec's local filesystem; any
other fsspec scheme (``s3://``, ``gs://``, ``memory://`` ...) goes through
``fsspec.core.url_to_fs``. ``hdfs://`` needs the namenode HA resolver, which
this package does not have yet, and is refused.
"""
from __future__ import annotations

from typing import Tuple
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


def get_filesystem_and_path(dataset_url: str) -> Tuple[object, str]:
    """Resolve ``dataset_url`` to an fsspec filesystem (default options)
    and a bare path."""
    import fsspec
    url = normalize_dir_url(dataset_url)
    parsed = urlparse(url)
    if parsed.scheme == "file":
        return fsspec.filesystem("file"), parsed.path
    if parsed.scheme == "hdfs":
        raise ValueError(f"{url}: hdfs:// stores are not supported by "
                         f"petastorm_tpu_torch yet")
    return fsspec.core.url_to_fs(url)
