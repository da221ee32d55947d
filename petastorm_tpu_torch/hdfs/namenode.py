"""HDFS high-availability namenode resolution and failover.

:class:`HdfsNamenodeResolver` reads the Hadoop client configuration
(``core-site.xml`` and ``hdfs-site.xml``, found through ``HADOOP_CONF_DIR``,
``HADOOP_INSTALL``, ``HADOOP_HOME`` or ``HADOOP_PREFIX``, or given as a
mapping) and turns a logical nameservice into its namenodes' ``host:port``
endpoints. :class:`HdfsConnector` connects to the first namenode that
answers, through ``pyarrow.fs.HadoopFileSystem`` (libhdfs) wrapped for
fsspec, and :class:`HAHdfsClient` fails a call over to the next namenode on a
connection-level error, under :data:`FAILOVER_POLICY`, a
:class:`~petastorm_tpu_torch.resilience.RetryPolicy`. Definite answers of a
healthy filesystem (a missing file, a refused permission) are never retried.

It imports neither torch nor pyarrow's HDFS client until a connection is
made.
"""
from __future__ import annotations

import functools
import logging
import os
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

from petastorm_tpu_torch.resilience.policy import (PERMANENT, ExponentialBackoff, RetryPolicy,
                                                   failover_classifier)

logger = logging.getLogger(__name__)

#: Failovers a call may make; it is tried this many times plus one.
MAX_NAMENODE_FAILOVER_ATTEMPTS = 2

#: One try a failover, at once (an HA pair's standby is ready now or not at
#: all: waiting only delays the switch), transient and definite errors told
#: apart by :func:`~petastorm_tpu_torch.resilience.failover_classifier`.
FAILOVER_POLICY = RetryPolicy(
    max_attempts=MAX_NAMENODE_FAILOVER_ATTEMPTS + 1,
    backoff=ExponentialBackoff(base=0.0, multiplier=1.0, cap=0.0),
    jitter="none", seed=0, classify=failover_classifier)


class HdfsConnectError(IOError):
    pass


class HadoopConfiguration(dict):
    """Hadoop configuration properties, a plain dict."""


def _read_hadoop_xml(path: str) -> dict:
    """``{name: value}`` of a Hadoop configuration file's ``<property>``
    elements (those without a name are skipped)."""
    props = {}
    for prop in ET.parse(path).getroot().iter("property"):
        name = prop.findtext("name")
        if name is not None:
            props[name] = prop.findtext("value")
    return props


class HdfsNamenodeResolver:
    """Resolves logical HDFS nameservices to namenode endpoints.

    :param hadoop_configuration: a mapping of Hadoop properties; without
        one, ``core-site.xml`` and ``hdfs-site.xml`` are read from the first
        of ``$HADOOP_CONF_DIR``, ``$HADOOP_INSTALL/etc/hadoop``,
        ``$HADOOP_HOME/etc/hadoop`` and ``$HADOOP_PREFIX/etc/hadoop`` that
        holds either
    """

    def __init__(self, hadoop_configuration=None):
        if hadoop_configuration is None:
            hadoop_configuration = self._discover_configuration()
        self._config = hadoop_configuration or {}

    @staticmethod
    def _discover_configuration() -> Optional[dict]:
        candidates = []
        if os.environ.get("HADOOP_CONF_DIR"):
            candidates.append(os.environ["HADOOP_CONF_DIR"])
        for env in ("HADOOP_INSTALL", "HADOOP_HOME", "HADOOP_PREFIX"):
            if os.environ.get(env):
                candidates.append(os.path.join(os.environ[env], "etc", "hadoop"))
        for conf_dir in candidates:
            props, found = {}, False
            for fname in ("core-site.xml", "hdfs-site.xml"):
                fpath = os.path.join(conf_dir, fname)
                if os.path.isfile(fpath):
                    props.update(_read_hadoop_xml(fpath))
                    found = True
            if found:
                return HadoopConfiguration(props)
        return None

    def resolve_hdfs_name_service(self, nameservice: str) -> Optional[List[str]]:
        """The namenodes' ``host:port`` endpoints of ``nameservice``, or
        None when it is not a configured nameservice (the netloc is a
        ``host:port`` already)."""
        services = (self._config.get("dfs.nameservices") or "").split(",")
        if nameservice not in [s.strip() for s in services if s]:
            return None
        ha_key = f"dfs.ha.namenodes.{nameservice}"
        namenode_ids = [n.strip() for n in (self._config.get(ha_key) or "").split(",")
                        if n.strip()]
        if not namenode_ids:
            raise HdfsConnectError(
                f"Nameservice {nameservice!r} is declared but {ha_key} is missing/empty")
        endpoints = []
        for nn in namenode_ids:
            addr = self._config.get(f"dfs.namenode.rpc-address.{nameservice}.{nn}")
            if not addr:
                raise HdfsConnectError(
                    f"Missing dfs.namenode.rpc-address.{nameservice}.{nn} in hadoop config")
            endpoints.append(addr)
        return endpoints

    def resolve_default_hdfs_service(self) -> Tuple[str, List[str]]:
        """``fs.defaultFS`` as ``(nameservice or host:port, endpoints)``."""
        default_fs = self._config.get("fs.defaultFS") or ""
        if not default_fs.startswith("hdfs://"):
            raise HdfsConnectError(f"fs.defaultFS is not an HDFS URL: {default_fs!r}")
        netloc = default_fs[len("hdfs://"):].rstrip("/")
        endpoints = self.resolve_hdfs_name_service(netloc)
        return netloc, endpoints if endpoints is not None else [netloc]


def namenode_failover(func):
    """Runs a client method under :data:`FAILOVER_POLICY`: a
    connection-level error reconnects to the next namenode and retries, up
    to :data:`MAX_NAMENODE_FAILOVER_ATTEMPTS` failovers; a definite answer
    propagates as it is. After the last failed try the client fails over
    once more (its next call starts on another namenode, not on the one
    that just failed) and raises :class:`HdfsConnectError`."""
    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        def _on_retry(attempt, exc, _delay):
            logger.warning("HDFS call %s failed (attempt %d): %s; failing over",
                           func.__name__, attempt, exc)
            self._do_failover()

        try:
            return FAILOVER_POLICY.call(functools.partial(func, self, *args, **kwargs),
                                        on_retry=_on_retry)
        except Exception as e:  # noqa: BLE001 - the classifier has ruled
            if failover_classifier(e) == PERMANENT:
                raise
            self._do_failover()
            raise HdfsConnectError(f"HDFS call {func.__name__} failed after "
                                   f"{FAILOVER_POLICY.max_attempts} attempts") from e
    return wrapper


class HAHdfsClient:
    """A filesystem proxy that fails each call over between namenodes.

    The methods of :attr:`_PROXIED` (the fsspec calls the package makes)
    run under :func:`namenode_failover`; any other attribute is the
    connected filesystem's. ``fault_plan`` (a
    :class:`~petastorm_tpu_torch.resilience.FaultPlan`) is consulted at the
    ``hdfs.call`` site, keyed by the method's name, before each try, so the
    failover path runs without a broken namenode.
    """

    _PROXIED = ("ls", "isdir", "isfile", "exists", "open", "info", "glob",
                "makedirs", "rm", "mkdir", "cat_file", "pipe_file")

    def __init__(self, connector_cls, namenodes: List[str], user=None,
                 storage_options=None, fault_plan=None):
        self._connector_cls = connector_cls
        self._namenodes = list(namenodes)
        self._index = 0
        self._user = user
        self._storage_options = storage_options or {}
        self._fault_plan = fault_plan
        self._fs = self._connect(self._namenodes[self._index])

    def _connect(self, namenode: str):
        return self._connector_cls.hdfs_connect_namenode(namenode, user=self._user,
                                                         **self._storage_options)

    def _do_failover(self):
        self._index = (self._index + 1) % len(self._namenodes)
        try:
            self._fs = self._connect(self._namenodes[self._index])
        except (IOError, OSError) as e:
            logger.warning("Failover connect to %s failed: %s", self._namenodes[self._index], e)

    def __getattr__(self, name):
        if name in type(self)._PROXIED:
            @namenode_failover
            def call(self, *args, __name=name, **kwargs):
                if self._fault_plan is not None:
                    self._fault_plan.fire("hdfs.call", key=__name)
                return getattr(self._fs, __name)(*args, **kwargs)
            return functools.partial(call, self)
        return getattr(self._fs, name)


class HdfsConnector:
    """Connects to the first namenode of a list that answers."""

    MAX_NAMENODES = 2

    @classmethod
    def hdfs_connect_namenode(cls, netloc: str, user=None, **kwargs):
        """An fsspec filesystem over ``pyarrow.fs.HadoopFileSystem`` at
        ``host[:port]`` (port 8020 by default)."""
        host, _, port = netloc.partition(":")
        from fsspec.implementations.arrow import ArrowFSWrapper
        from pyarrow import fs as pafs
        return ArrowFSWrapper(pafs.HadoopFileSystem(host=host, port=int(port or 8020),
                                                    user=user, **kwargs))

    @classmethod
    def connect_to_either_namenode(cls, namenodes: List[str], user=None,
                                   storage_options=None, fault_plan=None):
        """An :class:`HAHdfsClient` on the first of ``namenodes`` (at most
        :attr:`MAX_NAMENODES` + 1 of them, in turn) that connects; the
        others follow it in the failover order."""
        errors = []
        for i, nn in enumerate(namenodes[:cls.MAX_NAMENODES + 1]):
            try:
                return HAHdfsClient(cls, namenodes[i:] + namenodes[:i], user=user,
                                    storage_options=storage_options, fault_plan=fault_plan)
            except (IOError, OSError) as e:
                errors.append((nn, e))
                logger.warning("Could not connect to namenode %s: %s", nn, e)
        raise HdfsConnectError(f"Could not connect to any namenode of {namenodes}: {errors}")
