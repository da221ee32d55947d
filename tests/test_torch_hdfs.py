"""The HDFS HA namenode resolver and failover client, the port's against the
JAX package's: every case of ``tests/test_hdfs_namenode.py`` and
``tests/test_hdfs_depth.py`` runs on both packages' ``hdfs.namenode``, with
mock connectors (no Hadoop, no namenode is contacted). Then an ``hdfs://``
URL through ``FilesystemResolver`` and a whole read through ``make_reader``,
over a mock connector that serves a local directory, with the first
namenode down."""
import importlib

import numpy as np
import pytest

HADOOP_CONFIG = {
    "fs.defaultFS": "hdfs://nameservice1",
    "dfs.nameservices": "nameservice1",
    "dfs.ha.namenodes.nameservice1": "nn1,nn2",
    "dfs.namenode.rpc-address.nameservice1.nn1": "host1:8020",
    "dfs.namenode.rpc-address.nameservice1.nn2": "host2:8020",
}

CONFIG = {
    "fs.defaultFS": "hdfs://ns1",
    "dfs.nameservices": "ns1,ns2",
    "dfs.ha.namenodes.ns1": "nn1,nn2",
    "dfs.namenode.rpc-address.ns1.nn1": "a:8020",
    "dfs.namenode.rpc-address.ns1.nn2": "b:8020",
    "dfs.ha.namenodes.ns2": "nnA",
    "dfs.namenode.rpc-address.ns2.nnA": "c:9000",
}

PACKAGES = {"jax": "petastorm_tpu", "port": "petastorm_tpu_torch"}


@pytest.fixture(params=sorted(PACKAGES))
def nn(request, monkeypatch):
    """One package's ``hdfs.namenode``, with a mock connector class of its
    own (``nn.Connector``: ``fs_by_host`` maps a namenode to its
    filesystem; a missing one refuses the connection)."""
    module = importlib.import_module(f"{PACKAGES[request.param]}.hdfs.namenode")

    class Connector(module.HdfsConnector):
        fs_by_host = {}

        @classmethod
        def hdfs_connect_namenode(cls, netloc, user=None, **kwargs):
            fs = cls.fs_by_host.get(netloc)
            if fs is None:
                raise IOError(f"no route to {netloc}")
            return fs

    module.Connector = Connector
    for env in ("HADOOP_CONF_DIR", "HADOOP_INSTALL", "HADOOP_HOME", "HADOOP_PREFIX"):
        monkeypatch.delenv(env, raising=False)
    yield module
    del module.Connector


class _MockFs:
    """Counts calls; fails the first ``failures`` calls with IOError."""

    def __init__(self, name, failures=0):
        self.name = name
        self.failures = failures
        self.calls = 0

    def _call(self):
        self.calls += 1
        if self.failures > 0:
            self.failures -= 1
            raise IOError(f"{self.name} down")

    def ls(self, path):
        self._call()
        return [f"{path}/ok-from-{self.name}"]

    def open(self, path, mode="rb"):
        self._call()
        return f"handle-from-{self.name}"

    def info(self, path):
        self._call()
        return {"name": path, "via": self.name}


class _Fs:
    """A filesystem whose calls fail ``fail_times`` times with ``error``."""

    def __init__(self, name, error=None, fail_times=0):
        self.name = name
        self.error = error
        self.fail_times = fail_times
        self.calls = {"ls": 0, "exists": 0, "info": 0}

    def _maybe_fail(self, what):
        self.calls[what] += 1
        if self.fail_times > 0:
            self.fail_times -= 1
            raise (self.error or IOError)(f"{self.name} unavailable")

    def ls(self, path):
        self._maybe_fail("ls")
        return [f"{path}@{self.name}"]

    def exists(self, path):
        self._maybe_fail("exists")
        return True

    def info(self, path):
        self._maybe_fail("info")
        return {"name": path, "server": self.name}


# ------------------------------------------------------------------ resolver
def test_resolve_nameservice(nn):
    r = nn.HdfsNamenodeResolver(HADOOP_CONFIG)
    assert r.resolve_hdfs_name_service("nameservice1") == ["host1:8020", "host2:8020"]
    assert r.resolve_hdfs_name_service("somehost:8020") is None


def test_resolve_default_service(nn):
    assert nn.HdfsNamenodeResolver(HADOOP_CONFIG).resolve_default_hdfs_service() == \
        ("nameservice1", ["host1:8020", "host2:8020"])


def test_missing_rpc_address_raises(nn):
    cfg = dict(HADOOP_CONFIG)
    del cfg["dfs.namenode.rpc-address.nameservice1.nn2"]
    with pytest.raises(nn.HdfsConnectError, match="rpc-address"):
        nn.HdfsNamenodeResolver(cfg).resolve_hdfs_name_service("nameservice1")


def test_non_hdfs_default_fs_raises(nn):
    with pytest.raises(nn.HdfsConnectError, match="not an HDFS URL"):
        nn.HdfsNamenodeResolver({"fs.defaultFS": "file:///"}).resolve_default_hdfs_service()


def test_multiple_nameservices_resolve_independently(nn):
    r = nn.HdfsNamenodeResolver(CONFIG)
    assert r.resolve_hdfs_name_service("ns1") == ["a:8020", "b:8020"]
    assert r.resolve_hdfs_name_service("ns2") == ["c:9000"]


def test_nameservice_list_with_whitespace(nn):
    r = nn.HdfsNamenodeResolver(dict(CONFIG, **{"dfs.nameservices": " ns1 , ns2 "}))
    assert r.resolve_hdfs_name_service("ns1") == ["a:8020", "b:8020"]


def test_declared_nameservice_without_namenodes_raises(nn):
    with pytest.raises(nn.HdfsConnectError, match="missing/empty"):
        nn.HdfsNamenodeResolver(dict(CONFIG, **{"dfs.ha.namenodes.ns1": ""})) \
            .resolve_hdfs_name_service("ns1")


@pytest.mark.parametrize("default_fs,want", [
    ("hdfs://ns1/", ("ns1", ["a:8020", "b:8020"])),
    ("hdfs://myhost:9000", ("myhost:9000", ["myhost:9000"]))], ids=["slash", "hostport"])
def test_default_fs_forms(nn, default_fs, want):
    cfg = dict(CONFIG, **{"fs.defaultFS": default_fs})
    assert nn.HdfsNamenodeResolver(cfg).resolve_default_hdfs_service() == want


def test_empty_config_resolves_nothing(nn):
    r = nn.HdfsNamenodeResolver({})
    assert r.resolve_hdfs_name_service("anything") is None
    with pytest.raises(nn.HdfsConnectError):
        r.resolve_default_hdfs_service()


def test_hadoop_xml_parser_ignores_nameless_properties(nn, tmp_path):
    xml = tmp_path / "core-site.xml"
    xml.write_text("""<configuration>
        <property><name>k1</name><value>v1</value></property>
        <property><value>orphan</value></property>
        <property><name>empty</name><value></value></property>
    </configuration>""")
    props = nn._read_hadoop_xml(str(xml))
    assert props == {"k1": "v1", "empty": ""}


def _site(path, props):
    path.write_text("<configuration>" + "".join(
        f"<property><name>{k}</name><value>{v}</value></property>" for k, v in props.items())
        + "</configuration>")


def test_hadoop_xml_discovery(nn, tmp_path, monkeypatch):
    conf = tmp_path / "conf"
    conf.mkdir()
    _site(conf / "core-site.xml", {"fs.defaultFS": "hdfs://ns1"})
    _site(conf / "hdfs-site.xml", {"dfs.nameservices": "ns1", "dfs.ha.namenodes.ns1": "a,b",
                                   "dfs.namenode.rpc-address.ns1.a": "ha:1",
                                   "dfs.namenode.rpc-address.ns1.b": "hb:2"})
    monkeypatch.setenv("HADOOP_CONF_DIR", str(conf))
    r = nn.HdfsNamenodeResolver()
    assert r.resolve_default_hdfs_service() == ("ns1", ["ha:1", "hb:2"])
    assert isinstance(r._config, nn.HadoopConfiguration)


def test_discovery_prefers_hadoop_conf_dir(nn, tmp_path, monkeypatch):
    conf_dir = tmp_path / "conf"
    conf_dir.mkdir()
    _site(conf_dir / "core-site.xml", {"fs.defaultFS": "hdfs://fromconfdir:8020"})
    home = tmp_path / "home" / "etc" / "hadoop"
    home.mkdir(parents=True)
    _site(home / "core-site.xml", {"fs.defaultFS": "hdfs://fromhome:8020"})
    monkeypatch.setenv("HADOOP_CONF_DIR", str(conf_dir))
    monkeypatch.setenv("HADOOP_HOME", str(tmp_path / "home"))
    assert nn.HdfsNamenodeResolver().resolve_default_hdfs_service()[0] == "fromconfdir:8020"
    monkeypatch.delenv("HADOOP_CONF_DIR")
    assert nn.HdfsNamenodeResolver().resolve_default_hdfs_service()[0] == "fromhome:8020"


def test_discovery_merges_core_and_hdfs_site(nn, tmp_path, monkeypatch):
    conf_dir = tmp_path / "conf"
    conf_dir.mkdir()
    _site(conf_dir / "core-site.xml", {"fs.defaultFS": "hdfs://ns1"})
    _site(conf_dir / "hdfs-site.xml", {"dfs.nameservices": "ns1", "dfs.ha.namenodes.ns1": "n1",
                                       "dfs.namenode.rpc-address.ns1.n1": "merged:8020"})
    monkeypatch.setenv("HADOOP_CONF_DIR", str(conf_dir))
    assert nn.HdfsNamenodeResolver().resolve_default_hdfs_service()[1] == ["merged:8020"]


# ------------------------------------------------------------------ failover
def test_failover_to_second_namenode(nn):
    nn.Connector.fs_by_host = {"host1:8020": _MockFs("host1", failures=10),
                               "host2:8020": _MockFs("host2")}
    client = nn.HAHdfsClient(nn.Connector, ["host1:8020", "host2:8020"])
    assert client.ls("/x") == ["/x/ok-from-host2"]


def test_failover_exhaustion_raises(nn):
    nn.Connector.fs_by_host = {"host1:8020": _MockFs("host1", failures=100),
                               "host2:8020": _MockFs("host2", failures=100)}
    client = nn.HAHdfsClient(nn.Connector, ["host1:8020", "host2:8020"])
    with pytest.raises(nn.HdfsConnectError, match="failed after"):
        client.ls("/x")
    assert sum(fs.calls for fs in nn.Connector.fs_by_host.values()) == \
        nn.MAX_NAMENODE_FAILOVER_ATTEMPTS + 1


def test_connect_to_either_namenode_skips_dead(nn):
    nn.Connector.fs_by_host = {"host2:8020": _MockFs("host2")}
    client = nn.Connector.connect_to_either_namenode(["host1:8020", "host2:8020"])
    assert client.ls("/y") == ["/y/ok-from-host2"]


def test_connect_all_dead_raises_and_lists_them(nn):
    nn.Connector.fs_by_host = {}
    with pytest.raises(nn.HdfsConnectError, match="any namenode.*host1:8020"):
        nn.Connector.connect_to_either_namenode(["host1:8020", "host2:8020"])


def test_every_proxied_method_fails_over(nn):
    nn.Connector.fs_by_host = {"host1:8020": _MockFs("host1", failures=1),
                               "host2:8020": _MockFs("host2")}
    client = nn.HAHdfsClient(nn.Connector, ["host1:8020", "host2:8020"])
    assert client.open("/f") == "handle-from-host2"
    assert client.info("/f")["via"] == "host2"
    assert client.ls("/d") == ["/d/ok-from-host2"]


def test_failover_recovers_transient_blip(nn):
    nn.Connector.fs_by_host = {"host1:8020": _MockFs("host1", failures=1),
                               "host2:8020": _MockFs("host2")}
    client = nn.HAHdfsClient(nn.Connector, ["host1:8020", "host2:8020"])
    assert client.ls("/x") == ["/x/ok-from-host2"]
    assert client.ls("/y") == ["/y/ok-from-host2"]


@pytest.mark.parametrize("error,method", [(FileNotFoundError, "ls"),
                                          (PermissionError, "exists")])
def test_definite_answers_do_not_fail_over(nn, error, method):
    nn.Connector.fs_by_host = {"h1:8020": _Fs("h1", error=error, fail_times=1),
                               "h2:8020": _Fs("h2")}
    client = nn.HAHdfsClient(nn.Connector, ["h1:8020", "h2:8020"])
    with pytest.raises(error):
        getattr(client, method)("/missing")
    assert nn.Connector.fs_by_host["h2:8020"].calls[method] == 0


def test_failover_counts_attempts_not_methods(nn):
    h1, h2 = _Fs("h1", fail_times=1), _Fs("h2", fail_times=1)
    nn.Connector.fs_by_host = {"h1:8020": h1, "h2:8020": h2}
    client = nn.HAHdfsClient(nn.Connector, ["h1:8020", "h2:8020"])
    assert client.ls("/a") == ["/a@h1"]
    assert client.ls("/b")
    assert h1.calls["ls"] + h2.calls["ls"] <= 2 * (nn.MAX_NAMENODE_FAILOVER_ATTEMPTS + 1)


def test_all_proxied_methods_share_failover(nn):
    h2 = _Fs("h2")
    nn.Connector.fs_by_host = {"h1:8020": _Fs("h1", fail_times=1), "h2:8020": h2}
    client = nn.HAHdfsClient(nn.Connector, ["h1:8020", "h2:8020"])
    assert client.info("/p")["server"] == "h2"
    assert client.exists("/p") and h2.calls["exists"] == 1


def test_non_proxied_attribute_reaches_raw_fs(nn):
    nn.Connector.fs_by_host = {"h1:8020": _Fs("h1")}
    assert nn.HAHdfsClient(nn.Connector, ["h1:8020"]).name == "h1"


def test_fault_plan_fails_a_proxied_call_over(nn):
    """An injected ``ioerror`` at the ``hdfs.call`` site fails the call
    over to the other namenode, as a dead namenode would."""
    faults = importlib.import_module(nn.__name__.split(".")[0] + ".resilience.faults")
    plan = faults.FaultPlan([faults.FaultSpec(site="hdfs.call", kind="ioerror", at=1,
                                              key_substring="ls")], seed=0)
    h1, h2 = _Fs("h1"), _Fs("h2")
    nn.Connector.fs_by_host = {"h1:8020": h1, "h2:8020": h2}
    client = nn.HAHdfsClient(nn.Connector, ["h1:8020", "h2:8020"], fault_plan=plan)
    assert client.ls("/x") == ["/x@h2"] and h1.calls["ls"] == 0


# --------------------------------------------------- URLs and a whole read
def test_hdfs_url_resolves_through_the_nameservice(nn, monkeypatch):
    fs_utils = importlib.import_module(nn.__name__.split(".")[0] + ".fs_utils")
    seen = {}

    def fake_connect(cls, namenodes, user=None, storage_options=None):
        seen["namenodes"] = list(namenodes)
        return _MockFs("resolved")

    monkeypatch.setattr(nn.HdfsConnector, "connect_to_either_namenode",
                        classmethod(fake_connect))
    fs, path = fs_utils.get_filesystem_and_path_or_paths(
        "hdfs://nameservice1/data/ds", hadoop_configuration=HADOOP_CONFIG)
    assert seen["namenodes"] == ["host1:8020", "host2:8020"]
    assert path == "/data/ds" and fs.ls("/data/ds") == ["/data/ds/ok-from-resolved"]
    resolver = fs_utils.FilesystemResolver("hdfs:///data/ds", hadoop_configuration=HADOOP_CONFIG,
                                           user="etl")
    assert seen["namenodes"] == ["host1:8020", "host2:8020"]
    assert resolver.get_dataset_path() == "/data/ds"


def test_resolver_connects_to_the_standby_and_fails_calls_over(nn, monkeypatch):
    """``FilesystemResolver`` of an ``hdfs://nameservice`` URL with a given
    configuration: both namenodes resolve, the first refuses the connection,
    and a call that later fails on the second fails over back to the
    first."""
    fs_utils = importlib.import_module(nn.__name__.split(".")[0] + ".fs_utils")
    h1, h2 = _Fs("h1"), _Fs("h2", fail_times=1)
    refused = []

    def connect(cls, netloc, user=None, **kwargs):
        if netloc == "host1:8020" and not refused:
            refused.append(netloc)
            raise IOError("host1 is in standby")
        return {"host1:8020": h1, "host2:8020": h2}[netloc]
    monkeypatch.setattr(nn.HdfsConnector, "hdfs_connect_namenode", classmethod(connect))
    resolver = fs_utils.FilesystemResolver("hdfs://nameservice1/ds",
                                           hadoop_configuration=HADOOP_CONFIG)
    fs = resolver.filesystem()
    assert refused == ["host1:8020"] and resolver.get_dataset_path() == "/ds"
    assert fs.ls("/ds") == ["/ds@h1"]
    assert h2.calls["ls"] == 1 and h1.calls["ls"] == 1


class _LocalAsHdfs:
    """A namenode's view of the local disk (the calls the readers make; no
    ``_strip_protocol``, as a client over libhdfs has none)."""

    def __init__(self):
        import fsspec
        self._fs = fsspec.filesystem("file")

    def __getattr__(self, name):
        if name in ("open", "exists", "isdir", "isfile", "find", "info", "ls"):
            return getattr(self._fs, name)
        raise AttributeError(name)


def test_make_reader_reads_an_hdfs_url_after_a_failover(nn, tmp_path, monkeypatch):
    """The port's reader reads an ``hdfs://nameservice`` store (its
    configuration found through ``HADOOP_CONF_DIR``) with the first
    namenode down, and gives the JAX reader's rows."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema("H", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
                             UnischemaField("vec", np.float32, (3,), NdarrayCodec(), False)])
    with materialize_dataset_local(f"file://{tmp_path}/ds", schema, rows_per_row_group=5) as w:
        for i in range(15):
            w.write_row({"id": i, "vec": np.full(3, i, np.float32)})
    conf = tmp_path / "conf"
    conf.mkdir()
    _site(conf / "hdfs-site.xml", {k: v for k, v in HADOOP_CONFIG.items()
                                   if k.startswith("dfs.")})
    monkeypatch.setenv("HADOOP_CONF_DIR", str(conf))
    served = _LocalAsHdfs()

    def connect(cls, netloc, user=None, **kwargs):
        if netloc == "host1:8020":
            raise IOError("host1 is in standby")
        return served
    monkeypatch.setattr(nn.HdfsConnector, "hdfs_connect_namenode", classmethod(connect))
    reader = importlib.import_module(nn.__name__.split(".")[0] + ".reader")
    url = f"hdfs://nameservice1{tmp_path}/ds"
    with reader.make_reader(url, reader_pool_type="thread", workers_count=2,
                            shuffle_row_groups=False) as r:
        rows = sorted((int(row.id), row.vec.tolist()) for row in r)
    assert rows == [(i, [float(i)] * 3) for i in range(15)]
