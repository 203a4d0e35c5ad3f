"""The port's ``DaemonConfig`` against the JAX one.

The same dict, YAML file or JSON file gives both packages the same tree,
field by field (``dataclasses.asdict``), with the same size-string
parsing, ``host_type_enum``, ``unix_sock`` and ``dfpath``. The port reads
a ``.json`` file with the standard library and YAML only through a lazy
``import yaml``, which, when it fails, raises ``ImportError`` naming
PyYAML. Tolerance 0: every field is compared for equality.
"""

from __future__ import annotations

import builtins
import dataclasses
import json
import os
import re

import pytest

from dragonfly2_tpu.daemon.config import DaemonConfig as JConfig
from dragonfly2_tpu.pkg import types as jtypes
from dragonfly2_tpu_torch.daemon.config import DaemonConfig
from dragonfly2_tpu_torch.pkg import types as ptypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every block and a size string of each kind the JAX parser accepts; the
# host is named, so neither side looks up the local address.
FULL = {
    "work_home": "/var/lib/dragonfly",
    "host": {"hostname": "tpu-vm-7", "ip": "10.1.2.3", "idc": "pod-a",
             "location": "us-central2|pod-a|s0|7", "tpu_slice": "s0",
             "tpu_worker_index": 7},
    "scheduler": {"addrs": ["10.0.0.1:8002", "10.0.0.2:8002"],
                  "schedule_timeout": 12.5, "max_schedule_attempts": 3},
    "download": {"rate_limit": "100MiB", "traffic_shaper": "sampling",
                 "piece_concurrency": 8, "parent_concurrency": 6,
                 "unix_sock": "/run/df.sock", "peer_port": 65000,
                 "calculate_digest": False, "prefetch": True,
                 "concurrent_min_length": "64M", "report_batch": 16},
    "upload": {"port": 65002, "rate_limit": "1.5GB"},
    "storage": {"task_ttl": 21600, "disk_gc_threshold": "2TiB",
                "keep_storage": False, "write_buffer_size": "8KiB",
                "fd_idle_close": 30.0},
    "proxy": {"enabled": False, "rules": [{"regex": "blobs"}],
              "white_list_ports": [443]},
    "object_storage": {"enabled": True, "port": 65004, "backend": "fs",
                       "backend_options": {"root": "/data/buckets"}},
    "pex": {"enabled": True, "port": 7946, "seeds": ["10.0.0.9:7946"],
            "secret": "s"},
    "tpu_sink": {"enabled": True, "mesh_shape": [2, 2], "batch_pieces": 16,
                 "max_tasks": 2},
    "qos": {"dispatch_capacity": 4, "upload_min_share_fraction": 0.2},
    "prof": {"enabled": False, "hz": 7.0, "max_nodes": 100,
             "lag_slow_s": 0.5},
    "host_type": "strong",
    "alive_time": 600.0,
    "gc_interval": 5.0,
    "metrics_port": -1,
    "seed_peer": True,
    "flight_keep_bundles": 4,
    "clock_offset_s": 1.25,
    "not_a_key": {"ignored": True},
}


def _same(port: DaemonConfig, jax: JConfig) -> None:
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert port.unix_sock == jax.unix_sock
    assert port.dfpath.root == jax.dfpath.root
    assert port.dfpath.daemon_sock == jax.dfpath.daemon_sock
    assert port.dfpath.log_dir == jax.dfpath.log_dir
    assert int(port.host_type_enum) == int(jax.host_type_enum)
    assert port.host_type_enum.name == jax.host_type_enum.name


def test_every_option_keeps_the_jax_keys_and_defaults():
    jax, port = JConfig(), DaemonConfig()
    _same(port, jax)

    def shape(cfg) -> dict:
        return {f.name: shape(getattr(cfg, f.name))
                if dataclasses.is_dataclass(getattr(cfg, f.name)) else None
                for f in dataclasses.fields(cfg)}
    assert shape(port) == shape(jax)


@pytest.mark.parametrize("case", ["full", "empty", "partial"])
def test_from_dict_matches_the_jax_config(case):
    d = {"full": FULL, "empty": {},
         "partial": {"work_home": "/w", "download": {"rate_limit": "4K"},
                     "tpu_sink": {"enabled": True}, "seed_peer": True}}[case]
    _same(DaemonConfig.from_dict(json.loads(json.dumps(d))),
          JConfig.from_dict(json.loads(json.dumps(d))))


@pytest.mark.parametrize("size", ["100MiB", "100M", "1.5GB", "2TiB", "8KiB",
                                  "4k", "512B", "12345", " 3 MiB "])
def test_size_strings_parse_as_in_jax(size):
    assert ptypes.parse_size(size) == jtypes.parse_size(size)
    d = {"download": {"rate_limit": size}, "storage": {
        "disk_gc_threshold": size}}
    port, jax = DaemonConfig.from_dict(d), JConfig.from_dict(d)
    assert port.download.rate_limit == jax.download.rate_limit \
        == jtypes.parse_size(size)
    assert port.storage.disk_gc_threshold == jax.storage.disk_gc_threshold


@pytest.mark.parametrize("host_type,seed", [
    ("normal", False), ("normal", True), ("super", False), ("strong", True),
    ("weak", False), ("WEAK", True)])
def test_host_type_enum_matches_jax(host_type, seed):
    d = {"host_type": host_type, "seed_peer": seed}
    port, jax = DaemonConfig.from_dict(d), JConfig.from_dict(d)
    assert int(port.host_type_enum) == int(jax.host_type_enum)
    assert port.host_type_enum.name_str == jax.host_type_enum.name_str
    assert port.host_type_enum.is_seed() == jax.host_type_enum.is_seed()


def test_unix_sock_follows_work_home_as_in_jax(tmp_path):
    port, jax = DaemonConfig(), JConfig()
    for cfg in (port, jax):
        cfg.work_home = str(tmp_path / "moved")
    assert port.unix_sock == jax.unix_sock == str(
        tmp_path / "moved" / "run" / "dfdaemon.sock")
    for cfg in (port, jax):
        cfg.download.unix_sock = "/x.sock"
    assert port.unix_sock == jax.unix_sock == "/x.sock"


def _k8s_daemon_yaml() -> str:
    """The ``daemon.yaml`` block of the DaemonSet's ConfigMap."""
    with open(os.path.join(REPO, "deploy", "k8s", "daemon.yaml")) as f:
        text = f.read()
    block = re.search(r"  daemon\.yaml: \|\n((?:    .*\n)+)", text).group(1)
    return "\n".join(line[4:] for line in block.splitlines()) + "\n"


def test_load_reads_the_k8s_daemon_yaml_as_jax_does(tmp_path):
    path = tmp_path / "daemon.yaml"
    path.write_text(_k8s_daemon_yaml())
    port, jax = DaemonConfig.load(str(path)), JConfig.load(str(path))
    _same(port, jax)
    assert port.tpu_sink.enabled and port.download.peer_port == 65000
    assert port.unix_sock == "/var/run/dragonfly/dfdaemon.sock"


def test_load_reads_a_json_file_as_jax_does(tmp_path):
    path = tmp_path / "daemon.json"
    path.write_text(json.dumps(FULL))
    # JSON is YAML: the JAX loader reads the same file.
    _same(DaemonConfig.load(str(path)), JConfig.load(str(path)))
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    _same(DaemonConfig.load(str(empty)), JConfig.load(str(empty)))


def test_load_without_yaml_names_pyyaml_and_still_reads_json(
        tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("No module named 'yaml'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    yml = tmp_path / "daemon.yaml"
    yml.write_text(_k8s_daemon_yaml())
    with pytest.raises(ImportError, match="PyYAML"):
        DaemonConfig.load(str(yml))
    js = tmp_path / "daemon.json"
    js.write_text(json.dumps({"gc_interval": 9.0}))
    assert DaemonConfig.load(str(js)).gc_interval == 9.0
