"""Well-known directories: the port's copy of ``dragonfly2_tpu/pkg/dfpath.py``.

One root holds the daemon's state, laid out as the JAX daemon lays it
out, so either daemon can run over the other's work home:

  <root>/data      piece stores
  <root>/cache     dynconfig cache files
  <root>/logs      rotating logs, flight-recorder bundles
  <root>/run       unix sockets, pid files
  <root>/plugins   plugins
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def default_root() -> str:
    return os.environ.get("DF_HOME", os.path.expanduser("~/.dragonfly2-tpu"))


@dataclass
class Dfpath:
    root: str = field(default_factory=default_root)

    @property
    def data_dir(self) -> str:
        return os.path.join(self.root, "data")

    @property
    def cache_dir(self) -> str:
        return os.path.join(self.root, "cache")

    @property
    def log_dir(self) -> str:
        return os.path.join(self.root, "logs")

    @property
    def run_dir(self) -> str:
        return os.path.join(self.root, "run")

    @property
    def plugins_dir(self) -> str:
        return os.path.join(self.root, "plugins")

    @property
    def daemon_sock(self) -> str:
        return os.path.join(self.run_dir, "dfdaemon.sock")

    @property
    def daemon_lock(self) -> str:
        return os.path.join(self.run_dir, "dfdaemon.lock")

    def ensure(self) -> "Dfpath":
        for d in (self.data_dir, self.cache_dir, self.log_dir, self.run_dir,
                  self.plugins_dir):
            os.makedirs(d, exist_ok=True)
        return self
