"""A fabric in one process for the PyTorch/CUDA examples.

The reference scheduler and daemons (``dragonfly2_tpu``, plain Python)
with the port's device sink: a daemon is built with
``tpu_sink.enabled=False`` and the port's ``DeviceSinkManager`` set as its
task manager's ``device_sinks``. Needs ``aiohttp``.

The reference daemon reads the host's topology from
``dragonfly2_tpu.parallel.topology`` when it is built
(``dragonfly2_tpu/daemon/daemon.py:38``). That module imports no JAX,
but the package's ``__init__`` imports its JAX collectives. ``start_daemon``
registers the package without running its ``__init__`` first, so the
daemon loads the topology module alone and the process imports no JAX.
"""

import importlib.util
import os
import sys
import tempfile
import types


def _topology_without_jax() -> None:
    name = "dragonfly2_tpu.parallel"
    if name in sys.modules:
        return
    spec = importlib.util.find_spec("dragonfly2_tpu")
    pkg = types.ModuleType(name)
    pkg.__path__ = [os.path.join(os.path.dirname(spec.origin), "parallel")]
    sys.modules[name] = pkg


async def start_scheduler():
    from dragonfly2_tpu.scheduler.config import SchedulerConfig
    from dragonfly2_tpu.scheduler.server import SchedulerServer

    cfg = SchedulerConfig()
    cfg.server.port = 0
    cfg.scheduling.retry_interval = 0.05
    sched = SchedulerServer(cfg)
    await sched.start()
    return sched


async def start_daemon(sched, name: str, *, device=None, seed: bool = False,
                       workdir: str | None = None):
    """A reference daemon on ``sched``. With ``device``, its device sink
    is the port's ``DeviceSinkManager`` on that device; without, it has
    none (a seed peer)."""
    _topology_without_jax()
    from dragonfly2_tpu.daemon.config import DaemonConfig
    from dragonfly2_tpu.daemon.daemon import Daemon
    from dragonfly2_tpu_torch.daemon.peer.device_sink import DeviceSinkManager

    cfg = DaemonConfig()
    cfg.work_home = os.path.join(
        workdir or tempfile.mkdtemp(prefix="df-example-"), name)
    cfg.__post_init__()
    cfg.host.hostname = name
    cfg.host.ip = "127.0.0.1"
    cfg.scheduler.addrs = [f"127.0.0.1:{sched.port()}"]
    cfg.seed_peer = seed
    cfg.tpu_sink.enabled = False            # the port's sink, if any
    daemon = Daemon(cfg)
    if device is not None:
        daemon.task_manager.device_sinks = DeviceSinkManager(device=device)
    await daemon.start()
    return daemon


async def stop_daemon(daemon) -> None:
    await daemon.stop()
    sinks = daemon.task_manager.device_sinks
    if sinks is not None:
        sinks.close()
