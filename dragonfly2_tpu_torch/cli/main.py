"""``df``, the multi-command CLI: the port's copy of
``dragonfly2_tpu/cli/main.py``, with every flag of the JAX CLI.

    python -m dragonfly2_tpu_torch.cli.main <cmd> ...

Subcommands: ``dfget`` and ``daemon`` here, ``scheduler``, ``manager``,
``dfcache`` and ``dfstore`` in ``cli/extra.py``. Every role it starts is
the port's own: ``dfget`` with no live daemon on its socket spawns
``python -m dragonfly2_tpu_torch.cli.main daemon`` (its output appended
to ``<work_home>/logs/daemon-spawn.log``) and waits for it.

Port-only and divergent flags:

- ``--torch-device {cuda,cpu}`` on ``daemon`` and ``dfget`` (default
  ``cuda``): the device the port's ``Daemon`` binds (its sink, the delta
  task's chunker); ``dfget`` hands it to the daemon it spawns. There is no
  environment variable for it, and no fallback: a daemon on ``cuda``
  without a card raises.
- ``dfget --device`` also accepts ``cuda``, an alias of ``tpu``: the wire
  value stays ``"tpu"``.
- ``dfget --cluster`` is refused with exit code 2: the manager's cluster
  view (``Manager.ClusterView``) is not ported (ROADMAP A7.4 item 6).
- ``dfget`` waits ``SPAWN_WAIT_S`` (30 s) for the daemon it spawns, where
  the JAX CLI waits 15 s: the port's daemon imports ``torch`` and binds
  the card on its first start, 11.4 s on an H100 machine against the 15 s
  limit (``PERF.md``).
- ``dfget`` flushes its OTLP exporter (``pkg/tracing``, with
  ``DF_TRACE_OTLP_ENDPOINT`` set) before it exits, so its
  ``dfget.download`` span reaches the collector; the JAX CLI exits with
  the span still queued on the exporter's daemon thread.

``daemon_config(args)`` is the one mapping of ``daemon`` flags onto a
``DaemonConfig``; ``dfget_config(args)`` the one of ``dfget`` flags onto
a ``DfgetConfig``.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import subprocess
import sys
import time

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.dfpath import Dfpath
from dragonfly2_tpu_torch.pkg.types import format_size

log = dflog.get("cli")

TORCH_DEVICES = ("cuda", "cpu")
# ``--device`` values; "cuda" is sent as the wire's "tpu".
DEVICE_ALIASES = {"": "", "tpu": "tpu", "cuda": "tpu"}
# The spawned daemon's first start imports torch and binds the card.
SPAWN_WAIT_S = 30.0
CLUSTER_REFUSAL = ("dfget: --cluster is not supported by the port: the "
                   "manager's cluster view (Manager.ClusterView) is not "
                   "ported (ROADMAP A7.4 item 6)\n")


def _add_torch_device(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--torch-device", default="cuda", choices=TORCH_DEVICES,
                   help=f"the device {what} (port only; no fallback: "
                        f"cuda without a card raises)")


def _add_dfget(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("dfget", help="download a file through the P2P fabric")
    p.add_argument("url", help="source URL (http/https/file)")
    p.add_argument("-O", "--output", default="",
                   help="output path (optional with --device tpu)")
    p.add_argument("--device", default="", choices=list(DEVICE_ALIASES),
                   help="also land verified pieces into the daemon's device "
                        "sink (requires tpu_sink.enabled in the daemon); "
                        "cuda is an alias of tpu")
    p.add_argument("--tag", default="", help="task isolation tag")
    p.add_argument("--application", default="")
    p.add_argument("--tenant", default="",
                   help="QoS attribution tag: every byte this download "
                        "moves is accounted (and rate-shared) under this "
                        "tenant; burning tenants get deprioritized")
    p.add_argument("--priority", type=int, default=3,
                   help="QoS priority 0-6 (>=5 interactive, 3-4 normal, "
                        "<=2 background) — sets the weighted-fair "
                        "dispatch class on every daemon on the path")
    p.add_argument("--digest", default="", help="expected digest algo:hex")
    p.add_argument("--filter", default="", help="'&'-separated query params to ignore")
    p.add_argument("--range", dest="range_", default="", help="byte range a-b")
    p.add_argument("--header", action="append", default=[], help="k:v (repeatable)")
    p.add_argument("--disable-back-source", action="store_true")
    p.add_argument("--pod-broadcast", action="store_true",
                   help="register as a striped slice broadcast: each "
                        "same-slice host pulls 1/S of the pieces from "
                        "outside and the slice completes the copy internally")
    p.add_argument("--delta-base", default="",
                   help="task id of a locally-landed base version: chunks "
                        "the base already holds are copied (and verified) "
                        "locally, only changed chunks cross the wire as "
                        "ranged P2P tasks (checkpoint-delta plane)")
    p.add_argument("--explain", action="store_true",
                   help="after the download, print the flight recorder's "
                        "critical-path autopsy (phase breakdown + per-piece "
                        "waterfall) — where the wall time went")
    p.add_argument("--pod", action="store_true",
                   help="also fetch the scheduler's merged cross-host pod "
                        "timeline for this task")
    p.add_argument("--cluster", action="store_true",
                   help="not supported by the port: the manager's cluster "
                        "view is not ported (exits 2)")
    p.add_argument("--recursive", action="store_true")
    p.add_argument("--level", type=int, default=5, help="recursion depth")
    p.add_argument("--timeout", type=float, default=0.0)
    p.add_argument("--work-home", default="")
    p.add_argument("--no-daemon", action="store_true", help="never spawn a daemon")
    p.add_argument("--scheduler", action="append", default=[],
                   help="scheduler host:port handed to an auto-spawned "
                        "daemon (repeatable) — a cold host joins the P2P "
                        "fabric on first dfget")
    p.add_argument("--manager", default="",
                   help="manager drpc host:port for the auto-spawned daemon")
    _add_torch_device(p, "an auto-spawned daemon binds")
    p.set_defaults(func=_run_dfget)


def dfget_config(args: argparse.Namespace):
    """The ``DfgetConfig`` of parsed ``dfget`` flags."""
    from dragonfly2_tpu_torch.client import dfget as dfget_lib
    from dragonfly2_tpu_torch.proto.common import UrlMeta

    path = Dfpath(args.work_home) if args.work_home else Dfpath()
    header = {}
    for h in args.header:
        k, _, v = h.partition(":")
        header[k.strip()] = v.strip()
    meta = UrlMeta(digest=args.digest, tag=args.tag, filter=args.filter,
                   application=args.application, header=header,
                   range=args.range_, priority=args.priority,
                   tenant=args.tenant)
    return dfget_lib.DfgetConfig(
        url=args.url,
        output=args.output,
        daemon_sock=path.daemon_sock,
        meta=meta,
        disable_back_source=args.disable_back_source,
        recursive=args.recursive,
        level=args.level,
        timeout=args.timeout,
        device=DEVICE_ALIASES[args.device],
        pod_broadcast=args.pod_broadcast,
        explain=args.explain,
        pod=args.pod,
        delta_base=args.delta_base,
    )


def _run_dfget(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.client import dfget as dfget_lib

    if args.cluster:
        sys.stderr.write(CLUSTER_REFUSAL)
        return 2
    path = Dfpath(args.work_home) if args.work_home else Dfpath()
    cfg = dfget_config(args)
    if not args.output and cfg.device != "tpu":
        sys.stderr.write("dfget: error: -O/--output is required "
                         "(optional only with --device tpu)\n")
        return 2

    async def run() -> int:
        if not args.no_daemon and not await dfget_lib.is_daemon_alive(path.daemon_sock):
            t0 = time.monotonic()
            _spawn_daemon(path, device_sink=(cfg.device == "tpu"),
                          schedulers=args.scheduler, manager=args.manager,
                          torch_device=args.torch_device)
            await _wait_daemon(path.daemon_sock)
            log.info("spawned daemon alive", wait_s=round(time.monotonic() - t0, 3))
        start = time.monotonic()
        state = {"last": 0}

        def on_progress(msg: dict) -> None:
            if msg.get("state") != "running":
                return
            done = msg.get("completed_length", 0)
            total = msg.get("content_length", -1)
            if done - state["last"] >= (8 << 20) or done == total:
                state["last"] = done
                pct = f"{100 * done / total:5.1f}%" if total > 0 else "  ?  "
                sys.stderr.write(f"\r{pct} {format_size(done)}")
                sys.stderr.flush()

        try:
            result = await dfget_lib.download(cfg, on_progress)
        finally:
            # One-shot process: close the source fallback's pooled
            # connections instead of leaking them to interpreter exit.
            from dragonfly2_tpu_torch.pkg import tracing
            from dragonfly2_tpu_torch.source import default_registry

            await default_registry().close_all()
            otlp = tracing.exporter().otlp
            if otlp is not None:
                await asyncio.to_thread(otlp.flush)
        elapsed = time.monotonic() - start
        size = result.get("completed_length", 0)
        rate = size / elapsed if elapsed > 0 else 0
        sys.stderr.write(
            f"\rdownloaded {format_size(size)} in {elapsed:.2f}s "
            f"({format_size(int(rate))}/s) task={result.get('task_id', '')[:16]} "
            f"reuse={result.get('from_reuse', False)} p2p={result.get('from_p2p', False)}"
            + (f" device_verified={result.get('device_verified', False)}"
               if cfg.device else "") + "\n"
        )
        flight_info = result.get("flight") or {}
        if args.explain and flight_info.get("text"):
            from dragonfly2_tpu_torch import qos

            sys.stderr.write(
                f"qos: tenant={qos.normalize_tenant(args.tenant)} "
                f"class={qos.class_of(args.priority)} "
                f"(priority={args.priority})\n")
            sys.stderr.write(flight_info["text"] + "\n")
        pod_info = result.get("pod") or {}
        if args.pod and pod_info.get("text"):
            sys.stderr.write(pod_info["text"] + "\n")
        return 0

    try:
        return asyncio.run(run())
    except Exception as e:
        sys.stderr.write(f"\ndfget: error: {e}\n")
        return 1


def _spawn_daemon(path: Dfpath, *, device_sink: bool = False,
                  schedulers: list | None = None, manager: str = "",
                  torch_device: str = "cuda") -> None:
    """Start the port's daemon in a session of its own, as dfget does:
    the scheduler and manager addresses pass through, so a cold host's
    first dfget joins the P2P fabric."""
    path.ensure()
    cmd = [sys.executable, "-m", "dragonfly2_tpu_torch.cli.main", "daemon",
           "--work-home", path.root, "--torch-device", torch_device]
    for addr in schedulers or []:
        cmd += ["--scheduler", addr]
    if manager:
        cmd += ["--manager", manager]
    if device_sink:
        cmd.append("--device-sink")
    with open(os.path.join(path.log_dir, "daemon-spawn.log"), "ab") as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=logf,
                                start_new_session=True, close_fds=True)
    log.info("spawned daemon", work_home=path.root, pid=proc.pid)


async def _wait_daemon(sock: str, timeout: float = SPAWN_WAIT_S) -> None:
    from dragonfly2_tpu_torch.client.dfget import is_daemon_alive

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if await is_daemon_alive(sock):
            return
        await asyncio.sleep(0.1)
    raise RuntimeError(f"daemon did not come up on {sock} within {timeout}s")


def _add_daemon(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("daemon", help="run the peer daemon (dfdaemon)")
    p.add_argument("--config", default="", help="YAML config path")
    p.add_argument("--work-home", default="")
    p.add_argument("--seed-peer", action="store_true")
    p.add_argument("--scheduler", action="append", default=[],
                   help="scheduler host:port (repeatable)")
    p.add_argument("--manager", default="",
                   help="manager drpc host:port (dynconfig scheduler resolution)")
    p.add_argument("--proxy-port", type=int, default=-1,
                   help="enable the HTTP proxy on this port (0 = ephemeral)")
    p.add_argument("--registry-mirror", default="",
                   help="remote registry URL to mirror through the proxy")
    p.add_argument("--alive-time", type=float, default=0.0)
    p.add_argument("--object-storage-port", type=int, default=-1,
                   help="enable the S3-like object gateway on this port (0 = ephemeral)")
    p.add_argument("--object-storage-backend", default="fs",
                   help="fs | s3 | gcs | oss | obs (the port serves fs)")
    p.add_argument("--object-storage-option", action="append", default=[],
                   help="backend kwarg k=v (repeatable), e.g. root=/data/buckets")
    p.add_argument("--pex-port", type=int, default=-1,
                   help="enable gossip peer exchange on this UDP port (0 = ephemeral)")
    p.add_argument("--pex-seed", action="append", default=[],
                   help="PEX bootstrap host:port (repeatable)")
    p.add_argument("--pex-secret", default="",
                   help="shared HMAC secret for gossip datagrams")
    p.add_argument("--prefetch", action="store_true",
                   help="ranged-request misses also prefetch the whole task")
    p.add_argument("--hijack-https", action="store_true",
                   help="TLS-intercept CONNECT tunnels with a CA-forged cert")
    p.add_argument("--device-sink", action="store_true",
                   help="enable the device sink (tasks with --device tpu "
                        "land verified pieces in device memory)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="fixed port for /metrics "
                        "(0 = ephemeral, -1 = disabled)")
    p.add_argument("--piece-concurrency", type=int, default=0,
                   help="concurrent origin range streams for back-to-source "
                        "(0 = config default; caps origin request fan-in)")
    p.add_argument("--tpu-slice", default="",
                   help="ICI domain label for this host (e.g. slice-3); "
                        "the scheduler prefers parents inside the same "
                        "slice lexicographically")
    p.add_argument("--tpu-worker-index", type=int, default=-1,
                   help="worker index within the slice")
    p.add_argument("--hostname", default="",
                   help="override this daemon's advertised hostname "
                        "(multi-daemon-per-machine tests; the host id is "
                        "hostname-port)")
    p.add_argument("--clock-offset", type=float, default=0.0,
                   help="chaos/test knob: skew every wall stamp this "
                        "daemon reports by this many seconds — the "
                        "scheduler's clock alignment must recover it")
    _add_torch_device(p, "the daemon binds")
    p.set_defaults(func=_run_daemon)


def daemon_config(args: argparse.Namespace):
    """The ``DaemonConfig`` of parsed ``daemon`` flags (``--torch-device``
    is not part of it: it is ``Daemon``'s ``device``)."""
    from dragonfly2_tpu_torch.daemon.config import DaemonConfig

    if args.config:
        cfg = DaemonConfig.load(args.config)
    else:
        cfg = DaemonConfig()
    if args.work_home:
        cfg.work_home = args.work_home
        cfg.__post_init__()
    if args.seed_peer:
        cfg.seed_peer = True
    if args.scheduler:
        cfg.scheduler.addrs = args.scheduler
    if args.manager:
        cfg.manager_addr = args.manager
    if args.proxy_port >= 0:
        cfg.proxy.enabled = True
        cfg.proxy.port = args.proxy_port
    if args.registry_mirror:
        cfg.proxy.enabled = True
        cfg.proxy.registry_mirror = args.registry_mirror
    if args.alive_time:
        cfg.alive_time = args.alive_time
    if args.tpu_slice:
        cfg.host.tpu_slice = args.tpu_slice
    if args.tpu_worker_index >= 0:
        cfg.host.tpu_worker_index = args.tpu_worker_index
    if args.hostname:
        cfg.host.hostname = args.hostname
    if args.clock_offset:
        cfg.clock_offset_s = args.clock_offset
    if args.object_storage_port >= 0:
        cfg.object_storage.enabled = True
        cfg.object_storage.port = args.object_storage_port
        cfg.object_storage.backend = args.object_storage_backend
        opts = dict(kv.split("=", 1) for kv in args.object_storage_option if "=" in kv)
        if args.object_storage_backend == "fs" and "root" not in opts:
            opts["root"] = os.path.join(cfg.work_home or ".", "buckets")
        cfg.object_storage.backend_options = opts
    if args.pex_port >= 0 or args.pex_seed:
        cfg.pex.enabled = True
        if args.pex_port >= 0:
            cfg.pex.port = args.pex_port
        cfg.pex.seeds = args.pex_seed
    if args.pex_secret:
        cfg.pex.secret = args.pex_secret
    if args.prefetch:
        cfg.download.prefetch = True
    if args.device_sink:
        cfg.tpu_sink.enabled = True
    if args.metrics_port:
        cfg.metrics_port = args.metrics_port
    if args.piece_concurrency > 0:
        cfg.download.piece_concurrency = args.piece_concurrency
    if args.hijack_https:
        cfg.proxy.enabled = True
        cfg.proxy.hijack_https = True
    return cfg


def _run_daemon(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.cli.extra import serve_until_signalled
    from dragonfly2_tpu_torch.daemon.daemon import Daemon

    cfg = daemon_config(args)

    async def run() -> int:
        return await serve_until_signalled(Daemon(cfg, device=args.torch_device))

    return asyncio.run(run())


def build_parser() -> argparse.ArgumentParser:
    from dragonfly2_tpu_torch.cli import extra

    parser = argparse.ArgumentParser(prog="df", description="TPU-native P2P content fabric")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_dfget(sub)
    _add_daemon(sub)
    extra.register(sub)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
