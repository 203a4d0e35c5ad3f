"""The ``scheduler``, ``manager``, ``dfcache`` and ``dfstore`` subcommands:
the port's copy of ``dragonfly2_tpu/cli/extra.py``, with every flag.

``scheduler_config``, ``manager_config`` and ``dfcache_config`` map
parsed flags onto the port's configs; ``add_manager_args`` is the one
definition of the manager's flags, which ``python -m
dragonfly2_tpu_torch.manager`` parses too. ``dfstore`` rides the port's
``client/dfstore.Dfstore``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal

from dragonfly2_tpu_torch.pkg import dflog

log = dflog.get("cli")


def register(sub: argparse._SubParsersAction) -> None:
    _add_scheduler(sub)
    _add_manager(sub)
    _add_dfcache(sub)
    _add_dfstore(sub)


async def serve_until_signalled(server) -> int:
    """``server.serve()`` until SIGINT or SIGTERM calls its ``stop()``."""
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, lambda: asyncio.ensure_future(server.stop()))
    await server.serve()
    log.info("stopped", role=type(server).__name__)
    return 0


def _default_sock(work_home: str) -> str:
    from dragonfly2_tpu_torch.pkg.dfpath import Dfpath

    return (Dfpath(work_home) if work_home else Dfpath()).daemon_sock


def _add_dfcache(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("dfcache",
                       help="import/export/stat P2P cache entries (reference client/dfcache)")
    p.add_argument("op", choices=["import", "export", "stat", "delete"])
    p.add_argument("cache_id", help="cache entry id (task identity across hosts)")
    p.add_argument("--path", default="", help="local file (import)")
    p.add_argument("--output", default="", help="destination path (export)")
    p.add_argument("--tag", default="")
    p.add_argument("--application", default="")
    p.add_argument("--work-home", default="")
    p.add_argument("--timeout", type=float, default=60.0)
    p.add_argument("--persistent", action="store_true",
                   help="scheduler-managed persistent cache task (import)")
    p.add_argument("--replica-count", type=int, default=1)
    p.add_argument("--ttl", type=float, default=0.0,
                   help="persistent task TTL seconds (0 = forever)")
    p.set_defaults(func=_run_dfcache)


def dfcache_config(args: argparse.Namespace):
    from dragonfly2_tpu_torch.client import dfcache

    return dfcache.DfcacheConfig(
        daemon_sock=_default_sock(args.work_home), cache_id=args.cache_id,
        tag=args.tag, application=args.application, timeout=args.timeout)


def _run_dfcache(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.client import dfcache

    cfg = dfcache_config(args)

    async def run() -> int:
        if args.op == "import":
            if not args.path:
                print("--path required for import")
                return 2
            result = await dfcache.import_file(
                cfg, args.path, persistent=args.persistent,
                replica_count=args.replica_count, ttl=args.ttl)
        elif args.op == "export":
            if not args.output:
                print("--output required for export")
                return 2
            result = await dfcache.export_file(cfg, args.output)
        elif args.op == "stat":
            result = await dfcache.stat(cfg)
        else:
            result = await dfcache.delete(cfg)
        print(json.dumps(result))
        return 0

    return asyncio.run(run())


def _add_dfstore(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("dfstore",
                       help="object-storage ops via the daemon gateway (reference client/dfstore)")
    p.add_argument("op", choices=["cp", "rm", "stat", "ls", "mb", "rb",
                                  "prefetch"])
    p.add_argument("args", nargs="*",
                   help="cp SRC DST (df://bucket/key or local path); "
                        "rm/stat/prefetch df://bucket/key; ls/mb/rb df://bucket")
    p.add_argument("--endpoint", default="http://127.0.0.1:65004",
                   help="daemon object gateway endpoint")
    p.add_argument("--mode", default="async_write_back")
    p.add_argument("--device", default="", choices=["", "tpu"],
                   help="prefetch: additionally land the object in the "
                        "daemon's device sink")
    p.add_argument("--range", dest="range_", default="",
                   help="prefetch: warm only this byte span a-b "
                        "(a ranged task; sharded warm-up)")
    p.add_argument("--timeout", type=float, default=None,
                   help="client timeout seconds (default 60; prefetch "
                        "defaults to 3600 — it blocks until the daemon "
                        "finishes the warm-up; 0 = no timeout)")
    p.set_defaults(func=_run_dfstore)


def _parse_df_url(value: str) -> tuple[str, str]:
    if not value.startswith("df://"):
        raise ValueError(f"not a df:// url: {value}")
    rest = value[5:]
    bucket, _, key = rest.partition("/")
    return bucket, key


def _run_dfstore(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.client.dfstore import Dfstore

    required_args = {"cp": 2, "rm": 1, "stat": 1, "ls": 0, "mb": 1, "rb": 1,
                     "prefetch": 1}

    async def run() -> int:
        if len(args.args) < required_args[args.op]:
            print(f"dfstore {args.op}: expected {required_args[args.op]} "
                  f"argument(s), got {len(args.args)}")
            return 2
        if args.timeout is None:
            timeout = 3600.0 if args.op == "prefetch" else 60.0
        else:
            timeout = args.timeout  # 0 = unbounded (Dfstore maps it to None)
        store = Dfstore(args.endpoint, timeout=timeout)
        try:
            a = args.args
            if args.op == "cp":
                src, dst = a[0], a[1]
                if src.startswith("df://"):
                    bucket, key = _parse_df_url(src)
                    data = await store.get_object(bucket, key)
                    with open(dst, "wb") as f:
                        f.write(data)
                    print(f"downloaded {len(data)} bytes -> {dst}")
                else:
                    bucket, key = _parse_df_url(dst)
                    with open(src, "rb") as f:
                        data = f.read()
                    digest = await store.put_object(bucket, key, data, mode=args.mode)
                    print(f"uploaded {len(data)} bytes digest={digest}")
            elif args.op == "rm":
                bucket, key = _parse_df_url(a[0])
                await store.delete_object(bucket, key)
                print("deleted")
            elif args.op == "prefetch":
                bucket, key = _parse_df_url(a[0])
                result = await store.prefetch_object(
                    bucket, key, device=args.device,
                    range_header=args.range_)
                print(json.dumps(result))
            elif args.op == "stat":
                bucket, key = _parse_df_url(a[0])
                info = await store.stat_object(bucket, key)
                print(json.dumps(info.__dict__))
            elif args.op == "ls":
                bucket, _ = _parse_df_url(a[0]) if a else ("", "")
                if bucket:
                    for o in await store.list_objects(bucket):
                        print(f"{o.content_length:>12} {o.key}")
                else:
                    for name in await store.list_buckets():
                        print(name)
            elif args.op == "mb":
                bucket, _ = _parse_df_url(a[0])
                await store.create_bucket(bucket)
                print(f"created bucket {bucket}")
            elif args.op == "rb":
                bucket, _ = _parse_df_url(a[0])
                await store.delete_bucket(bucket)
                print(f"deleted bucket {bucket}")
            return 0
        finally:
            await store.close()

    return asyncio.run(run())


def add_manager_args(p: argparse.ArgumentParser) -> None:
    """The manager's flags, for ``df manager`` and ``python -m
    dragonfly2_tpu_torch.manager``."""
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080, help="REST port")
    p.add_argument("--grpc-port", type=int, default=65003, help="drpc port")
    p.add_argument("--db", default=":memory:", help="sqlite path (default in-memory)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="fixed port for /metrics "
                        "(0 = ephemeral, negative disables)")
    p.add_argument("--keepalive-timeout", type=float, default=60.0,
                   help="seconds before a silent scheduler/seed-peer "
                        "keepalive flips the row inactive")
    p.add_argument("--keepalive-gc-interval", type=float, default=30.0,
                   help="seconds between expire_stale sweeps")


def _add_manager(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("manager", help="run the manager global control plane")
    add_manager_args(p)
    p.set_defaults(func=run_manager)


def manager_config(args: argparse.Namespace):
    from dragonfly2_tpu_torch.manager.config import (
        DatabaseConfig,
        GrpcConfig,
        ManagerConfig,
        RestConfig,
    )

    return ManagerConfig(
        server=RestConfig(host=args.host, port=args.port),
        grpc=GrpcConfig(host=args.host, port=args.grpc_port),
        database=DatabaseConfig(path=args.db),
        keepalive_timeout=args.keepalive_timeout,
        keepalive_gc_interval=args.keepalive_gc_interval,
        metrics_port=args.metrics_port,
    )


def run_manager(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.manager.server import ManagerServer

    cfg = manager_config(args)

    async def run() -> int:
        return await serve_until_signalled(ManagerServer(cfg))

    return asyncio.run(run())


def _add_scheduler(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("scheduler", help="run the scheduler control plane")
    p.add_argument("--config", default="", help="YAML config path")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8002)
    p.add_argument("--manager", default="", help="manager drpc addr host:port")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="fixed port for /metrics and /debug/fleet* "
                        "(0 = ephemeral)")
    p.set_defaults(func=_run_scheduler)


def scheduler_config(args: argparse.Namespace):
    from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig

    if args.config:
        cfg = SchedulerConfig.load(args.config)
    else:
        cfg = SchedulerConfig()
    cfg.server.host = args.host
    cfg.server.port = args.port
    if args.manager:
        cfg.manager_addr = args.manager
    if args.metrics_port:
        cfg.metrics_port = args.metrics_port
    return cfg


def _run_scheduler(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.scheduler.server import SchedulerServer

    cfg = scheduler_config(args)

    async def run() -> int:
        return await serve_until_signalled(SchedulerServer(cfg))

    return asyncio.run(run())
