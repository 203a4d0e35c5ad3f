"""Run the port's manager: the flags of the JAX CLI's ``manager``
subcommand (``dragonfly2_tpu/cli/extra.py``).

    python -m dragonfly2_tpu_torch.manager --port 8080 --grpc-port 65003

It serves until SIGINT or SIGTERM. The default login is root/dragonfly.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from dragonfly2_tpu_torch.manager.config import (
    DatabaseConfig,
    GrpcConfig,
    ManagerConfig,
    RestConfig,
)
from dragonfly2_tpu_torch.manager.server import ManagerServer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dragonfly2_tpu_torch.manager",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080, help="REST port")
    p.add_argument("--grpc-port", type=int, default=65003, help="drpc port")
    p.add_argument("--db", default=":memory:",
                   help="sqlite path (default in memory)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="port of /metrics (0: ephemeral, negative: none)")
    p.add_argument("--keepalive-timeout", type=float, default=60.0,
                   help="seconds before a silent scheduler or seed peer "
                        "turns inactive")
    p.add_argument("--keepalive-gc-interval", type=float, default=30.0,
                   help="seconds between the expiry sweeps")
    args = p.parse_args(argv)
    cfg = ManagerConfig(
        server=RestConfig(host=args.host, port=args.port),
        grpc=GrpcConfig(host=args.host, port=args.grpc_port),
        database=DatabaseConfig(path=args.db),
        keepalive_timeout=args.keepalive_timeout,
        keepalive_gc_interval=args.keepalive_gc_interval,
        metrics_port=args.metrics_port)

    async def run() -> int:
        server = ManagerServer(cfg)
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(
                sig, lambda: asyncio.ensure_future(server.stop()))
        await server.serve()
        return 0

    return asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
