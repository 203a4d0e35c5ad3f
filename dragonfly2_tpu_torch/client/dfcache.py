"""dfcache, local cache entries as P2P tasks: the port's copy of
``dragonfly2_tpu/client/dfcache.py``.

A cache entry is the task of ``dfcache://{cache_id}``: ``import_file``
makes this host a parent of it (``Daemon.ImportTask``; with
``persistent`` the scheduler keeps ``replica_count`` copies for ``ttl``
seconds), ``export_file`` lands it at a path, pulling it over P2P when
it is not local (``Daemon.ExportTask``), ``stat`` and ``delete`` look
it up and remove it (``Daemon.StatTask``, ``Daemon.DeleteTask``), all
over the daemon's unix socket.
"""

from __future__ import annotations

from dataclasses import dataclass

from dragonfly2_tpu_torch.pkg import idgen
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Client


@dataclass
class DfcacheConfig:
    daemon_sock: str
    cache_id: str
    tag: str = ""
    application: str = ""
    timeout: float = 60.0


def task_id_of(cfg: DfcacheConfig) -> str:
    return idgen.task_id_v1(f"dfcache://{cfg.cache_id}",
                            tag=cfg.tag, application=cfg.application)


def _body(cfg: DfcacheConfig) -> dict:
    return {"cache_id": cfg.cache_id, "tag": cfg.tag,
            "application": cfg.application}


async def import_file(cfg: DfcacheConfig, path: str, *,
                      persistent: bool = False, replica_count: int = 1,
                      ttl: float = 0.0) -> dict:
    """Import a local file as this host's copy of the cache entry."""
    cli = Client(NetAddr.unix(cfg.daemon_sock))
    try:
        return await cli.call(
            "Daemon.ImportTask",
            {**_body(cfg), "path": path, "persistent": persistent,
             "replica_count": replica_count, "ttl": ttl},
            timeout=cfg.timeout)
    finally:
        await cli.close()


async def export_file(cfg: DfcacheConfig, output: str) -> dict:
    """Land the cache entry at ``output``, pulling it over P2P if it is
    not local."""
    cli = Client(NetAddr.unix(cfg.daemon_sock))
    try:
        stream = await cli.open_stream("Daemon.ExportTask",
                                       {**_body(cfg), "output": output})
        final: dict = {}
        while True:
            msg = await stream.recv(timeout=cfg.timeout)
            if msg is None:
                break
            final = msg
            if msg.get("state") in ("done", "failed"):
                break
        await stream.close()
        if final.get("state") != "done":
            err = final.get("error") or {}
            raise DfError(Code(err.get("code", Code.UnknownError)),
                          err.get("message", "export failed"))
        return final
    finally:
        await cli.close()


async def stat(cfg: DfcacheConfig) -> dict:
    """Whether this host holds the entry."""
    cli = Client(NetAddr.unix(cfg.daemon_sock))
    try:
        return await cli.call("Daemon.StatTask", {"task_id": task_id_of(cfg)},
                              timeout=cfg.timeout)
    finally:
        await cli.close()


async def delete(cfg: DfcacheConfig) -> dict:
    cli = Client(NetAddr.unix(cfg.daemon_sock))
    try:
        return await cli.call("Daemon.DeleteTask", {"task_id": task_id_of(cfg)},
                              timeout=cfg.timeout)
    finally:
        await cli.close()
