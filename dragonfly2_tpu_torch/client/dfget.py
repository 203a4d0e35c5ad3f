"""The dfget library, a download through the local daemon: the port's copy
of ``dragonfly2_tpu/client/dfget.py``.

``download`` opens ``Daemon.Download`` on the daemon's unix socket and
follows its progress frames to the final one; with ``explain`` and
``pod`` it attaches ``Daemon.FlightReport`` and ``Daemon.PodTimeline``
(advisory: a miss leaves the result as it was). A daemon that cannot be
reached falls back to a direct fetch from the origin (the port's
``source`` clients, the digest checked after), except for a device
request: a direct fetch cannot land in the daemon's device sink, so that
error is raised. ``recursive`` walks the origin's listing and downloads
each file. ``device`` keeps the JAX wire value ``"tpu"``. The download
runs inside a ``dfget.download`` span (``pkg/tracing``, attributes
``url`` and ``task_id``), whose context rides ``Daemon.Download``'s
metadata to the daemon, as in JAX.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable

from dragonfly2_tpu_torch.pkg import dflog, tracing
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.proto.common import UrlMeta
from dragonfly2_tpu_torch.rpc import Client

log = dflog.get("dfget")


@dataclass
class DfgetConfig:
    url: str
    output: str
    daemon_sock: str
    meta: UrlMeta = field(default_factory=UrlMeta)
    disable_back_source: bool = False
    recursive: bool = False
    level: int = 5                       # recursion depth cap
    timeout: float = 0.0                 # 0 = none
    allow_source_fallback: bool = True   # direct fetch if daemon dead
    device: str = ""                     # "tpu": land in the daemon's sink
    # Striped slice broadcast: each host of the slice pulls 1/S of the
    # pieces from outside and the slice completes the copy internally.
    pod_broadcast: bool = False
    # After the download, attach the daemon's flight report as ``flight``.
    explain: bool = False
    # Also attach the scheduler's merged pod timeline as ``pod``.
    pod: bool = False
    # Task id of a locally landed base version (the delta plane).
    delta_base: str = ""


async def download(cfg: DfgetConfig,
                   on_progress: Callable[[dict], None] | None = None) -> dict:
    """One download through the daemon; returns the final progress frame."""
    with tracing.span("dfget.download", url=cfg.url) as sp:
        if cfg.recursive:
            return await _download_recursive(cfg, on_progress)
        try:
            result = await _daemon_download(cfg, on_progress)
            sp.set_attr("task_id", result.get("task_id", ""))
            return result
        except DfError as e:
            if (e.code == Code.ClientConnectionError
                    and cfg.allow_source_fallback and not cfg.device):
                log.warning("daemon unreachable; falling back to direct "
                            "source download")
                return await _download_from_source(cfg)
            raise


async def _daemon_download(cfg: DfgetConfig, on_progress) -> dict:
    cli = Client(NetAddr.unix(cfg.daemon_sock))
    try:
        stream = await cli.open_stream(
            "Daemon.Download",
            {
                "url": cfg.url,
                "output": os.path.abspath(cfg.output) if cfg.output else "",
                "meta": cfg.meta.to_wire(),
                "disable_back_source": cfg.disable_back_source,
                "device": cfg.device,
                "pod_broadcast": cfg.pod_broadcast,
                "delta_base": cfg.delta_base,
            },
        )
        final: dict | None = None
        timeout = cfg.timeout if cfg.timeout > 0 else None
        while True:
            msg = await stream.recv(timeout=timeout)
            if msg is None:
                break
            if on_progress is not None:
                on_progress(msg)
            if msg.get("state") in ("done", "failed"):
                final = msg
        if final is None:
            raise DfError(Code.UnknownError, "daemon closed stream without a result")
        if final["state"] == "failed":
            raise DfError.from_wire(final.get("error") or {})
        if cfg.explain and final.get("task_id"):
            try:
                final["flight"] = await cli.call(
                    "Daemon.FlightReport", {"task_id": final["task_id"]},
                    timeout=10.0)
            except DfError as e:
                log.warning("flight report unavailable", error=str(e))
        if cfg.pod and final.get("task_id"):
            try:
                final["pod"] = await cli.call(
                    "Daemon.PodTimeline", {"task_id": final["task_id"]},
                    timeout=15.0)
            except DfError as e:
                log.warning("pod timeline unavailable", error=str(e))
        return final
    finally:
        await cli.close()


async def _download_from_source(cfg: DfgetConfig) -> dict:
    """The daemon-less direct fetch."""
    from dragonfly2_tpu_torch.source import default_registry

    # Held for the stream's lifetime: a daemon in this process stopping
    # meanwhile must not close the shared origin clients under it.
    registry = default_registry().retain()
    try:
        return await _download_from_source_inner(cfg)
    finally:
        await registry.release()


async def _download_from_source_inner(cfg: DfgetConfig) -> dict:
    from dragonfly2_tpu_torch.source import Request as SourceRequest
    from dragonfly2_tpu_torch.source import get_client

    client = get_client(cfg.url)
    req = SourceRequest(cfg.url, dict(cfg.meta.header))
    if cfg.meta.range:
        # No task id on this path, and a suffix range is plain HTTP here.
        req = req.with_range(
            cfg.meta.range if cfg.meta.range.startswith("bytes=")
            else f"bytes={cfg.meta.range}")
    resp = await client.download(req)
    out = os.path.abspath(cfg.output)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    total = 0
    with open(out, "wb") as f:
        async for chunk in resp.body:
            f.write(chunk)
            total += len(chunk)
    await resp.close()
    if cfg.meta.digest:
        from dragonfly2_tpu_torch.pkg import digest as pkgdigest

        d = pkgdigest.parse(cfg.meta.digest)
        actual = pkgdigest.hash_file(d.algorithm, out)
        if actual.encoded != d.encoded:
            os.unlink(out)
            raise DfError(Code.ClientPieceDownloadFail,
                          f"digest mismatch: want {d.encoded}, got {actual.encoded}")
    return {"state": "done", "content_length": total, "completed_length": total,
            "from_source": True}


async def _download_recursive(cfg: DfgetConfig, on_progress) -> dict:
    """Every file under the origin's listing of ``cfg.url``, to
    ``level`` directories deep."""
    from dragonfly2_tpu_torch.source import Request as SourceRequest
    from dragonfly2_tpu_torch.source import get_client

    client = get_client(cfg.url)
    done: list[dict] = []

    async def walk(url: str, out_dir: str, depth: int) -> None:
        if depth > cfg.level:
            return
        entries = await client.list_metadata(SourceRequest(url, dict(cfg.meta.header)))
        for e in entries:
            if e.is_dir:
                await walk(e.url, os.path.join(out_dir, e.name), depth + 1)
            else:
                sub = DfgetConfig(
                    url=e.url,
                    output=os.path.join(out_dir, e.name),
                    daemon_sock=cfg.daemon_sock,
                    meta=UrlMeta(tag=cfg.meta.tag, application=cfg.meta.application,
                                 header=dict(cfg.meta.header)),
                    disable_back_source=cfg.disable_back_source,
                    allow_source_fallback=cfg.allow_source_fallback,
                )
                done.append(await download(sub, on_progress))

    await walk(cfg.url, cfg.output, 0)
    total = sum(d.get("completed_length", 0) for d in done)
    return {"state": "done", "files": len(done), "completed_length": total}


async def is_daemon_alive(daemon_sock: str) -> bool:
    if not os.path.exists(daemon_sock):
        return False
    cli = Client(NetAddr.unix(daemon_sock))
    try:
        return await cli.ping(timeout=2.0)
    finally:
        await cli.close()
