"""Device-landing client API: fetch content through the P2P fabric and
hand it back as PyTorch tensors in the card's memory.

The port of ``dragonfly2_tpu/client/device.py``. A PyTorch training or
serving process embeds a daemon (pure asyncio, it runs on the process's
loop: the port's own parts, ``TaskManager`` over its storage and piece
manager, or the reference daemon) with the port's sink manager as its
device sink, and checkpoint shards arrive as tensors without a file
export::

    d = Daemon(cfg)                      # cfg.tpu_sink.enabled = False
    d.task_manager.device_sinks = DeviceSinkManager()
    await d.start()
    w = await download_to_device(d, url, digest="sha256:...",
                                 dtype="bfloat16", shape=[8192, 4096])

Four paths: ``download_to_device`` (whole or ranged content),
``download_sharded`` (only some tensors of a safetensors checkpoint, as
ranged tasks), ``download_global`` (only the blocks this rank holds under
each tensor's sharding) and ``download_delta`` (the next checkpoint
generation as a delta against the live one, hot-swapped through a
``DoubleBuffer``).

A sharding is ``(DeviceMesh, placements)``, the port of a
``jax.sharding.Sharding`` (``ops.convert.placements_from_spec`` turns a
``PartitionSpec``'s tuple into placements), and a sharded tensor is a
``DTensor``. Every rank of a mesh runs its own daemon and makes the same
call (``parallel/ici.py`` states the contract).

Where the port differs from the JAX package:

- ``shardings=`` places tensors that every rank landed whole: each rank
  keeps its own block, with no collective (the JAX package moves blocks
  between the devices of one process with ``device_put``);
- ``download_to_device(mesh=...)`` shards content that every rank of the
  mesh landed (``shard_to_mesh(src=None)``);
- a corrupt device landing surfaces as ``DfError(ClientPieceDownloadFail)``
  here, because the reference daemon maps only its own package's sink
  error;
- the hot-swap degrades to a host buffer only on a CUDA out-of-memory; a
  fault of the port's kernels (``KernelError``) and a verify mismatch
  raise.

With no published base manifest, ``download_delta`` chunks the landed
base store itself, as the JAX package does (``local_base_manifest``; the
scan runs on the card).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.daemon.peer.device_sink import DeviceSinkError
from dragonfly2_tpu_torch.daemon.peer.task_manager import (
    DEVICE_SINK,
    FileTaskRequest,
    TaskManager,
)
from dragonfly2_tpu_torch.delta.manifest import (
    DeltaManifest,
    manifest_from_store,
)
from dragonfly2_tpu_torch.delta.resolver import fetch_manifest, plan_delta
from dragonfly2_tpu_torch.ops import safetensors as st
from dragonfly2_tpu_torch.ops.checksum import checksum_numpy
from dragonfly2_tpu_torch.ops.hbm_sink import (
    DoubleBuffer,
    assemble_delta_u8,
    verify_u8_against_host,
)
from dragonfly2_tpu_torch.parallel.multihost import (
    block_index,
    check_shardings,
    from_local,
)
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.proto.common import UrlMeta

log = dflog.get("client.device")

# The first ranged pull of a safetensors header: its guessed size.
PREFIX_GUESS = 256 << 10


@dataclass
class DeviceResult:
    """A completed device landing: the verified sink plus task facts."""

    task_id: str
    content_length: int
    from_p2p: bool
    from_reuse: bool
    sink: object  # TaskDeviceSink

    def as_bytes_array(self) -> torch.Tensor:
        return self.sink.as_bytes_array()

    def as_tensor(self, dtype, shape) -> torch.Tensor:
        return self.sink.as_tensor(dtype, shape)

    def shard_to_mesh(self, mesh, axis_name: str = "d", *,
                      src: int | None = None):
        return self.sink.shard_to_mesh(mesh, axis_name, src=src)

    def load_safetensors(self, *, names: list[str] | None = None,
                         shardings: dict | None = None) -> dict:
        """The landed content as named checkpoint tensors: views of the
        sink's buffer (the content must be a safetensors file), and
        ``DTensor`` blocks for those named in ``shardings``."""
        return st.load_from_sink(self.sink, names=names, shardings=shardings)


async def download_to_device(daemon, url: str, *, digest: str = "",
                             tag: str = "", application: str = "",
                             header: dict | None = None,
                             range_header: str = "",
                             dtype=None, shape=None,
                             mesh=None, axis_name: str = "d",
                             claim: bool = True):
    """Download ``url`` through the embedded daemon's P2P machinery and
    land it in its device sink. Returns a tensor when ``dtype`` and
    ``shape`` are given (a view of the landed bytes); with ``mesh``, the
    padded int32 words sharded over ``axis_name`` (``shard_to_mesh``:
    every rank of the mesh makes this call and keeps its own shard); else
    a ``DeviceResult``.

    ``claim``: take ownership of the sink (the manager forgets it; the
    memory goes with the caller's last reference). With ``claim=False``
    the sink stays resident for other consumers until its TTL.

    ``range_header`` ("a-b" or "bytes=a-b"): land only that byte slice,
    as its own ranged task (deduped among peers pulling the same range).
    A ranged landing verifies by the per-piece digest chain only; a
    whole-content ``digest`` cannot apply to a slice.
    """
    tm = daemon.task_manager
    if tm.device_sinks is None:
        raise DfError(Code.BadRequest,
                      "daemon has no device sink (set its task manager's "
                      "device_sinks to a DeviceSinkManager)")
    rng = Range.normalize_header(range_header) if range_header else ""
    req = FileTaskRequest(
        url=url, output="",
        meta=UrlMeta(digest=digest, tag=tag, application=application,
                     header=header or {}, range=rng),
        device=DEVICE_SINK)
    if rng:
        req.range = Range.parse_http(rng)
    sink = None
    # The task id is deterministic: announce the claim so the verify ->
    # take window never loses the sink to eviction, only to a concurrent
    # claimer of the same task.
    expected_id = req.task_id()
    tm.device_sinks.protect(expected_id)
    try:
        for attempt in range(2):
            final = None
            try:
                async with tm.device_sinks.admit():
                    async for progress in tm.start_file_task(req):
                        if progress.state == "failed":
                            raise DfError.from_wire(progress.error or {})
                        if progress.state == "done":
                            final = progress
            except DeviceSinkError as e:
                # The reference task manager maps only its own package's
                # sink error to a DfError; the port's reaches us here,
                # after the disk store is complete and the manager has
                # dropped the corrupt sink.
                raise DfError(Code.ClientPieceDownloadFail,
                              f"device sink verification failed: {e}") from e
            if final is None:
                raise DfError(Code.UnknownError,
                              "download ended without a result")
            if not final.device_verified:
                raise DfError(Code.ClientPieceDownloadFail,
                              "content did not land in the device sink "
                              "(sink cap reached or pieces misaligned)")
            task_id = final.task_id
            sink = (tm.device_sinks.take(task_id) if claim
                    else tm.device_sinks.get(task_id))
            if sink is not None:
                break
            # Another caller of the same (deduped) task claimed the sink
            # first. The task is complete on disk, so one re-run rides
            # the reuse path, which lands and verifies a fresh sink.
            if attempt == 0:
                log.info("device sink claimed by a concurrent caller; "
                         "rebuilding from store", task=task_id[:16])
    finally:
        tm.device_sinks.unprotect(expected_id)
    if sink is None:
        raise DfError(Code.UnknownError, "device sink vanished after verify")
    result = DeviceResult(task_id=task_id,
                          content_length=final.content_length,
                          from_p2p=final.from_p2p,
                          from_reuse=final.from_reuse, sink=sink)
    if dtype is not None and shape is not None:
        return result.as_tensor(dtype, shape)
    if mesh is not None:
        return result.shard_to_mesh(mesh, axis_name)
    return result


async def fetch_safetensors_header(daemon, url: str, *, tag: str = "",
                                   application: str = "",
                                   header: dict | None = None,
                                   prefix_guess: int = PREFIX_GUESS):
    """The checkpoint's parsed safetensors header through one ranged pull
    of a guessed size (a second exact pull covers a header larger than
    the guess). Returns ``(header_dict, data_start_abs, prefix_u8)``:
    ``prefix_u8`` is the landed guess, whose bytes beyond the header are
    real tensor data that callers carve spans from."""
    first = await download_to_device(
        daemon, url, tag=tag, application=application, header=header,
        range_header=f"0-{prefix_guess - 1}")
    prefix_u8 = first.as_bytes_array()
    got = prefix_u8.cpu().numpy().tobytes()
    if len(got) < 8:
        raise st.SafetensorsError(f"file shorter ({len(got)}B) than the "
                                  "safetensors length prefix")
    n = int.from_bytes(got[:8], "little")
    if n <= 0 or n > (1 << 27):
        raise st.SafetensorsError(f"implausible header length {n}")
    if 8 + n > len(got):
        rest = await download_to_device(
            daemon, url, tag=tag, application=application, header=header,
            range_header=f"{len(got)}-{8 + n - 1}")
        got += rest.as_bytes_array().cpu().numpy().tobytes()
    header_dict, _ = st.parse_header(got[:8 + n])
    return header_dict, 8 + n, prefix_u8


async def _pull_ranges(daemon, url: str, ranges, *, tag: str = "",
                       application: str = "",
                       header: dict | None = None) -> dict:
    """Pull each ``(start, end)`` byte range as its own ranged device
    task, concurrently under the daemon's sink admission; returns
    ``{(start, end): u8}``. A failed range cancels its siblings and the
    first failure re-raises as it is."""
    landed: dict = {}

    async def pull(s0: int, s1: int) -> None:
        result = await download_to_device(
            daemon, url, tag=tag, application=application, header=header,
            range_header=f"{s0}-{s1 - 1}")
        landed[(s0, s1)] = result.as_bytes_array()

    tasks = [asyncio.ensure_future(pull(s0, s1)) for s0, s1 in ranges]
    try:
        await asyncio.gather(*tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise
    return landed


def coalesce_spans(spans) -> list[tuple[int, int]]:
    """Touching or overlapping ``(start, end)`` spans merged, sorted."""
    merged: list[list[int]] = []
    for s0, s1 in sorted(spans):
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s1)
        else:
            merged.append([s0, s1])
    return [(s0, s1) for s0, s1 in merged]


def covering_span(coverage, a: int, b: int) -> tuple[int, int]:
    """The first span of ``coverage`` that contains [a, b); a miss is a
    planner bug and raises SafetensorsError, never a wrong carve."""
    for s0, s1 in coverage:
        if s0 <= a and b <= s1:
            return (s0, s1)
    raise st.SafetensorsError(
        f"internal: span [{a}, {b}) not covered by any landed range")


def _validated_span(name: str, meta, data_start: int) -> tuple[int, int]:
    """(absolute_start, absolute_end) of a tensor's bytes; a malformed
    header entry raises SafetensorsError."""
    if not isinstance(meta, dict):
        raise st.SafetensorsError(f"{name}: entry must be an object")
    offsets = meta.get("data_offsets")
    if (not isinstance(offsets, list) or len(offsets) != 2
            or not all(isinstance(o, int) and not isinstance(o, bool)
                       for o in offsets)
            or offsets[1] < offsets[0] or offsets[0] < 0):
        raise st.SafetensorsError(f"{name}: bad data_offsets {offsets!r}")
    return data_start + offsets[0], data_start + offsets[1]


async def download_sharded(daemon, url: str, *,
                           names: list[str] | None = None,
                           selector=None,
                           shardings: dict | None = None,
                           tag: str = "", application: str = "",
                           header: dict | None = None,
                           coalesce_gap: int = 4 << 20,
                           prefix_guess: int = PREFIX_GUESS) -> dict:
    """Pull only some tensors of a safetensors checkpoint, as ranged
    device tasks: the pipeline stage or expert shard a host needs, not
    the whole file. Hosts that pick the same tensors send byte-identical
    ranged tasks, so the fabric dedups origin traffic per range.

    ``names``: an explicit tensor list, or ``selector(name, meta) ->
    bool`` over the header's entries. Selected spans closer than
    ``coalesce_gap`` bytes merge into one ranged task (the gap bytes ride
    along). ``shardings``: tensor name -> ``(DeviceMesh, placements)``,
    applied after landing (``st.apply_shardings``); a sharding of a tensor
    not selected raises before any tensor is pulled. Returns
    ``{name: tensor}``, views of the landed ranges.
    """
    check_shardings(shardings)
    header_dict, data_start, prefix_u8 = await fetch_safetensors_header(
        daemon, url, tag=tag, application=application, header=header,
        prefix_guess=prefix_guess)
    plen = int(prefix_u8.shape[0])

    picked: list[tuple[int, int, str]] = []
    for name, meta in header_dict.items():
        if name == "__metadata__":
            continue
        if names is not None and name not in names:
            continue
        if selector is not None and not selector(name, meta):
            continue
        start, end = _validated_span(name, meta, data_start)
        picked.append((start, end, name))
    if names is not None:
        missing = set(names) - {n for _, _, n in picked}
        if missing:
            raise st.SafetensorsError(
                f"tensors not in checkpoint: {sorted(missing)}")
    if shardings:
        unknown = [n for n in shardings if n not in {t[2] for t in picked}]
        if unknown:
            raise st.SafetensorsError(
                f"shardings reference tensors not loaded: {unknown}")

    out: dict = {}
    # A zero-element tensor (data_offsets [s, s]) carries no bytes: make
    # it instead of pulling an empty range.
    nonempty = []
    for start, end, name in picked:
        if end > start:
            nonempty.append((start, end, name))
            continue
        sub = {name: {**header_dict[name], "data_offsets": [0, 0]}}
        out.update(st.tensor_views(
            torch.zeros((0,), dtype=torch.uint8, device=prefix_u8.device),
            sub, 0, [name]))
    if not nonempty and not out:
        return {}

    nonempty.sort()
    spans: list[list] = []  # [start, end, [names...]]
    for start, end, name in nonempty:
        if spans and start - spans[-1][1] <= coalesce_gap:
            spans[-1][1] = max(spans[-1][1], end)
            spans[-1][2].append(name)
        else:
            spans.append([start, end, [name]])

    # Spans the header's guessed landing already covers carve from it; the
    # rest pull concurrently.
    landed = await _pull_ranges(daemon, url,
                                [(s, e) for s, e, _ in spans if e > plen],
                                tag=tag, application=application,
                                header=header)
    coverage = list(landed.items())
    if plen:
        coverage.append(((0, plen), prefix_u8))
    for start, end, span_names in spans:
        u8, base = next((u, c0) for (c0, c1), u in coverage
                        if c0 <= start and end <= c1)
        sub_header = {
            n: {**header_dict[n],
                "data_offsets": [
                    data_start + header_dict[n]["data_offsets"][0] - base,
                    data_start + header_dict[n]["data_offsets"][1] - base]}
            for n in span_names}
        out.update(st.tensor_views(u8, sub_header, 0, span_names))
    return st.apply_shardings(out, shardings)


def _shape_of(name: str, meta) -> tuple[int, ...]:
    shape = meta.get("shape")
    if (not isinstance(shape, list)
            or not all(isinstance(d, int) and not isinstance(d, bool)
                       and d >= 0 for d in shape)):
        raise st.SafetensorsError(f"{name}: bad shape {shape!r}")
    return tuple(shape)


def plan_global(header: dict, data_start: int, layouts: dict) -> list:
    """``download_global``'s plan for one rank, a pure function.

    ``layouts``: tensor name -> ``(placements, mesh_shape, coord)``, the
    rank's coordinate on the tensor's mesh. Returns one
    ``(name, span_start, span_end, shard_shape, index)`` per tensor: the
    absolute byte span to land and how to carve the rank's block from it.
    A block that is a slice of the leading axis with every other axis
    whole is a contiguous span and is pulled exactly (``index`` None, the
    span holds just the block); any other block pulls the tensor's whole
    span and is sliced on the device by ``index``. Blocks follow
    ``multihost.block_index`` (``torch.chunk`` sizes), as the JAX package's
    follow ``Sharding.devices_indices_map``."""
    plan = []
    for name, (placements, mesh_shape, coord) in layouts.items():
        meta = header[name]
        begin, end = _validated_span(name, meta, data_start)
        shape = _shape_of(name, meta)
        nbytes = end - begin
        count = int(np.prod(shape)) if shape else 1
        itemsize = nbytes // max(1, count)
        row_bytes = (int(np.prod(shape[1:])) if len(shape) > 1 else 1) \
            * itemsize
        idx = block_index(shape, mesh_shape, coord, placements)
        shard_shape = tuple(len(range(*sl.indices(dim)))
                            for sl, dim in zip(idx, shape))
        if (len(shape) >= 1 and nbytes > 0
                and all(s == slice(None) for s in idx[1:])):
            r0, r1, _ = idx[0].indices(shape[0])
            plan.append((name, begin + r0 * row_bytes,
                         begin + max(r0, r1) * row_bytes, shard_shape, None))
        else:
            plan.append((name, begin, end, shard_shape, idx))
    return plan


async def download_global(daemon, url: str, shardings: dict, *,
                          tag: str = "", application: str = "",
                          header: dict | None = None,
                          prefix_guess: int = PREFIX_GUESS) -> dict:
    """Global sharded checkpoint load through the fabric: for each tensor
    of ``shardings`` (name -> ``(DeviceMesh, placements)``; tensors not
    named are not loaded), this rank pulls only the bytes of its own
    block, lands them as ranged device tasks and wraps the block as a
    global ``DTensor`` (``from_local``: no collective). Every rank of the
    meshes makes this call with its own daemon; ranks holding the same
    block send byte-identical ranged tasks, so the origin serves each
    block once and the fabric fans it out.

    Leading-axis blocks are pulled exactly; any other block pulls the
    tensor's whole span once and is sliced on the device
    (``plan_global``). Touching spans coalesce into one ranged task."""
    check_shardings(shardings)
    header_dict, data_start, prefix_u8 = await fetch_safetensors_header(
        daemon, url, tag=tag, application=application, header=header,
        prefix_guess=prefix_guess)
    plen = int(prefix_u8.shape[0])
    missing = [n for n in shardings if n not in header_dict]
    if missing:
        raise st.SafetensorsError(
            f"tensors not in checkpoint: {sorted(missing)}")
    layouts = {}
    for name, (mesh, placements) in shardings.items():
        coord = mesh.get_coordinate()
        if coord is None:
            raise st.SafetensorsError(
                f"{name}: sharding has no device on this rank")
        if mesh.device_type != prefix_u8.device.type:
            raise ValueError(f"{name}: mesh on {mesh.device_type}, the "
                             f"sink lands on {prefix_u8.device}")
        layouts[name] = (placements, tuple(mesh.mesh.shape), coord)
    plan = plan_global(header_dict, data_start, layouts)

    pull_list = [m for m in coalesce_spans(
        (a, b) for _, a, b, _, _ in plan if b > a) if m[1] > plen]
    landed = await _pull_ranges(daemon, url, pull_list, tag=tag,
                                application=application, header=header)
    if plen:
        landed[(0, plen)] = prefix_u8
    coverage = pull_list + ([(0, plen)] if plen else [])

    out: dict = {}
    for name, a, b, shard_shape, idx in plan:
        meta = header_dict[name]
        if b <= a:
            # A block with no bytes, through the same validated dtype path.
            sub = {name: {**meta, "shape": list(shard_shape),
                          "data_offsets": [0, 0]}}
            block = st.tensor_views(prefix_u8[:0], sub, 0, [name])[name]
        else:
            s0, s1 = covering_span(coverage, a, b)
            if idx is None:
                meta = {**meta, "shape": list(shard_shape)}
            sub = {name: {**meta, "data_offsets": [a - s0, b - s0]}}
            block = st.tensor_views(landed[(s0, s1)], sub, 0, [name])[name]
            if idx is not None:
                block = block[idx].contiguous()
        mesh, placements = shardings[name]
        out[name] = from_local(block, mesh, placements,
                               _shape_of(name, header_dict[name]))
    return out


# ------------------------------------------------------------------ #
# Checkpoint-delta hot-swap
# ------------------------------------------------------------------ #

@dataclass
class HotSwapResult:
    """One hot-swapped checkpoint generation: the verified buffer, its
    named tensor views and the accounting that produced it. ``buffer``
    and ``tensors`` are also installed in the caller's ``DoubleBuffer``
    (when given) by one flip."""

    task_id: str
    content_length: int
    generation: int
    buffer: torch.Tensor        # uint8; on the host after an OOM degrade
    tensors: dict
    on_device: bool             # False after an out-of-memory degrade
    flipped: bool
    reused_device_bytes: int    # copied device to device from the live buffer
    staged_bytes: int           # staged from the host (fetched chunks)
    stats: dict = field(default_factory=dict)   # the delta task's accounting
    copies: int = 0             # copies the assembly queued, after coalescing
    # Seconds of each step on the host clock: parts_s (planning the
    # parts), assemble_s (allocating the spare buffer, reading the fetched
    # runs into the host staging, queueing the copies), host_checksum_s, gate_s,
    # flip_s; and on the card the copies' time, assemble_device_ms (CUDA
    # events around the queued copies).
    timings: dict = field(default_factory=dict)


def _read_store_span(store, start: int, length: int) -> bytearray:
    """[start, start+length) of a completed store, read into a fresh
    buffer."""
    buf = bytearray(length)
    with store:
        store.read_into(start, length, buf)
    return buf


def _host_piece_checksums(store) -> dict[int, tuple[int, int]]:
    """(sum32, xor32) of every piece of the landed disk copy: the host
    side of the hot-swap gate."""
    out: dict[int, tuple[int, int]] = {}
    with store:
        for rec in store.get_pieces():
            out[rec.num] = checksum_numpy(store.read_piece(rec.num))
    return out


def _device_parts(new_m: DeltaManifest,
                  base_m: DeltaManifest) -> tuple[list, int, int]:
    """The assembly plan: each reused chunk as a span of the live buffer
    at its base offset, each run of adjacent fetched chunks as a span
    ``("s", offset, length)`` of the verified disk landing (never the
    wire), which the assembly reads straight into its staging. Returns
    (parts, reused_bytes, staged_bytes)."""
    plan = plan_delta(new_m, base_m)
    base_of = {c.offset: b for c, b in plan.reused}
    span_end = dict(plan.fetch_spans())
    parts: list = []
    reused = staged = 0
    off = 0
    for c in new_m.chunks:
        if c.offset < off:
            continue                    # inside a fetched run already planned
        b = base_of.get(c.offset)
        if b is not None:
            parts.append(("r", b.offset, b.length))
            reused += c.length
            off = c.end
        else:
            off = span_end[c.offset]
            parts.append(("s", c.offset, off - c.offset))
            staged += off - c.offset
    return parts, reused, staged


def local_base_manifest(base_store, new_m: DeltaManifest | None,
                        base_m: DeltaManifest | None = None, *, device=None,
                        stats: dict | None = None) -> DeltaManifest | None:
    """The base manifest of a device delta: ``base_m`` (the published
    one) when there is one; else, when the base is landed here and the new
    version's manifest ``new_m`` is at hand, the base store chunked with
    ``new_m``'s params (``manifest_from_store``, scanned on ``device``), as
    the JAX package's ``download_delta`` does; else None. Blocking:
    ``download_delta`` runs it in its worker thread."""
    if base_m is not None or base_store is None or new_m is None:
        return base_m
    log.info("no published base manifest; chunking the landed base",
             base=base_store.metadata.task_id[:16])
    return manifest_from_store(base_store, base_store.metadata.url,
                               new_m.params, device=device, stats=stats)


def swap_generation(store, *, live_u8: torch.Tensor | None = None,
                    new_m: DeltaManifest | None = None,
                    base_m: DeltaManifest | None = None,
                    hot: DoubleBuffer | None = None,
                    names: list[str] | None = None, device=None,
                    task_id: str = "",
                    shardings: dict | None = None) -> HotSwapResult:
    """The device half of a delta hot-swap, synchronous: parts ->
    assemble -> host checksums -> gate -> tensor views -> flip.

    ``store`` is the verified landing of the new generation (the
    daemon's task store: ``metadata``, ``read_into``, ``get_pieces``,
    ``read_piece``, and ``with`` to pin it). The new generation goes to
    ``device`` (``default_device``: the current CUDA device unless the
    caller asks for the CPU). With a live buffer on that device and both
    manifests (equal chunking params), reused chunks copy device to
    device out of ``live_u8`` and only fetched chunks are staged;
    otherwise the whole buffer is staged from the store. A live buffer
    on another device (the host buffer an out-of-memory degrade left) is
    not reused, so the next swap lands on the card again. The assembled
    buffer is checked on the device against the store's per-piece
    checksums before ``hot`` (if given) flips to it; a mismatch raises
    ``DfError(ClientPieceDownloadFail)`` and nothing flips. A CUDA
    out-of-memory during assembly degrades this swap alone to a host
    buffer over the store (``on_device=False``, logged); a kernel fault
    raises.

    ``shardings`` (name -> ``(DeviceMesh, placements)``) places the named
    tensors of a generation on the device (``st.apply_shardings``); a
    generation degraded to the host keeps plain views, as in the JAX
    package.

    ``download_delta`` runs this in a worker thread; the assembly and the
    gate then run on that thread's current stream. The gate's stream
    waits on an event recorded after the assembly all the same."""
    check_shardings(shardings)
    dev = default_device(device)
    m = store.metadata
    total = m.content_length
    timings: dict = {}
    if live_u8 is not None and live_u8.device != dev:
        log.warning("live generation is not on the target device; staging "
                    "the whole buffer", task=task_id[:16],
                    live=str(live_u8.device), target=str(dev))
        live_u8 = None
    t0 = time.perf_counter()
    if (live_u8 is not None and new_m is not None and base_m is not None
            and base_m.params == new_m.params):
        parts, reused, staged = _device_parts(new_m, base_m)
    else:
        if live_u8 is not None:
            log.info("no manifest pair for a device delta; staging the "
                     "whole buffer", task=task_id[:16])
        parts, reused, staged = [("s", 0, total)], 0, total
    timings["parts_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats: dict = {}
    try:
        with store:
            u8 = assemble_delta_u8(live_u8, parts, device=dev, store=store,
                                   stats=stats)
    except torch.cuda.OutOfMemoryError as e:
        # The serving process must outlive a full card: this generation
        # comes from the digest-verified disk landing instead.
        log.warning("hot-swap assembly out of device memory; host buffer "
                    "for this generation", task=task_id[:16],
                    error=str(e)[:200])
        u8 = torch.from_numpy(
            np.frombuffer(_read_store_span(store, 0, total), np.uint8))
        return _install(u8, hot, names, task_id, total, on_device=False,
                        reused=0, staged=total, copies=0, timings=timings,
                        shardings=shardings)
    timings["assemble_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    checks = _host_piece_checksums(store)
    timings["host_checksum_s"] = time.perf_counter() - t0
    piece_size = m.piece_size
    if m.total_piece_count <= 1:
        piece_size = (total + ((-total) % 4)) or 4
    t0 = time.perf_counter()
    if "done" in stats:
        torch.cuda.current_stream(dev).wait_event(stats["done"])
    try:
        verify_u8_against_host(u8, piece_size, checks)
    except ValueError as e:
        raise DfError(Code.ClientPieceDownloadFail,
                      f"hot-swap verify failed: {e}") from e
    timings["gate_s"] = time.perf_counter() - t0
    if "done" in stats:
        timings["assemble_device_ms"] = stats["start"].elapsed_time(
            stats["done"])
    return _install(u8, hot, names, task_id, total, on_device=True,
                    reused=reused, staged=staged, copies=stats["copies"],
                    timings=timings, shardings=shardings)


def _install(u8: torch.Tensor, hot: DoubleBuffer | None, names, task_id: str,
             total: int, *, on_device: bool, reused: int, staged: int,
             copies: int, timings: dict,
             shardings: dict | None = None) -> HotSwapResult:
    """Tensor views of a checked buffer, placed by ``shardings`` on the
    device, flipped into ``hot``."""
    t0 = time.perf_counter()
    header, data_start = st.read_header(u8)
    tensors = st.tensor_views(u8, header, data_start, names)
    if on_device:
        st.apply_shardings(tensors, shardings)
    elif shardings:
        log.warning("host generation: shardings not applied",
                    task=task_id[:16])
    generation, flipped = 1, False
    if hot is not None:
        generation = hot.flip(u8, tensors)
        flipped = True
    timings["flip_s"] = time.perf_counter() - t0
    return HotSwapResult(
        task_id=task_id, content_length=total, generation=generation,
        buffer=u8, tensors=tensors, on_device=on_device, flipped=flipped,
        reused_device_bytes=reused, staged_bytes=staged, copies=copies,
        timings=timings)


async def download_delta(daemon, url: str, *, base, hot=None,
                         digest: str = "", tag: str = "",
                         application: str = "", header: dict | None = None,
                         names: list[str] | None = None,
                         shardings: dict | None = None,
                         device=None) -> HotSwapResult:
    """Land version N+1 of a checkpoint as a delta against version N and
    hot-swap the tensors without a serving gap.

    ``base``: the live generation, a ``DeviceResult``/``HotSwapResult``
    from the previous download, or a bare base task id (then the live
    buffer, if any, comes from ``hot``). ``hot``: a ``DoubleBuffer``;
    the verified new generation is installed with one flip, so a reader
    iterating ``hot.snapshot()`` sees only complete old-or-new sets.
    ``device``: where the new generation goes (``default_device``: the
    current CUDA device unless the caller asks for the CPU).

    The wire side is the daemon's delta task
    (``TaskManager.start_delta_task``, ``delta/resolver.run_delta_task``):
    only changed chunks cross the network, and the patched disk landing
    is digest-checked. On the port's own task manager, ``device`` also
    reaches that task: a base manifest that was never published is built
    there (K3 on the card) and published, so the swap below finds it; a
    reference daemon builds it on its host. The device side runs in a
    worker thread: ``local_base_manifest`` when the fabric still has no
    manifest of the base, then ``swap_generation``; ``shardings`` places
    the new generation's tensors there.
    """
    check_shardings(shardings)
    tm = daemon.task_manager
    base_task_id = base if isinstance(base, str) else base.task_id
    live_u8 = None
    if hot is not None and hot.generation > 0:
        live_u8 = hot.buffer()
    elif not isinstance(base, str):
        live_u8 = (base.buffer if isinstance(base, HotSwapResult)
                   else base.as_bytes_array())

    req = FileTaskRequest(
        url=url, output="",
        meta=UrlMeta(digest=digest, tag=tag, application=application,
                     header=header or {}))
    task_kw = {"device": device} if isinstance(tm, TaskManager) else {}
    final = None
    async for progress in tm.start_delta_task(req, base_task_id, **task_kw):
        if progress.state == "failed":
            raise DfError.from_wire(progress.error or {})
        if progress.state == "done":
            final = progress
    if final is None:
        raise DfError(Code.UnknownError, "delta download ended silently")
    store = tm.storage.find_completed_task(final.task_id)
    if store is None:
        raise DfError(Code.UnknownError, "delta task has no store")

    new_m = base_m = base_store = None
    if live_u8 is not None:
        new_m = await fetch_manifest(tm, final.task_id)
        base_store = tm.storage.find_completed_task(base_task_id)
        if new_m is not None and base_store is not None:
            base_m = await fetch_manifest(tm, base_task_id)

    def swap() -> HotSwapResult:
        base = local_base_manifest(base_store, new_m, base_m, device=device)
        return swap_generation(
            store, live_u8=live_u8, new_m=new_m, base_m=base, hot=hot,
            names=names, device=device, task_id=final.task_id,
            shardings=shardings)

    result = await asyncio.to_thread(swap)
    result.stats = dict(tm.delta_stats.get(final.task_id, {}))
    return result
