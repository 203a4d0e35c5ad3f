"""Device sink: land verified pieces directly in the card's memory.

The port of ``dragonfly2_tpu/ops/hbm_sink.py`` (``HBMSink``,
``verify_u8_against_host``, and the hot-swap's ``assemble_delta_u8`` and
``DoubleBuffer`` at the end). The daemon hands pieces to an ``HBMSink``,
which stages them in host batches, lands each batch in one flat device
buffer and checks on-device checksums against the host's values. The
result is a device byte tensor, a record batch or a typed tensor, each a
view of the buffer.

Design (differs from the TPU sink, which appends batches and assembles
them once, because XLA copied a donated buffer on every in-place update):

  * construction allocates the padded flat buffer, zeroed, plus per-slot
    ``sums`` / ``xors`` device vectors;
  * ``flush`` copies the sorted batch into one of two pinned host
    buffers, sends it to the card with ``non_blocking=True`` and launches
    ``land_and_checksum`` (K2) once: the batch is stored into its slots in
    place and folded in the same pass, and the kernel stores the checksums
    into the per-slot vectors itself. A pinned buffer is refilled only
    after the event of its previous copy has completed.

One read and one write per landed byte on the card, and a peak of about
one content plus one batch (the TPU sink peaked at twice the content).
Verify-on-land holds: the checksums fold from the same device copy that
becomes the buffer. Slots never landed stay zero, with zero checksums.
"""

from __future__ import annotations

import time
import numpy as np
import torch

from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops.checksum import (
    checksum_numpy,
    chunk_checksums,
    land_and_checksum,
)
from dragonfly2_tpu_torch.parallel import ici

# JAX-style dtype names accepted by ``as_tensor``.
_TORCH_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "uint16": torch.uint16, "int32": torch.int32,
    "uint32": torch.uint32, "int64": torch.int64, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """Map a dtype name (``"bfloat16"``), numpy dtype or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


class HBMSink:
    """One task's landing in one flat device buffer of padded words."""

    def __init__(self, content_length: int, piece_size: int, *, device=None,
                 batch_pieces: int = 8):
        if piece_size % 4:
            raise ValueError("piece_size must be 4-byte aligned")
        self.device = default_device(device)
        if self.device.type == "cuda":
            _build.library()   # a kernel that cannot build fails here, loudly
        self.content_length = content_length
        self.piece_size = piece_size
        self.piece_words = piece_size // 4
        self.total_pieces = max(
            1, (content_length + piece_size - 1) // piece_size)
        self.padded_words = self.total_pieces * self.piece_words
        self.batch_pieces = batch_pieces
        self.host_checksums: dict[int, tuple[int, int]] = {}
        self.landed: set[int] = set()
        self._pending: list[tuple[int, np.ndarray]] = []
        self._buffer = torch.zeros(self.padded_words, dtype=torch.int32,
                                   device=self.device)
        self._dev_sums = torch.zeros(self.total_pieces, dtype=torch.int32,
                                     device=self.device)
        self._dev_xors = torch.zeros_like(self._dev_sums)
        self._cuda = self.device.type == "cuda"
        # Two staging batches, pinned on CUDA, allocated at the first flush.
        self._staging: list[torch.Tensor] = []
        self._copied: list[torch.cuda.Event | None] = [None, None]
        self._turn = 0
        self._ready: torch.cuda.Event | None = None
        self._verified = False
        # Host seconds of the landing, by share: the per-piece host
        # checksum, the copy into pinned staging, and waits for a staging
        # batch's previous host-to-device copy (the device holding the
        # host back).
        self.host_checksum_s = 0.0
        self.stage_s = 0.0
        self.stage_wait_s = 0.0

    # -- landing -----------------------------------------------------------

    def land_piece(self, piece_num: int, data) -> None:
        """Stage one piece (bytes-like); its host checksum is recorded for
        the device check. Flushes every ``batch_pieces`` pieces."""
        if piece_num < 0 or piece_num >= self.total_pieces:
            raise ValueError(
                f"piece {piece_num} out of range for "
                f"{self.total_pieces}-piece sink")
        if piece_num in self.landed:
            return
        if len(data) > self.piece_size:
            raise ValueError(
                f"piece {piece_num} holds {len(data)} bytes, more than the "
                f"{self.piece_size}-byte slot")
        t0 = time.perf_counter()
        self.host_checksums[piece_num] = checksum_numpy(data)
        self.host_checksum_s += time.perf_counter() - t0
        self._pending.append((piece_num, np.frombuffer(data, np.uint8)))
        self.landed.add(piece_num)
        if len(self._pending) >= self.batch_pieces:
            self.flush()

    def _stage(self) -> tuple[torch.Tensor, int]:
        """The next staging batch and its index, once its previous copy
        has completed."""
        if not self._staging:
            shape = (self.batch_pieces, self.piece_words)
            self._staging = [
                torch.empty(shape, dtype=torch.int32, pin_memory=self._cuda)
                for _ in range(2)]
        i = self._turn
        self._turn ^= 1
        if self._copied[i] is not None:
            t0 = time.perf_counter()
            self._copied[i].synchronize()
            self.stage_wait_s += time.perf_counter() - t0
        return self._staging[i], i

    def flush(self) -> None:
        """Land the pending pieces: one host-to-device copy of the sorted
        batch, one of its slot numbers, and one K2 launch, which also
        stores the checksums at their slots."""
        if not self._pending:
            return
        pending = sorted(self._pending, key=lambda p: p[0])
        self._pending.clear()
        k = len(pending)          # at most batch_pieces: land_piece flushes
        stage, i = self._stage()
        t0 = time.perf_counter()
        rows = stage.numpy().view(np.uint8)
        for row, (_, data) in enumerate(pending):
            raw = np.asarray(data).reshape(-1).view(np.uint8)
            rows[row, :raw.size] = raw
            rows[row, raw.size:] = 0     # zero pad short and tail pieces
        self.stage_s += time.perf_counter() - t0
        slots = torch.tensor([n for n, _ in pending], dtype=torch.int32)
        batch = stage[:k].to(self.device, non_blocking=True)
        if self._cuda:
            self._copied[i] = torch.cuda.Event()
            self._copied[i].record(torch.cuda.current_stream(self.device))
        land_and_checksum(self._buffer, batch, slots.to(self.device),
                          self._dev_sums, self._dev_xors)
        self._mark_ready()

    def _mark_ready(self) -> None:
        if self._cuda:
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self.device))

    def _wait_ready(self) -> None:
        """Order the caller's stream after the last landing (the sink is
        mutated on the daemon's worker thread, consumed on another)."""
        if self._ready is not None:
            torch.cuda.current_stream(self.device).wait_event(self._ready)

    def complete(self) -> bool:
        return len(self.landed) >= self.total_pieces

    # -- verification ------------------------------------------------------

    def verify(self) -> bool:
        """Device checksums vs host-recorded values for every landed piece.
        Raises ValueError naming the first corrupt piece."""
        self.flush()
        sums = self._dev_sums.cpu().numpy().view(np.uint32)
        xors = self._dev_xors.cpu().numpy().view(np.uint32)
        for piece_num, (want_s, want_x) in sorted(self.host_checksums.items()):
            have = (int(sums[piece_num]), int(xors[piece_num]))
            if have != (want_s, want_x):
                raise ValueError(
                    f"piece {piece_num} corrupt in HBM: "
                    f"sum {have[0]:#x}!={want_s:#x} "
                    f"xor {have[1]:#x}!={want_x:#x}")
        self._verified = True
        if self.complete():
            # Every piece landed and checked: the staging batches are done.
            self._staging = []
            self._copied = [None, None]
        return True

    # -- consumption (views of the buffer, no copies) ----------------------

    def _bytes(self) -> torch.Tensor:
        self.flush()
        self._wait_ready()
        return self._buffer.view(torch.uint8)

    def as_bytes_array(self) -> torch.Tensor:
        """The landed content as a device uint8 tensor of exact length (a
        view of the buffer: writing to it writes to the sink)."""
        return self._bytes()[: self.content_length]

    def as_record_batch(self, count: int, record_bytes: int) -> torch.Tensor:
        """The landed content as a ``(count, record_bytes)`` uint8 view, for
        piece-per-record landings: each slot holds one record zero-padded
        to the piece size."""
        if count != self.total_pieces:
            raise ValueError(
                f"record batch of {count} over a {self.total_pieces}-piece "
                "sink")
        if record_bytes > self.piece_size:
            raise ValueError(
                f"record_bytes {record_bytes} exceeds piece size "
                f"{self.piece_size}")
        u8 = self._bytes().view(self.total_pieces, self.piece_size)
        return u8[:, :record_bytes]

    def as_tensor(self, dtype, shape) -> torch.Tensor:
        """The landed bytes from offset 0 as a typed tensor, e.g.
        ``("bfloat16", [8192, 4096])``: a view of the buffer."""
        target = torch_dtype(dtype)
        n = int(np.prod(shape)) if len(shape) else 1
        if target == torch.bool:
            return (self._bytes()[:n] != 0).reshape(shape)
        nbytes = n * target.itemsize
        if nbytes > self.padded_words * 4:
            raise ValueError(f"{nbytes} bytes requested from a "
                             f"{self.padded_words * 4}-byte sink")
        return self._bytes()[:nbytes].view(target).reshape(shape)

    # -- the mesh (parallel/ici.py) ----------------------------------------

    def shard_to_mesh(self, mesh, axis_name: str = "d", *,
                      src: int | None = None):
        """The landed content spread over ``axis_name`` of ``mesh``: the
        rank at coordinate i holds piece-contiguous shard i of the padded
        int32 words (``Shard(0)``), padded up to a multiple of the axis
        size with zero words, never truncated. A collective: with
        ``src=None`` every rank of the axis landed the same content and
        keeps its own shard, a view of its buffer when no padding is
        needed (no transfer); with ``src`` this rank holds the sink and
        scatters it, and every other rank calls
        ``ici.scatter_shards(mesh, None, axis_name, src=src)``."""
        words = self._bytes().view(torch.int32)
        n = ici.axis_size(mesh, axis_name)
        per = -(-self.padded_words // n)
        if per * n != self.padded_words:
            words = torch.cat([words, words.new_zeros(
                per * n - self.padded_words)])
        return ici.scatter_shards(mesh, words, axis_name, src=src)

    def ring_replicate(self, mesh, axis_name: str = "d", n_chunks: int = 4,
                       *, src: int | None = None):
        """The striped broadcast's spread: ``shard_to_mesh``, then the
        chunked ring completes the copy, so every rank of the axis ends
        with the full padded word buffer (a replicated ``DTensor``;
        callers trim or view it)."""
        return ici.chunked_ring_all_gather(
            mesh, self.shard_to_mesh(mesh, axis_name, src=src),
            axis_name=axis_name, n_chunks=n_chunks)


def verify_u8_against_host(u8: torch.Tensor, piece_size: int,
                           host_checksums: "dict[int, tuple[int, int]]") -> None:
    """Verification gate for a buffer about to go live: per-piece
    (sum32, xor32) of the device bytes ``u8`` by K1, compared against
    host-side values. Raises ValueError naming the first mismatching piece.

    Whole pieces are checked in place (no padded copy of the buffer); only
    a short last piece is copied into a zero-padded piece first."""
    if piece_size % 4:
        raise ValueError(f"piece size {piece_size} not 4-byte aligned")
    if u8.dtype != torch.uint8 or u8.dim() != 1:
        raise TypeError("u8 must be a 1-D uint8 tensor")
    total = int(u8.shape[0])
    full = total // piece_size
    parts_s, parts_x = [], []
    if full:
        head = u8[: full * piece_size]
        if head.storage_offset() % 4 or not head.is_contiguous():
            head = head.clone()
        s, x = chunk_checksums(head.view(torch.int32), piece_size // 4)
        parts_s.append(s)
        parts_x.append(x)
    if total % piece_size or total == 0:
        tail = torch.zeros(piece_size, dtype=torch.uint8, device=u8.device)
        tail[: total - full * piece_size] = u8[full * piece_size:]
        s, x = chunk_checksums(tail.view(torch.int32), piece_size // 4)
        parts_s.append(s)
        parts_x.append(x)
    sums = torch.cat(parts_s).cpu().numpy().view(np.uint32)
    xors = torch.cat(parts_x).cpu().numpy().view(np.uint32)
    for num, (want_s, want_x) in sorted(host_checksums.items()):
        have = (int(sums[num]), int(xors[num]))
        if have != (want_s, want_x):
            raise ValueError(
                f"piece {num} corrupt in spare buffer: "
                f"sum {have[0]:#x}!={want_s:#x} "
                f"xor {have[1]:#x}!={want_x:#x}")


# ---------------------------------------------------------------------- #
# Double-buffer hot-swap (the port of ``assemble_delta_u8`` and
# ``DoubleBuffer``, dragonfly2_tpu/ops/hbm_sink.py): the next checkpoint
# generation assembles in a spare buffer while the live one serves, and
# the verified result replaces the live generation in one reference
# assignment.
# ---------------------------------------------------------------------- #

def coalesce_parts(parts) -> list[list]:
    """The copies ``assemble_delta_u8`` queues for ``parts``, in order:
    a run of reused parts that is contiguous in the live buffer becomes
    one ``["r", dst, src, length]`` device-to-device copy, and a run of
    adjacent fetched parts (``"f"`` or ``"s"``) one
    ``["f", dst, [part, ...], length]`` host-to-device copy. (A
    checkpoint shard at the default chunk size has thousands of chunks;
    one copy each would put thousands of launches on the swap.)"""
    runs: list[list] = []
    dst = 0
    for part in parts:
        kind = part[0]
        last = runs[-1] if runs else None
        if kind == "r":
            _, src, n = part
            if src < 0 or n < 0:
                raise ValueError(f"bad reused part {part!r}")
            if last is not None and last[0] == "r" and last[2] + last[3] == src:
                last[3] += n
            else:
                runs.append(["r", dst, src, n])
        elif kind in ("f", "s"):
            if kind == "f":
                n = memoryview(part[1]).nbytes
            else:
                _, off, n = part
                if off < 0 or n < 0:
                    raise ValueError(f"bad store part {part!r}")
            if last is not None and last[0] == "f":
                last[2].append(part)
                last[3] += n
            else:
                runs.append(["f", dst, [part], n])
        else:
            raise ValueError(f"unknown part kind {kind!r}")
        dst += n
    return runs


def _stage_fetched(runs, store, pin: bool) -> torch.Tensor | None:
    """Every fetched byte of ``runs``, in order, in one host buffer
    (pinned for the card): store spans are read straight into it."""
    fetched = sum(r[3] for r in runs if r[0] == "f")
    if not fetched:
        return None
    staging = torch.empty(fetched, dtype=torch.uint8, pin_memory=pin)
    host = staging.numpy()
    at = 0
    for kind, _, items, _ in runs:
        if kind != "f":
            continue
        for part in items:
            if part[0] == "s":
                _, off, n = part
                if store is None:
                    raise ValueError("store parts need a store")
                store.read_into(off, n, memoryview(host[at:at + n]))
            else:
                view = np.frombuffer(part[1], np.uint8)
                n = view.size
                host[at:at + n] = view
            at += n
    return staging


def assemble_delta_u8(live_u8: torch.Tensor | None, parts, *, device=None,
                      store=None, stats: dict | None = None) -> torch.Tensor:
    """The next generation's uint8 content buffer.

    ``parts`` is the new content in offset order, each one of
    ``("r", src_offset, length)``, a reused chunk at its offset in the
    live buffer ``live_u8``; ``("f", data)``, a fetched chunk's host
    bytes; or ``("s", offset, length)``, fetched bytes at ``offset`` of
    ``store`` (anything with ``read_into(offset, length, buf)``), read
    straight into the staging buffer with no copy of their own.

    The buffer is allocated once at its final length on ``device`` (by
    default the live buffer's; without one, ``default_device``). Reused
    bytes are copied device to device and fetched bytes through one host
    staging buffer, pinned on CUDA, after coalescing (``coalesce_parts``).
    The copies are queued on the caller's current stream and the call
    does not wait for them. ``stats``, when given, receives ``copies``,
    the number queued, and on CUDA ``start`` and ``done``: events
    recorded on that stream just before and after the copies (the host
    staging is not inside that window)."""
    if device is None and live_u8 is not None:
        dev = live_u8.device
    else:
        dev = default_device(device)
    runs = coalesce_parts(parts)
    for kind, _, src, n in runs:
        if kind != "r":
            continue
        if live_u8 is None:
            raise ValueError("reused parts need a live buffer")
        if live_u8.device != dev:
            raise ValueError(f"live buffer on {live_u8.device}, assembly on "
                             f"{dev}")
        if src + n > live_u8.numel():
            raise ValueError(
                f"reused span [{src}, {src + n}) outside the "
                f"{live_u8.numel()}-byte live buffer")
    cuda = dev.type == "cuda"
    out = torch.empty(sum(r[3] for r in runs), dtype=torch.uint8, device=dev)
    staging = _stage_fetched(runs, store, pin=cuda)
    timed = cuda and stats is not None
    if timed:
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    pos = 0
    for kind, dst, src, n in runs:
        if kind == "r":
            out[dst:dst + n].copy_(live_u8[src:src + n])
        else:
            out[dst:dst + n].copy_(staging[pos:pos + n], non_blocking=True)
            pos += n
    if stats is not None:
        stats["copies"] = len(runs)
    if timed:
        done = torch.cuda.Event(enable_timing=True)
        done.record(stream)
        stats["start"], stats["done"] = start, done
    return out


class DoubleBuffer:
    """Atomic generation holder for hot-swapped device checkpoints.

    Readers call ``snapshot()`` (or ``tensors()``) and get one complete
    generation: the state is one tuple, replaced in one reference
    assignment, so a flipping writer never exposes a half-updated tensor
    set. Writers assemble and verify the next generation to the side and
    ``flip()`` only after the gate passed; the gate's read-back of its
    checksums to the host orders the flip after the assembly's copies.

    The previous generation's buffer is freed when its last reference
    goes (ordinary refcounting) and its memory returns to PyTorch's
    caching allocator. That is safe for a reader whose work runs on the
    stream the buffer was allocated on (every thread's default stream,
    unless it set another): later reuse of the memory queues behind that
    work. A reader that runs the tensors on a side stream must call
    ``t.record_stream(side_stream)`` on each tensor it uses (or hold its
    snapshot until that stream's work is done), or the allocator may
    hand the memory out again while the side stream still reads it."""

    __slots__ = ("_state",)

    def __init__(self):
        self._state: tuple = (0, None, {})

    @property
    def generation(self) -> int:
        return self._state[0]

    def snapshot(self) -> tuple:
        """(generation, buffer_u8, tensors): one consistent triple."""
        return self._state

    def tensors(self) -> dict:
        return self._state[2]

    def buffer(self):
        return self._state[1]

    def flip(self, buffer, tensors: dict) -> int:
        """Install the next generation. Callers flip only verified
        buffers (``verify_u8_against_host`` or ``HBMSink.verify``)."""
        gen = self._state[0] + 1
        self._state = (gen, buffer, dict(tensors))
        return gen
