"""Piece manager, the origin (back-to-source) piece pipeline: the port's
copy of ``dragonfly2_tpu/daemon/peer/piece_manager.py``.

``download_source`` picks one of three paths: a known length at or above
``concurrent_min_length`` from an origin with byte ranges runs as
contiguous piece groups on concurrent ranged streams; any other known
length streams sequentially; an unknown length streams to EOF. Wire
chunks are carved into pieces as memoryview windows (no assembly buffer)
and each piece lands through ``write_piece_chunks`` with its CRC-32C fused
into the write, on a worker thread, while the next piece arrives. Origin
failures marked temporary are retried under ``pkg/retry``'s SOURCE policy;
pieces already landed are skipped. ``import_file`` lands a local file as a
task; ``validate_content`` checks the whole-content digest.

Each origin piece landed stamps the task's flight (``pkg/flight.for_task``)
with ``EV_SOURCE_LANDED``, its receive and write time in float ms.

The JAX package's native span fetch (socket to crc32c to pwrite in its
native library) is not ported: every origin byte rides the Python
streaming path here.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass
from typing import Awaitable, Callable

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg import flight as flightlib
from dragonfly2_tpu_torch.pkg import retry as retrylib
from dragonfly2_tpu_torch.pkg.errors import Code, SourceError
from dragonfly2_tpu_torch.pkg.piece import (
    Range,
    compute_piece_count,
    compute_piece_size,
)
from dragonfly2_tpu_torch.pkg.ratelimit import Limiter
from dragonfly2_tpu_torch.source import Request as SourceRequest
from dragonfly2_tpu_torch.source import get_client
from dragonfly2_tpu_torch.storage.local_store import (
    LocalTaskStore,
    PieceRecord,
    acquire_read_buffer,
    release_read_buffer,
)

log = dflog.get("peer.piece_manager")

# Fired after each piece lands in storage, with the store and the record
# (the task manager publishes it and lands it in the device sink).
PieceCallback = Callable[[LocalTaskStore, PieceRecord], Awaitable[None]]


@dataclass
class PieceManagerOption:
    concurrency: int = 4                  # concurrent range streams to origin
    concurrent_min_length: int = 32 << 20 # below this, a single stream wins
    # Origin fetch retry budget: attempts for TEMPORARY failures only
    # (connect resets, 5xx, short reads). Permanent client errors
    # (403/404/416 — SourceError.temporary=False) fail on the first try:
    # re-asking the origin for a URL it authoritatively rejected can never
    # succeed, it only delays the task's failure verdict.
    origin_attempts: int = 3
    # Origin body chunk-gap watchdog (pkg/retry.watch_idle): bounds the
    # silence between chunks so a stalled origin trips in bounded time
    # instead of at the 300s request deadline. <= 0 disables.
    origin_idle_timeout: float = 60.0


class PieceManager:
    def __init__(self, opt: PieceManagerOption | None = None, limiter: Limiter | None = None):
        self.opt = opt or PieceManagerOption()
        self._limiter = limiter or Limiter()
        # Seconds spent waiting for origin chunks, and landing pieces in
        # the store (CRC-32C fused into the write), summed over every
        # stream: concurrent piece groups overlap, so either sum can
        # exceed the wall time of a download.
        self.timings = {"origin_wait_s": 0.0, "store_write_s": 0.0}

    @property
    def limiter(self) -> Limiter:
        """The daemon's download limiter (a P2P pull's conductor shares
        it)."""
        return self._limiter

    async def _timed(self, body):
        """``body``'s chunks, the time spent waiting for each counted."""
        t = time.perf_counter()
        async for chunk in body:
            self.timings["origin_wait_s"] += time.perf_counter() - t
            yield chunk
            t = time.perf_counter()

    # -- origin download entry (reference piece_manager.go:304) ------------

    async def download_source(
        self,
        store: LocalTaskStore,
        url: str,
        header: dict[str, str] | None = None,
        *,
        content_range: Range | None = None,
        on_piece: PieceCallback | None = None,
        limiter: Limiter | None = None,
    ) -> None:
        """Fetch the full content from origin into ``store``. Decides between
        sequential, concurrent-range-group and unknown-length paths."""
        client = get_client(url)
        header = dict(header or {})
        header.pop("Range", None)
        request = SourceRequest(url, header)
        limiter = limiter or self._limiter

        content_length = store.metadata.content_length
        range_known: bool | None = None
        if content_length < 0:
            try:
                content_length, range_known = await client.probe(request)
            except SourceError:
                content_length = -1
        if content_range is not None:
            # Ranged task: treat the range as the content.
            total = content_length if content_length >= 0 else -1
            if total >= 0:
                if content_range.start >= total:
                    raise SourceError(f"range start {content_range.start} beyond length {total}",
                                      Code.BadRequest)
                length = min(content_range.length, total - content_range.start) \
                    if content_range.length >= 0 else total - content_range.start
            else:
                length = content_range.length
            content_length = length

        if content_length is not None and content_length >= 0:
            piece_size = store.metadata.piece_size or compute_piece_size(content_length)
            total_pieces = compute_piece_count(content_length, piece_size)
            store.update_task(content_length=content_length, piece_size=piece_size,
                              total_piece_count=total_pieces)
            support_range = False
            if content_length >= self.opt.concurrent_min_length and self.opt.concurrency > 1:
                if range_known is not None:
                    support_range = range_known  # answered by the same probe
                else:
                    try:
                        support_range = await client.is_support_range(request)
                    except SourceError:
                        support_range = False
            if support_range:
                fetch = lambda: self._download_known_length_concurrent(  # noqa: E731
                    store, client, request, content_range, on_piece, limiter)
            else:
                fetch = lambda: self._download_streaming(  # noqa: E731
                    store, client, request, content_range, on_piece, limiter,
                    known_length=content_length)
        else:
            if store.metadata.piece_size <= 0:
                store.update_task(piece_size=compute_piece_size(-1))
            fetch = lambda: self._download_streaming(  # noqa: E731
                store, client, request, content_range, on_piece, limiter,
                known_length=-1)

        # Origin retry rides the ONE policy module (capped exponential,
        # full jitter) and retries TEMPORARY failures only: a 5xx burst or
        # a dropped stream earns another attempt (landed pieces are
        # skipped on resume), a permanent 403/404/416 fails immediately.
        await retrylib.run(
            fetch, policy=retrylib.SOURCE,
            max_attempts=max(1, self.opt.origin_attempts),
            retryable=lambda e: isinstance(e, SourceError) and e.temporary)

        if not store.is_complete():
            raise SourceError(
                f"source download incomplete: {len(store.metadata.pieces)}/"
                f"{store.metadata.total_piece_count} pieces", Code.BackToSourceAborted)

    # -- sequential / unknown-length (reference :481,:539) -----------------

    async def _download_streaming(
        self,
        store: LocalTaskStore,
        client,
        request: SourceRequest,
        content_range: Range | None,
        on_piece: PieceCallback | None,
        limiter: Limiter,
        known_length: int,
    ) -> None:
        req = request
        if content_range is not None:
            req = request.with_range(content_range.to_http())
        resp = await client.download(req)
        piece_size = store.metadata.piece_size
        num = 0
        total = 0
        # Zero-copy carve: piece boundaries are memoryview windows over the
        # wire chunks exactly as they arrived — no assembly bytearray, no
        # bytes() copy, no O(piece) del-memmove. The store lands each
        # window list with the per-piece digest FUSED into the write
        # (write_piece_chunks: seeded crc while pwriting — one memory walk
        # for hash+write; digest_reader.go single-pass parity).
        views: list[memoryview] = []
        filled = 0
        start = time.monotonic()
        # Depth-1 landing pipeline: piece N's write+digest runs in a worker
        # thread (GIL released in the native crc+pwrite and the sha feed)
        # WHILE the loop receives piece N+1's chunks — wall becomes
        # max(receive, hash+write) instead of their sum on a busy core.
        # Exactly one landing is in flight, awaited before the next
        # launches, so commits (and the prefix-hasher's in-memory frontier
        # feed) stay in piece order.
        pending: "asyncio.Future | None" = None
        body = self._timed(retrylib.watch_idle(
            resp.body, self.opt.origin_idle_timeout,
            what=f"origin {request.url[:96]}"))
        try:
            try:
                async for chunk in body:
                    total += len(chunk)
                    cv = memoryview(chunk)
                    while len(cv):
                        take = min(piece_size - filled, len(cv))
                        views.append(cv[:take])
                        cv = cv[take:]
                        filled += take
                        if filled == piece_size:
                            if pending is not None:
                                await pending
                            pending = asyncio.ensure_future(
                                self._land_piece_chunks(
                                    store, num, views, piece_size,
                                    on_piece, limiter, start))
                            num += 1
                            views, filled = [], 0
                            start = time.monotonic()
                if pending is not None:
                    await pending
                    pending = None
            except BaseException:
                if pending is not None:
                    pending.cancel()
                    await asyncio.gather(pending, return_exceptions=True)
                raise
        except retrylib.ProgressTimeout as e:
            # Stalled origin (slow-loris): temporary — the retry policy
            # may try again; landed pieces are skipped on resume.
            raise SourceError(str(e), Code.BackToSourceAborted,
                              temporary=True)
        finally:
            await resp.close()
        # Length check BEFORE the trailing partial piece lands: a dropped
        # connection must never persist a truncated piece in metadata.
        if known_length >= 0 and total != known_length:
            raise SourceError(f"origin returned {total} bytes, expected {known_length}",
                              Code.BackToSourceAborted, temporary=True)
        if views:
            await self._land_piece_chunks(
                store, num, views, filled, on_piece, limiter, start)
            num += 1
        if known_length < 0:
            # Learned the length at EOF (reference downloadUnknownLengthSource
            # finishes by updating task metadata).
            store.update_task(content_length=total, total_piece_count=num)

    # -- concurrent piece groups (reference :796-1000) ---------------------

    async def _download_known_length_concurrent(
        self,
        store: LocalTaskStore,
        client,
        request: SourceRequest,
        content_range: Range | None,
        on_piece: PieceCallback | None,
        limiter: Limiter,
    ) -> None:
        m = store.metadata
        total_pieces = m.total_piece_count
        # Resume: never re-fetch the contiguous landed prefix (reference
        # continuePieceNum, piece_manager.go:804-815 — groups start at the
        # first missing piece; mid-range holes still stream-and-drain
        # inside their group, matching the reference).
        continue_piece = 0
        while continue_piece < total_pieces and store.has_piece(continue_piece):
            continue_piece += 1
        to_download = total_pieces - continue_piece
        if to_download <= 0:
            return
        concurrency = min(self.opt.concurrency, to_download)
        # Contiguous piece groups (reference pieceGroup :876-922): group g
        # covers pieces [g*per + min(g, rem) ... ), sizes differ by ≤1.
        per, rem = divmod(to_download, concurrency)
        groups: list[tuple[int, int]] = []
        start_piece = continue_piece
        for g in range(concurrency):
            count = per + (1 if g < rem else 0)
            groups.append((start_piece, start_piece + count))
            start_piece += count

        base_offset = content_range.start if content_range is not None else 0

        async def fetch_group(first: int, last: int) -> None:
            byte_start = base_offset + first * m.piece_size
            byte_len = min(last * m.piece_size, m.content_length) - first * m.piece_size
            req = request.with_range(Range(byte_start, byte_len).to_http())
            resp = await client.download(req)
            if resp.status != 206:
                await resp.close()
                raise SourceError("origin ignored range request",
                                  Code.SourceRangeUnsupported, temporary=True)
            num = first
            got = 0
            # Same zero-copy carve as the sequential path; the group's
            # LAST piece accumulates to EOF (its size is the range
            # remainder) and lands only after the length check below.
            views: list[memoryview] = []
            filled = 0
            t0 = time.monotonic()
            # Depth-1 landing pipeline per group (see _download_streaming).
            pending: "asyncio.Future | None" = None
            body = self._timed(retrylib.watch_idle(
                resp.body, self.opt.origin_idle_timeout,
                what=f"origin group [{first},{last}) {request.url[:96]}"))
            try:
                try:
                    async for chunk in body:
                        got += len(chunk)
                        cv = memoryview(chunk)
                        while len(cv):
                            if num >= last - 1:
                                views.append(cv)
                                filled += len(cv)
                                break
                            take = min(m.piece_size - filled, len(cv))
                            views.append(cv[:take])
                            cv = cv[take:]
                            filled += take
                            if filled == m.piece_size:
                                if pending is not None:
                                    await pending
                                pending = asyncio.ensure_future(
                                    self._land_piece_chunks(
                                        store, num, views, m.piece_size,
                                        on_piece, limiter, t0))
                                num += 1
                                views, filled = [], 0
                                t0 = time.monotonic()
                    if pending is not None:
                        await pending
                        pending = None
                except BaseException:
                    if pending is not None:
                        pending.cancel()
                        await asyncio.gather(pending, return_exceptions=True)
                    raise
            except retrylib.ProgressTimeout as e:
                raise SourceError(str(e), Code.BackToSourceAborted,
                                  temporary=True)
            finally:
                await resp.close()
            # Length check first — a short stream must not persist its
            # trailing buffer as a (truncated) piece.
            if got != byte_len:
                raise SourceError(f"group [{first},{last}) got {got} bytes, want {byte_len}",
                                  Code.BackToSourceAborted, temporary=True)
            if views:
                await self._land_piece_chunks(
                    store, num, views, filled, on_piece, limiter, t0)
                num += 1

        results = await asyncio.gather(
            *(fetch_group(f, l) for f, l in groups), return_exceptions=True
        )
        errors = [r for r in results if isinstance(r, BaseException)]
        if errors:
            raise errors[0]

    # -- shared piece writer -----------------------------------------------

    async def _land_piece_chunks(
        self,
        store: LocalTaskStore,
        num: int,
        views: list,
        size: int,
        on_piece: PieceCallback | None,
        limiter: Limiter,
        started_at: float,
    ) -> None:
        """Land a carved piece: one write_piece_chunks call (digest fused
        into the write) — off-loop, because it still blocks on disk."""
        await limiter.wait(size)
        cost_ms = int((time.monotonic() - started_at) * 1000)
        if store.has_piece(num):
            return   # resume overlap: bytes already verified on disk
        t0 = time.perf_counter()
        rec = await asyncio.to_thread(
            store.write_piece_chunks, num, views, cost_ms=cost_ms)
        self.timings["store_write_s"] += time.perf_counter() - t0
        # Float ms: a sub-ms loopback piece must not collapse to a
        # zero-length origin interval in the fold.
        flightlib.for_task(store.metadata.task_id).record(
            flightlib.EV_SOURCE_LANDED, num,
            (time.monotonic() - started_at) * 1000.0)
        if on_piece is not None:
            await on_piece(store, rec)

    async def _write_piece(
        self,
        store: LocalTaskStore,
        num: int,
        data: bytes,
        on_piece: PieceCallback | None,
        limiter: Limiter,
        started_at: float,
    ) -> None:
        await limiter.wait(len(data))
        cost_ms = int((time.monotonic() - started_at) * 1000)
        if store.has_piece(num):
            return
        # Off the loop: the fused crc + pwrite releases the interpreter lock.
        rec = await asyncio.to_thread(store.write_piece, num, data,
                                      cost_ms=cost_ms)
        if on_piece is not None:
            await on_piece(store, rec)

    # -- file import (dfcache; reference :662 ImportFile) -------------------

    async def import_file(self, store: LocalTaskStore, path: str,
                          on_piece: PieceCallback | None = None) -> None:
        size = os.path.getsize(path)
        piece_size = store.metadata.piece_size or compute_piece_size(size)
        total = compute_piece_count(size, piece_size)
        store.update_task(content_length=size, piece_size=piece_size, total_piece_count=total)
        # One pooled buffer for the whole import (pieces land sequentially,
        # the write digests+lands from the view before the next readinto).
        buf = acquire_read_buffer(piece_size)
        try:
            with open(path, "rb") as f:
                for num in range(total):
                    n = await asyncio.to_thread(f.readinto, buf)
                    t0 = time.monotonic()
                    await self._write_piece(store, num, buf[:n], on_piece,
                                            self._limiter, t0)
        finally:
            release_read_buffer(buf)

    # -- whole-content digest ----------------------------------------------

    @staticmethod
    def validate_content(store: LocalTaskStore, expected_digest: str = "") -> str:
        return store.validate_digest(expected_digest)
