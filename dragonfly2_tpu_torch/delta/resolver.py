"""The delta plane's resolver: the port's own copy of
``dragonfly2_tpu/delta/resolver.py``.

A new version's chunk is reused when a chunk of the same sha256 and
length exists anywhere in the base version, and fetched otherwise
(``plan_delta``). The device hot-swap (``client/device.py``) copies reused
chunks out of the live device buffer and stages only the fetched ones
from the host.

Manifests travel over the fabric as ``dfdelta://<content_task_id>``
tasks. The manifest task's id is a pure function of the content task id,
so the port builds the same request as the JAX package, or every fetch
misses. A host that holds the content builds and publishes its manifest
(``publish_manifest_for``).

``run_delta_task`` is the daemon's delta landing engine
(``TaskManager.start_delta_task``): with version N landed here and
version N+1's manifest published, the new task's pieces are assembled in
offset order from base chunks read out of the local store (each checked
against its sha256 as it is copied) and from fetched spans, pulled as
ranged tasks (``dataset/shard_reader.DaemonRangeFetcher``) whose task ids
agree across every host running the same delta. The base's manifest,
when none was published, is built from the base store on ``device``
(``manifest_from_store``: K3 on the card) and published. The result is an
ordinary task: piece-structured, digest-checked, announced, resumable.

Every content byte is booked once, as ``reused`` or ``fetched``
(``peer_delta_bytes_total{kind}``, and ``TaskManager.delta_stats``); a
base chunk that fails its sha256 is re-fetched as its own ranged task and
booked ``fetched`` with a ``corrupt_base`` count. The task's flight
records each chunk (``EV_DELTA_REUSE`` / ``EV_DELTA_FETCH``, its ms and
length) and is finished on every terminal path; a landed delta is
announced over PEX. ``tm`` is a task manager with ``storage``, ``broker``,
``flight``, ``start_file_task``, ``import_task`` and the port
``TaskManager``'s helpers.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import os
import time
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.daemon.peer.broker import PieceEvent
from dragonfly2_tpu_torch.daemon.peer.task_manager import (
    FileTaskProgress,
    FileTaskRequest,
    TaskStoreMetadata,
    _RunningTask,
)
from dragonfly2_tpu_torch.dataset.shard_reader import DaemonRangeFetcher
from dragonfly2_tpu_torch.delta.manifest import (
    MANIFEST_FETCHES,
    CDCParams,
    Chunk,
    DeltaManifest,
    ManifestError,
    manifest_from_store,
)
from dragonfly2_tpu_torch.pkg import dflog, idgen, metrics
from dragonfly2_tpu_torch.pkg import flight as flightlib
from dragonfly2_tpu_torch.pkg.errors import Code, DfError, StorageError, describe
from dragonfly2_tpu_torch.pkg.piece import compute_piece_count, compute_piece_size
from dragonfly2_tpu_torch.proto.common import UrlMeta
from dragonfly2_tpu_torch.storage.local_store import (
    acquire_read_buffer,
    release_read_buffer,
)

log = dflog.get("delta.resolver")

# Every content byte of a delta task lands as exactly one of these.
DELTA_BYTES = metrics.counter(
    "peer_delta_bytes_total",
    "Delta-task content bytes by transfer class (reused = copied from "
    "the local base version, fetched = pulled as ranged P2P tasks); the "
    "two sum exactly to the task's content length", ("kind",))
DELTA_CHUNKS = metrics.counter(
    "peer_delta_chunks_total",
    "Delta-task chunks by resolution (corrupt_base = base copy failed "
    "its digest during the copy and was transparently re-fetched)",
    ("result",))

MANIFEST_SCHEME = "dfdelta"
MANIFEST_TAG = "dfdelta-manifest"


def manifest_url(content_task_id: str) -> str:
    return f"{MANIFEST_SCHEME}://{content_task_id}"


@dataclass
class DeltaPlan:
    """Partition of the new version's chunks against a base manifest."""

    reused: list[tuple[Chunk, Chunk]] = field(default_factory=list)  # (new, base)
    fetched: list[Chunk] = field(default_factory=list)

    @property
    def reused_bytes(self) -> int:
        return sum(c.length for c, _ in self.reused)

    @property
    def fetched_bytes(self) -> int:
        return sum(c.length for c in self.fetched)

    def fetch_spans(self) -> list[tuple[int, int]]:
        """Adjacent fetched chunks merged into spans (zero-gap merges
        only: a gap byte is a reused byte)."""
        spans: list[list[int]] = []
        for c in self.fetched:
            if spans and c.offset == spans[-1][1]:
                spans[-1][1] = c.end
            else:
                spans.append([c.offset, c.end])
        return [(s, e) for s, e in spans]


def plan_delta(new_m: DeltaManifest, base_m: DeltaManifest) -> DeltaPlan:
    """A new chunk whose (sha256, length) appears anywhere in the base is
    reused from there; every other chunk is fetched. Both manifests must
    share chunking params."""
    if new_m.params != base_m.params:
        raise ManifestError(
            f"chunking params differ: {new_m.params} vs {base_m.params}")
    base_map = base_m.digest_map()
    plan = DeltaPlan()
    for c in new_m.chunks:
        b = base_map.get(c.sha256)
        if b is not None and b.length == c.length:
            plan.reused.append((c, b))
        else:
            plan.fetched.append(c)
    return plan


def manifest_request(content_task_id: str) -> FileTaskRequest:
    """The request for a content task's published manifest. A
    ``dfdelta://`` task has no origin: it exists in the fabric or not."""
    return FileTaskRequest(url=manifest_url(content_task_id), output="",
                           meta=UrlMeta(tag=MANIFEST_TAG),
                           disable_back_source=True)


async def fetch_manifest(tm, content_task_id: str,
                         timeout: float = 8.0) -> DeltaManifest | None:
    """Pull the fabric-published manifest of a content task through the
    daemon's task manager ``tm``; None when no host published one. The
    timeout is short on purpose: an unpublished manifest would cost the
    scheduler's full no-source patience, and every miss has a cheap
    recovery (chunk a landed base here, or stage the whole buffer)."""
    req = manifest_request(content_task_id)

    async def drain():
        final = None
        async for p in tm.start_file_task(req):
            if p.state == "failed":
                return None
            if p.state == "done":
                final = p
        return final

    try:
        final = await asyncio.wait_for(drain(), timeout)
    except (DfError, asyncio.TimeoutError):
        final = None
    if final is None:
        MANIFEST_FETCHES.labels("miss").inc()
        return None
    store = tm.storage.find_completed_task(final.task_id)
    if store is None:
        return None
    n = store.metadata.content_length
    buf = bytearray(n)
    try:
        with store:
            await asyncio.to_thread(store.read_into, 0, n, buf)
        m = DeltaManifest.from_json_bytes(buf)
    except ManifestError as e:
        log.warning("fabric manifest corrupt; ignoring",
                    task=content_task_id[:16], error=str(e)[:200])
        MANIFEST_FETCHES.labels("corrupt").inc()
        return None
    MANIFEST_FETCHES.labels("hit").inc()
    return m


async def publish_manifest_for(tm, content_task_id: str, *,
                               params: CDCParams | None = None,
                               manifest: DeltaManifest | None = None,
                               device=None) -> DeltaManifest | None:
    """Build the manifest of this host's completed copy of a content task
    (scanned on ``device``), or take the prebuilt ``manifest``, and import
    it as the ``dfdelta://`` task, announced like any import so peers can
    pull it. An already-published manifest task is left as it is. Returns
    the manifest, or None when the content is not landed here.

    ``tm`` is the daemon's task manager: ``storage.find_completed_task``,
    ``storage.opt.data_dir`` and ``import_task``."""
    store = tm.storage.find_completed_task(content_task_id)
    if store is None:
        log.warning("cannot publish manifest: content not landed",
                    task=content_task_id[:16])
        return None
    m = manifest
    if m is None:
        m = await asyncio.to_thread(manifest_from_store, store,
                                    store.metadata.url, params,
                                    device=device)
    req = manifest_request(content_task_id)
    if tm.storage.find_completed_task(req.task_id()) is not None:
        MANIFEST_FETCHES.labels("published").inc()
        return m
    path = os.path.join(tm.storage.opt.data_dir,
                        f".manifest-{content_task_id[:16]}.json")
    try:
        await asyncio.to_thread(_write_file, path, m.to_json_bytes())
        await tm.import_task(path, req)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    MANIFEST_FETCHES.labels("published").inc()
    return m


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


# ------------------------------------------------------------------ #
# The delta landing engine
# ------------------------------------------------------------------ #

# Ranged span tasks a delta download runs at once.
SPAN_FETCHES = 4


class _SpanFetches:
    """The fetch spans pulled as ranged tasks, ``SPAN_FETCHES`` at a time,
    each span's buffer released after the last chunk that reads it."""

    def __init__(self, fetcher, spans: list[tuple[int, int]],
                 consumers: dict[tuple[int, int], int]):
        self.fetcher = fetcher
        self._bufs: dict[tuple[int, int], memoryview] = {}
        self._remaining = dict(consumers)
        self._sem = asyncio.Semaphore(SPAN_FETCHES)
        self._tasks = {
            span: asyncio.ensure_future(self._pull(span)) for span in spans}

    async def _pull(self, span: tuple[int, int]) -> memoryview:
        s, e = span
        buf = acquire_read_buffer(e - s)
        try:
            async with self._sem:
                await self.fetcher.fetch_into(s, e, buf[:e - s])
        except BaseException:
            release_read_buffer(buf)
            raise
        self._bufs[span] = buf
        return buf

    async def view(self, span: tuple[int, int]) -> memoryview:
        buf = await self._tasks[span]
        s, e = span
        return buf[:e - s]

    def consumed(self, span: tuple[int, int]) -> None:
        self._remaining[span] -= 1
        if self._remaining[span] <= 0:
            buf = self._bufs.pop(span, None)
            if buf is not None:
                release_read_buffer(buf)

    async def close(self) -> None:
        for t in self._tasks.values():
            t.cancel()
        await asyncio.gather(*self._tasks.values(), return_exceptions=True)
        for buf in self._bufs.values():
            release_read_buffer(buf)
        self._bufs.clear()


def _range_fetcher(tm, req) -> DaemonRangeFetcher:
    """The ranged-task fetcher of the delta's spans: the request's tag,
    application and header ride along, so that span task ids agree across
    hosts; the whole-content digest cannot name a slice and is dropped."""
    return DaemonRangeFetcher(
        tm, req.url, tag=req.meta.tag, application=req.meta.application,
        header=dict(req.meta.header), pod_broadcast=req.pod_broadcast)


async def _resolve_manifests(tm, task_id: str, base_store, *, device,
                             timings: dict):
    """(new_manifest, base_manifest), or None when the new version has no
    published manifest. A missing or mismatched base manifest is built
    from the base store on ``device`` and published, best effort."""
    new_m = await fetch_manifest(tm, task_id)
    if new_m is None:
        return None
    want = new_m.params
    base_id = base_store.metadata.task_id
    base_m = await fetch_manifest(tm, base_id)
    if (base_m is None or base_m.params != want
            or base_m.content_length != base_store.metadata.content_length):
        t0 = time.perf_counter()
        base_m = await asyncio.to_thread(
            manifest_from_store, base_store, base_store.metadata.url, want,
            device=device)
        timings["base_manifest_s"] = time.perf_counter() - t0
        # The next host deltaing from this base then fetches the manifest.
        try:
            await publish_manifest_for(tm, base_id, manifest=base_m)
        except Exception as e:
            log.warning("base manifest publish failed (non-fatal)",
                        base=base_id[:16], error=describe(e))
    return new_m, base_m


async def run_delta_task(tm, req, base_task_id: str, *, device=None):
    """Drive one delta download on the task manager ``tm``; yields
    ``FileTaskProgress`` frames as ``start_file_task`` does.

    Every rung lands the bytes:

    1. a completed or running task: reuse or dedup through
       ``start_file_task``;
    2. no landed base, no published manifest of the new version, or no
       chunk in common: a full download, after which this host publishes
       the new version's manifest (best effort);
    3. the delta proper, where a base chunk that fails its sha256 while
       it is copied is re-fetched as a ranged task (``corrupt_base``).

    ``device``: where a manifest this host builds is scanned, the base's
    when none was published or the new version's after a full download
    (``default_device``: the card unless the caller asks for the
    CPU)."""
    task_id = req.task_id()

    async def fallback(publish: bool):
        ok = False
        async for p in tm.start_file_task(req):
            if p.state == "done":
                ok = True
            yield p
        if ok and publish:
            try:
                await publish_manifest_for(tm, task_id, device=device)
            except Exception as e:     # best effort: the task stands
                log.warning("manifest publish after full landing failed",
                            task=task_id[:16], error=describe(e))

    if (tm.storage.find_completed_task(task_id) is not None
            or tm.is_task_running(task_id)):
        async for p in fallback(publish=False):
            yield p
        return

    base_store = tm.storage.find_completed_task(base_task_id)
    if base_store is None:
        log.info("delta base not landed; full download",
                 task=task_id[:16], base=base_task_id[:16])
        async for p in fallback(publish=True):
            yield p
        return
    timings: dict = {}
    t0 = time.perf_counter()
    manifests = await _resolve_manifests(tm, task_id, base_store,
                                         device=device, timings=timings)
    timings["resolve_s"] = time.perf_counter() - t0
    if manifests is None:
        log.info("no published manifest; full download + publish",
                 task=task_id[:16])
        async for p in fallback(publish=True):
            yield p
        return
    new_m, base_m = manifests
    plan = plan_delta(new_m, base_m)
    if plan.reused_bytes == 0:
        log.info("zero chunk overlap with base; full download",
                 task=task_id[:16], base=base_task_id[:16])
        async for p in fallback(publish=True):
            yield p
        return

    async with contextlib.aclosing(_run_delta(
            tm, req, task_id, base_store, new_m, plan, timings)) as it:
        async for p in it:
            yield p


async def _run_delta(tm, req, task_id: str, base_store,
                     new_m: DeltaManifest, plan: DeltaPlan, timings: dict):
    peer_id = req.peer_id or idgen.peer_id_v1(tm.host_ip)
    store = tm.storage.register_task(TaskStoreMetadata(
        task_id=task_id, peer_id=peer_id, url=req.url, tag=req.meta.tag,
        application=req.meta.application, header=dict(req.meta.header)))
    run = _RunningTask(store)
    tm._running[task_id] = run
    store.pin()
    base_store.pin()
    fetches: _SpanFetches | None = None
    stats = {"reused_bytes": 0, "fetched_bytes": 0, "chunks_reused": 0,
             "chunks_fetched": 0, "corrupt_base": 0,
             "chunks_total": new_m.num_chunks,
             "content_length": new_m.content_length}
    log.info("delta landing", task=task_id[:16],
             base=base_store.metadata.task_id[:16],
             chunks=new_m.num_chunks, reuse_frac=round(
                 plan.reused_bytes / max(1, new_m.content_length), 4))
    try:
        tf = tm.flight.task(task_id)
        fetcher = _range_fetcher(tm, req)
        spans = plan.fetch_spans()
        consumers: dict[tuple[int, int], int] = {}
        span_of: dict[int, tuple[int, int]] = {}
        si = 0
        for c in plan.fetched:
            while si < len(spans) and spans[si][1] <= c.offset:
                si += 1
            span_of[c.offset] = spans[si]
            consumers[spans[si]] = consumers.get(spans[si], 0) + 1
        fetches = _SpanFetches(fetcher, spans, consumers)

        async with contextlib.aclosing(_assemble(
                tm, req, store, base_store, new_m, plan, fetches, span_of,
                fetcher, stats, timings, peer_id, tf)) as it:
            async for p in it:
                yield p
    except DfError as e:
        _fail(tm, store, run, task_id, e)
        yield _failed_progress(task_id, peer_id, run.error)
        return
    except Exception as e:
        log.error("delta task crashed", exc_info=True)
        _fail(tm, store, run, task_id, DfError(Code.UnknownError, describe(e)))
        yield _failed_progress(task_id, peer_id, run.error)
        return
    finally:
        if fetches is not None:
            await fetches.close()
        base_store.unpin()
        store.unpin()
        if run.error is None and not store.metadata.done:
            # Closed early (a client gone). The landed pieces are checked
            # chunk copies, so the store stays for a resume; waiters see
            # the end all the same.
            run.error = DfError(Code.ClientContextCanceled,
                                "delta download aborted by client")
            tm.flight.finish_task(task_id, "failed", note=str(run.error))
            tm.broker.publish(task_id, PieceEvent([], failed=True))
        run.done.set()
        tm._running.pop(task_id, None)


def _fail(tm, store, run, task_id: str, err: DfError) -> None:
    store.mark_invalid()
    run.error = err
    tm.flight.finish_task(task_id, "failed", note=str(err))
    tm.broker.publish(task_id, PieceEvent([], failed=True))


def _failed_progress(task_id: str, peer_id: str, err: DfError):
    return FileTaskProgress(state="failed", task_id=task_id,
                            peer_id=peer_id, error=err.to_wire())


def _bounded_put(book: dict, task_id: str, value: dict) -> None:
    if len(book) > 256:
        book.clear()
    book[task_id] = value


async def _assemble(tm, req, store, base_store, new_m: DeltaManifest,
                    plan: DeltaPlan, fetches: _SpanFetches, span_of: dict,
                    fetcher, stats: dict, timings: dict, peer_id: str, tf):
    """Walk the new manifest in offset order, each chunk (a checked local
    copy or a slice of its fetched span) cut into piece writes on the new
    store; then finish as a downloaded task does."""
    t_start = time.perf_counter()
    for key in ("base_read_s", "sha256_s", "span_wait_s", "store_write_s"):
        timings[key] = 0.0
    total = new_m.content_length
    piece_size = store.metadata.piece_size or compute_piece_size(total)
    store.update_task(content_length=total, piece_size=piece_size,
                      total_piece_count=compute_piece_count(
                          total, piece_size))
    base_of = {c.offset: b for c, b in plan.reused}

    piece_buf = acquire_read_buffer(piece_size)
    chunk_buf = acquire_read_buffer(new_m.params.max_size)
    last_progress = 0.0
    try:
        piece_num = 0
        piece_fill = 0
        pos = 0                          # the absolute content position
        for c in new_m.chunks:
            view = await _chunk_bytes(c, base_of, base_store, fetches,
                                      span_of, fetcher, chunk_buf, stats,
                                      timings, tf)
            # The chunk into the piece grid (a chunk can straddle pieces
            # and a piece chunks).
            off = 0
            while off < c.length:
                take = min(c.length - off, piece_size - piece_fill)
                piece_buf[piece_fill:piece_fill + take] = \
                    view[off:off + take]
                piece_fill += take
                off += take
                pos += take
                if piece_fill == piece_size or pos == total:
                    if not store.has_piece(piece_num):   # a resume skips
                        t0 = time.perf_counter()
                        await asyncio.to_thread(
                            store.write_piece, piece_num,
                            piece_buf[:piece_fill])
                        timings["store_write_s"] += time.perf_counter() - t0
                    store.touch()
                    piece_num += 1
                    piece_fill = 0
            if c.offset in span_of:
                fetches.consumed(span_of[c.offset])
            now = time.monotonic()
            if now - last_progress >= 0.1:
                last_progress = now
                yield FileTaskProgress(
                    state="running", task_id=store.metadata.task_id,
                    peer_id=peer_id, content_length=total,
                    completed_length=store.downloaded_bytes(),
                    piece_count=len(store.metadata.pieces),
                    total_piece_count=store.metadata.total_piece_count)
    finally:
        release_read_buffer(piece_buf)
        release_read_buffer(chunk_buf)
    timings["assemble_s"] = time.perf_counter() - t_start

    # The exact accounting, before anything is announced.
    booked = stats["reused_bytes"] + stats["fetched_bytes"]
    if booked != total:
        raise DfError(Code.UnknownError,
                      f"delta accounting drift: {booked} != {total}")
    t0 = time.perf_counter()
    task_id = store.metadata.task_id
    await tm._finalize_content_digest(req, store)
    store.mark_done()
    tm.flight.finish_task(task_id, "done")
    tm._pex_announce(task_id)
    # Announced like an import: no conductor registered the task, and
    # peers must be able to pull it from here.
    await tm._announce_local_task(store, task_id, peer_id)
    _bounded_put(tm.delta_stats, task_id, dict(stats))
    tm.broker.publish(task_id, PieceEvent(
        [], store.metadata.total_piece_count, total,
        store.metadata.piece_size, done=True))
    if req.output:
        with store:
            await asyncio.to_thread(store.store_to, req.output)
    device_verified = False
    if req.device == "tpu":
        device_verified = await tm._finalize_device(req, task_id, store)
    timings["finalize_s"] = time.perf_counter() - t0
    _bounded_put(tm.delta_timings, task_id, dict(timings))
    log.info("delta landed", task=task_id[:16],
             reused_mb=round(stats["reused_bytes"] / 1e6, 2),
             fetched_mb=round(stats["fetched_bytes"] / 1e6, 2),
             corrupt_base=stats["corrupt_base"])
    yield tm._final_progress(store, task_id, peer_id,
                             device_verified=device_verified)


def _book(stats: dict, kind: str, length: int) -> None:
    stats[f"{kind}_bytes"] += length
    stats[f"chunks_{kind}"] += 1
    DELTA_BYTES.labels(kind).inc(length)
    DELTA_CHUNKS.labels(kind).inc()


async def _sha256(view, timings: dict) -> str:
    t0 = time.perf_counter()
    digest = await asyncio.to_thread(lambda: hashlib.sha256(view).hexdigest())
    timings["sha256_s"] += time.perf_counter() - t0
    return digest


async def _chunk_bytes(c: Chunk, base_of: dict, base_store,
                       fetches: _SpanFetches, span_of: dict, fetcher,
                       chunk_buf, stats: dict, timings: dict,
                       tf) -> memoryview:
    """One chunk's checked bytes: a copy out of the base (its sha256
    checked as it is copied; a mismatch re-fetches it as a ranged task)
    or a slice of its fetched span."""
    b = base_of.get(c.offset)
    if b is None:
        span = span_of[c.offset]
        t0 = time.perf_counter()
        view = await fetches.view(span)
        timings["span_wait_s"] += time.perf_counter() - t0
        tf.record(flightlib.EV_DELTA_FETCH, -1,
                  (time.perf_counter() - t0) * 1000.0, str(c.length))
        _book(stats, "fetched", c.length)
        return view[c.offset - span[0]: c.end - span[0]]

    view = chunk_buf[:c.length]
    ok = False
    t_copy = time.perf_counter()
    try:
        t0 = time.perf_counter()
        with base_store:
            await asyncio.to_thread(base_store.read_into, b.offset,
                                    b.length, view)
        timings["base_read_s"] += time.perf_counter() - t0
        ok = await _sha256(view, timings) == c.sha256
    except (StorageError, OSError) as e:
        log.warning("base chunk read failed; re-fetching",
                    base_offset=b.offset, error=str(e)[:200])
    if ok:
        tf.record(flightlib.EV_DELTA_REUSE, -1,
                  (time.perf_counter() - t_copy) * 1000.0, str(c.length))
        _book(stats, "reused", c.length)
        return view
    # A corrupt (or unreadable) base chunk: re-fetched as a ranged task of
    # its own, booked as fetched, and counted.
    log.warning("base chunk digest mismatch; re-fetching",
                new_offset=c.offset, base_offset=b.offset, length=c.length)
    stats["corrupt_base"] += 1
    DELTA_CHUNKS.labels("corrupt_base").inc()
    t0 = time.perf_counter()
    await fetcher.fetch_into(c.offset, c.end, view)
    timings["span_wait_s"] += time.perf_counter() - t0
    if await _sha256(view, timings) != c.sha256:
        raise DfError(Code.ClientPieceDownloadFail,
                      f"delta chunk at {c.offset} failed its manifest "
                      f"digest even after re-fetch")
    tf.record(flightlib.EV_DELTA_FETCH, -1,
              (time.perf_counter() - t0) * 1000.0, str(c.length))
    _book(stats, "fetched", c.length)
    return view
