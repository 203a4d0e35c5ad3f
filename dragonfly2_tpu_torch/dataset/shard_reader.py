"""Sample-addressed reads: a sample's tar byte spans -> ranged P2P tasks.
The port's copy of ``dragonfly2_tpu/dataset/shard_reader.py``.

A host that needs sample ``000123`` of a 16 GB shard fetches the few
hundred KB covering that sample's members, not the shard. Both fetchers
resolve a byte span to a RANGED file task on a daemon (range is part of
task identity), so every host in the pod pulling the same sample issues
a byte-identical task and the fabric dedupes per span.

Two transports:
  * ``DaemonRangeFetcher`` — an embedded daemon: ranged file tasks
    directly on its task manager, reached by duck type (the reference
    daemon's ``TaskManager``, as the device-sink seam reaches it).
  * ``GatewayRangeFetcher`` — over HTTP against the daemon's object
    gateway (``?ranged_task=1`` GETs through the port's ``Dfstore``).

Span buffers ride a ``BufferPool``: readahead keeps a bounded fleet of
in-flight spans, and pooled backing arrays stop the per-sample
allocate/free churn. A read that is cancelled returns only once nothing
writes into its span buffer any more, so ``read_sample`` releases the
buffers in its ``finally``.
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.daemon.peer.task_manager import FileTaskRequest
from dragonfly2_tpu_torch.dataset.tar_index import Sample, ShardIndex
from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg.bufpool import BufferPool, await_worker
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.proto.common import UrlMeta

log = dflog.get("dataset.shard_reader")

DATASET_BYTES = metrics.counter(
    "dataset_bytes_total",
    "Dataset plane bytes: fetched (ranged spans) vs yielded (sample "
    "member payloads)", ("direction",))
RANGE_READS = metrics.counter(
    "dataset_range_reads_total",
    "Sample span reads by outcome", ("result",))


class ShardReadError(Exception):
    pass


class DaemonRangeFetcher:
    """Ranged file tasks on an in-process daemon's task manager (any object
    with ``start_file_task`` and ``storage.find_completed_task``). ``url`` is
    the shard's origin URL (e.g. backend.object_url(bucket, key)); ``tag``
    must match whatever other consumers use (the gateway uses the bucket
    name) so ranged tasks dedupe across surfaces."""

    def __init__(self, task_manager, url: str, *, tag: str = "",
                 application: str = "", header: dict | None = None,
                 pod_broadcast: bool = False):
        self.tm = task_manager
        self.url = url
        self.tag = tag
        # Extra task-identity fields for consumers whose spans must dedup
        # with other surfaces carrying them (the delta plane threads the
        # original request's application/header through so every host
        # running the same delta issues byte-identical span tasks).
        self.application = application
        self.header = dict(header or {})
        self.pod_broadcast = pod_broadcast
        self.stats = {"cold": 0, "reuse": 0}

    async def fetch_into(self, start: int, end: int, buf: memoryview) -> None:
        rng = Range.normalize_header(f"{start}-{end - 1}")
        req = FileTaskRequest(url=self.url, output="",
                              meta=UrlMeta(tag=self.tag,
                                           application=self.application,
                                           header=dict(self.header),
                                           range=rng),
                              pod_broadcast=self.pod_broadcast)
        req.range = Range.parse_http(rng)
        final = None
        async for p in self.tm.start_file_task(req):
            if p.state == "failed":
                raise DfError.from_wire(p.error or {})
            if p.state == "done":
                final = p
        if final is None:
            raise DfError(Code.UnknownError, "ranged task ended silently")
        store = self.tm.storage.find_completed_task(final.task_id)
        if store is None:
            raise DfError(Code.StorageTaskNotFound,
                          f"ranged task {final.task_id[:16]} has no store")
        n = end - start
        if store.metadata.content_length != n:
            raise ShardReadError(
                f"ranged task returned {store.metadata.content_length}B "
                f"for a {n}B span of {self.url}")
        with store:   # pin across the off-loop read
            # preadv straight into the caller's pooled span buffer; a
            # cancel waits for the read to end before the buffer goes back.
            await await_worker(asyncio.ensure_future(
                asyncio.to_thread(store.read_into, 0, n, buf)))
        self.stats["reuse" if final.from_reuse else "cold"] += 1
        RANGE_READS.labels("reuse" if final.from_reuse else "cold").inc()


class GatewayRangeFetcher:
    """Ranged-task GETs over the daemon's object gateway (Dfstore
    ``read_object_range`` with ranged_task=1)."""

    def __init__(self, store, bucket: str, key: str):
        self.store = store
        self.bucket = bucket
        self.key = key
        self.stats = {"cold": 0, "reuse": 0}

    async def fetch_into(self, start: int, end: int, buf: memoryview) -> None:
        attrs, _ = await self.store.read_object_range(
            self.bucket, self.key, start, end, buf=buf)
        outcome = "reuse" if attrs.get("from_reuse") else "cold"
        self.stats[outcome] += 1
        RANGE_READS.labels(outcome).inc()


class ShardReader:
    """Sample-level reads over one indexed shard. Adjacent member spans
    closer than ``coalesce_gap`` merge into one ranged task (the gap
    bytes ride along — fewer tasks beats fewer bytes at tar header
    granularity, and webdataset members are adjacent by construction)."""

    def __init__(self, fetcher, index: ShardIndex, *,
                 extensions=None, coalesce_gap: int = 256 << 10,
                 include_headers: bool = False,
                 pool: BufferPool | None = None):
        self.fetcher = fetcher
        self.index = index
        self.extensions = (None if extensions is None
                           else tuple(extensions))
        self.coalesce_gap = coalesce_gap
        # include_headers widens spans to the members' header blocks —
        # useful when re-emitting valid tar bytes rather than payloads.
        self.include_headers = include_headers
        self.pool = pool if pool is not None else BufferPool(
            name="dataset_span")

    def sample_spans(self, sample: Sample) -> list[tuple[int, int]]:
        """Coalesced absolute byte spans covering the sample's members."""
        pairs = self.index.members_of(sample, self.extensions)
        if not pairs:
            raise ShardReadError(
                f"sample {sample.key!r} has no members"
                + (f" for extensions {self.extensions}" if self.extensions
                   else ""))
        raw = sorted(
            ((m.offset if self.include_headers else m.data_offset),
             m.data_offset + m.size)
            for _, m in pairs)
        spans: list[list[int]] = []
        for s, e in raw:
            if spans and s - spans[-1][1] <= self.coalesce_gap:
                spans[-1][1] = max(spans[-1][1], e)
            else:
                spans.append([s, e])
        return [(s, e) for s, e in spans]

    async def read_sample(self, sample: Sample) -> dict:
        """Fetch one sample; returns ``{"__key__", "__shard__",
        <ext>: bytes, ...}``. Multiple spans fetch concurrently (rare —
        coalescing usually leaves one)."""
        spans = self.sample_spans(sample)
        bufs: dict[tuple[int, int], memoryview] = {}
        try:
            for s, e in spans:
                bufs[(s, e)] = self.pool.acquire(e - s)

            async def pull(s: int, e: int) -> None:
                await self.fetcher.fetch_into(s, e, bufs[(s, e)])

            if len(spans) == 1:
                await pull(*spans[0])
            else:
                tasks = [asyncio.ensure_future(pull(s, e)) for s, e in spans]
                try:
                    await asyncio.gather(*tasks)
                except BaseException:
                    for t in tasks:
                        t.cancel()
                    await asyncio.gather(*tasks, return_exceptions=True)
                    raise
            out: dict = {"__key__": sample.key, "__shard__": self.index.shard}
            yielded = 0
            for ext, m in self.index.members_of(sample, self.extensions):
                span = next((s, e) for s, e in spans
                            if s <= m.data_offset
                            and m.data_offset + m.size <= e)
                buf = bufs[span]
                lo = m.data_offset - span[0]
                out[ext] = bytes(buf[lo:lo + m.size])
                yielded += m.size
            DATASET_BYTES.labels("fetched").inc(
                sum(e - s for s, e in spans))
            DATASET_BYTES.labels("yielded").inc(yielded)
            return out
        finally:
            for buf in bufs.values():
                self.pool.release(buf)
