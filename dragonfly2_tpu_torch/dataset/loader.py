"""Pod-sharded streaming loader over P2P tar shards: the port's copy of
``dragonfly2_tpu/dataset/loader.py``.

The input-pipeline contract (tf.data-shaped, Murray et al.): every epoch
is a deterministic function of ``(seed, epoch, num_hosts)`` —

  * **exactly-once**: the union of the per-host iterators covers every
    sample of every shard exactly once per epoch;
  * **reproducible**: the same (seed, epoch, host_id) yields the same
    sample order, independent of timing, readahead depth, or fetch
    interleaving;
  * **host-independent**: host h's order never depends on which other
    hosts exist beyond ``num_hosts`` (a strided partition of one global
    shuffle).

Order is planned as: shuffle shard order, shuffle sample order within
each shard, flatten, stride-partition by host (``flat[host::hosts]``),
then interleave each host's items across up to K open shards for read
spread. All randomness flows from ``random.Random(seed-string)`` (which
seeds via SHA-512, stable across processes and machines — never
``hash()``, which is salted per process).

Fetching is pipelined: a bounded readahead window of in-flight
``ShardReader.read_sample`` futures (each a ranged P2P task) runs ahead
of the consumer; yield order stays the planned order.
"""

from __future__ import annotations

import asyncio
import random
from collections import deque
from dataclasses import dataclass

from dragonfly2_tpu_torch.dataset import tar_index
from dragonfly2_tpu_torch.dataset.shard_reader import (
    GatewayRangeFetcher,
    ShardReader,
)
from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg.bufpool import BufferPool

log = dflog.get("dataset.loader")

SAMPLES = metrics.counter(
    "dataset_samples_total", "Samples yielded by the streaming loader")
READAHEAD_DEPTH = metrics.gauge(
    "dataset_readahead_depth", "In-flight prefetched samples")
EPOCHS = metrics.counter(
    "dataset_epochs_total", "Epoch iterations started")


class LoaderError(Exception):
    pass


@dataclass(frozen=True)
class LoaderOptions:
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    interleave: int = 4       # concurrently-open shards per host
    readahead: int = 8        # in-flight prefetched samples
    extensions: tuple[str, ...] | None = None   # fetch only these members

    def __post_init__(self):
        if self.num_hosts < 1:
            raise LoaderError(f"num_hosts must be >= 1, got {self.num_hosts}")
        if not 0 <= self.host_id < self.num_hosts:
            raise LoaderError(
                f"host_id {self.host_id} outside [0, {self.num_hosts})")


# -- pure planning (what the determinism tests pin down) ---------------------

def epoch_order(samples_per_shard: list[int], seed: int,
                epoch: int) -> list[tuple[int, int]]:
    """The GLOBAL epoch order: (shard_idx, sample_idx) pairs — shards
    shuffled, samples shuffled within each shard. Identical on every
    host (pure function of the arguments)."""
    rng = random.Random(f"dfdataset:{seed}:{epoch}")
    shard_order = list(range(len(samples_per_shard)))
    rng.shuffle(shard_order)
    flat: list[tuple[int, int]] = []
    for si in shard_order:
        order = list(range(samples_per_shard[si]))
        rng.shuffle(order)
        flat.extend((si, k) for k in order)
    return flat


def host_partition(flat: list[tuple[int, int]], num_hosts: int,
                   host_id: int) -> list[tuple[int, int]]:
    """Strided partition: hosts' slices are disjoint and their union is
    ``flat`` — the exactly-once contract by construction."""
    return flat[host_id::num_hosts]


def interleave_shards(items: list[tuple[int, int]],
                      k: int) -> list[tuple[int, int]]:
    """Round-robin a host's items across up to ``k`` open shards (in
    first-appearance order). A permutation of ``items`` — membership is
    untouched, so exactly-once survives."""
    if k <= 1 or not items:
        return list(items)
    groups: dict[int, deque] = {}
    order: list[int] = []
    for si, ki in items:
        if si not in groups:
            groups[si] = deque()
            order.append(si)
        groups[si].append((si, ki))
    pending = deque(groups[si] for si in order)
    active: deque = deque()
    out: list[tuple[int, int]] = []
    while active or pending:
        while len(active) < k and pending:
            active.append(pending.popleft())
        g = active.popleft()
        out.append(g.popleft())
        if g:
            active.append(g)
    return out


def plan_host_epoch(samples_per_shard: list[int], opts: LoaderOptions,
                    epoch: int) -> list[tuple[int, int]]:
    """This host's full epoch plan (ordered (shard_idx, sample_idx))."""
    flat = epoch_order(samples_per_shard, opts.seed, epoch)
    mine = host_partition(flat, opts.num_hosts, opts.host_id)
    return interleave_shards(mine, opts.interleave)


# -- the loader --------------------------------------------------------------

class PodShardedLoader:
    """Streams webdataset samples out of P2P tar shards for ONE host of a
    pod. Construct with a Dfstore (gateway transport) or pass
    ``fetcher_factory`` to ride an embedded daemon
    (shard_reader.DaemonRangeFetcher). ``prepare()`` resolves every
    shard's index (cached P2P object or one-pass build), then
    ``epoch(n)`` yields sample dicts."""

    def __init__(self, store, bucket: str, shard_keys: list[str], *,
                 options: LoaderOptions | None = None,
                 fetcher_factory=None,
                 coalesce_gap: int = 256 << 10,
                 index_concurrency: int = 4,
                 pool: BufferPool | None = None):
        if not shard_keys:
            raise LoaderError("no shards given")
        if len(set(shard_keys)) != len(shard_keys):
            raise LoaderError("duplicate shard keys")
        self.store = store
        self.bucket = bucket
        self.shard_keys = list(shard_keys)
        self.opts = options or LoaderOptions()
        self._fetcher_factory = fetcher_factory or (
            lambda key: GatewayRangeFetcher(store, bucket, key))
        self._coalesce_gap = coalesce_gap
        self._index_concurrency = max(1, index_concurrency)
        self.pool = pool if pool is not None else BufferPool(
            name="dataset_span")
        self.indexes: list[tar_index.ShardIndex] | None = None
        self.readers: list[ShardReader] | None = None

    async def prepare(self) -> "PodShardedLoader":
        """Resolve all shard indexes (bounded concurrency) and build the
        per-shard readers. Idempotent."""
        if self.readers is not None:
            return self
        sem = asyncio.Semaphore(self._index_concurrency)

        async def resolve(key: str) -> tar_index.ShardIndex:
            async with sem:
                return await tar_index.fetch_or_build_index(
                    self.store, self.bucket, key)

        tasks = [asyncio.ensure_future(resolve(k)) for k in self.shard_keys]
        try:
            self.indexes = list(await asyncio.gather(*tasks))
        except BaseException:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        self.readers = [
            ShardReader(self._fetcher_factory(key), idx,
                        extensions=self.opts.extensions,
                        coalesce_gap=self._coalesce_gap, pool=self.pool)
            for key, idx in zip(self.shard_keys, self.indexes)]
        log.info("loader prepared", shards=len(self.shard_keys),
                 samples=sum(i.num_samples for i in self.indexes),
                 host=f"{self.opts.host_id}/{self.opts.num_hosts}")
        return self

    @property
    def num_samples(self) -> int:
        """Pod-wide sample count (all hosts, one epoch)."""
        if self.indexes is None:
            raise LoaderError("call prepare() first")
        return sum(i.num_samples for i in self.indexes)

    def plan(self, epoch: int) -> list[tuple[str, str]]:
        """This host's planned (shard_key, sample_key) order — exposed
        for determinism tests and debugging."""
        if self.indexes is None:
            raise LoaderError("call prepare() first")
        counts = [i.num_samples for i in self.indexes]
        return [(self.shard_keys[si], self.indexes[si].samples[ki].key)
                for si, ki in plan_host_epoch(counts, self.opts, epoch)]

    async def epoch(self, epoch: int = 0):
        """Async iterator over this host's samples for ``epoch``, with a
        bounded readahead window of in-flight ranged fetches. Yield order
        is exactly ``plan(epoch)``'s order."""
        if self.readers is None or self.indexes is None:
            raise LoaderError("call prepare() first")
        EPOCHS.inc()
        counts = [i.num_samples for i in self.indexes]
        plan = plan_host_epoch(counts, self.opts, epoch)
        plan_iter = iter(plan)
        window = max(1, self.opts.readahead)
        inflight: deque[asyncio.Future] = deque()

        def launch():
            while len(inflight) < window:
                nxt = next(plan_iter, None)
                if nxt is None:
                    break
                si, ki = nxt
                inflight.append(asyncio.ensure_future(
                    self.readers[si].read_sample(self.indexes[si].samples[ki])))
            READAHEAD_DEPTH.set(len(inflight))

        try:
            launch()
            while inflight:
                sample = await inflight.popleft()
                launch()
                SAMPLES.inc()
                yield sample
        finally:
            READAHEAD_DEPTH.set(0)
            for f in inflight:
                f.cancel()
            if inflight:
                await asyncio.gather(*inflight, return_exceptions=True)
