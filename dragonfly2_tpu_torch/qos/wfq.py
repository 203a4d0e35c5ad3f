"""Deficit-weighted-round-robin dispatch and per-tenant upload buckets:
the port's copy of ``dragonfly2_tpu/qos/wfq.py``.

``WFQGate``: a capacity-bounded asyncio gate the conductor's piece
workers pass before each piece request. Under one task it never binds
(capacity defaults to 2x the per-task parent concurrency); when tasks
contend, freed slots go out in DWRR order across the three dispatch
classes (Shreedhar & Varghese '95: each class accrues ``quantum *
weight`` credit a visit and dequeues while its deficit covers the next
item; unit cost, one slot a piece request).

``TenantBuckets``: the upload cap split into per-tenant token buckets,
re-split evenly on each new tenant and floored at ``min_share_fraction``
of the cap. With an unlimited cap it is pure accounting
(``peer_upload_bytes_total{tenant}``). The port's upload server serves
on threads, so its buckets are ``BlockingLimiter``s and its bookkeeping
takes a lock; the shares, re-splits and byte accounting are the JAX
package's.
"""

from __future__ import annotations

import asyncio
import threading
from collections import deque

from dragonfly2_tpu_torch import qos
from dragonfly2_tpu_torch.pkg import metrics
from dragonfly2_tpu_torch.pkg.ratelimit import INF, BlockingLimiter

QUEUE_DEPTH = metrics.gauge(
    "peer_qos_queue_depth",
    "Piece-dispatch requests queued behind the WFQ gate per dispatch "
    "class (nonzero only under cross-task contention)",
    ("class",))

GRANTS = metrics.counter(
    "qos_wfq_grants_total",
    "Dispatch slots granted by the WFQ gate per dispatch class",
    ("class",))

TENANT_UPLOAD_BYTES = metrics.counter(
    "peer_upload_bytes_total",
    "Piece bytes served to other peers, attributed to the requesting "
    "tenant (the qos TenantBuckets accounting plane)",
    ("tenant",))


class WFQGate:
    """Async DWRR admission gate over the dispatch classes.

    ``acquire(priority)`` takes one of ``capacity`` slots, waiting in
    class-fair order when all are busy; ``release()`` frees it and wakes
    the next waiter. A cancelled waiter leaves the queue, or hands its
    slot on if the grant raced the cancel."""

    def __init__(self, capacity: int = 8, *, quantum: float = 1.0):
        self.capacity = max(1, int(capacity))
        self.quantum = float(quantum)
        self._active = 0
        self._queues: dict[str, deque] = {c: deque() for c in qos.CLASSES}
        self._deficit: dict[str, float] = {c: 0.0 for c in qos.CLASSES}
        self._grants = {c: GRANTS.labels(c) for c in qos.CLASSES}
        self._depth = {c: QUEUE_DEPTH.labels(c) for c in qos.CLASSES}

    @property
    def active(self) -> int:
        return self._active

    def queued(self) -> dict[str, int]:
        return {c: len(q) for c, q in self._queues.items()}

    async def acquire(self, priority: int) -> None:
        cls = qos.class_of(priority)
        if self._active < self.capacity and not any(
                self._queues[c] for c in qos.CLASSES):
            self._active += 1
            self._grants[cls].inc()
            return
        fut = asyncio.get_running_loop().create_future()
        self._queues[cls].append(fut)
        self._depth[cls].set(len(self._queues[cls]))
        try:
            await fut
        except asyncio.CancelledError:
            if fut.cancelled() or not fut.done():
                try:
                    self._queues[cls].remove(fut)
                except ValueError:
                    pass
                self._depth[cls].set(len(self._queues[cls]))
            else:
                # The grant landed before the cancel: hand the slot on.
                self.release()
            raise
        self._grants[cls].inc()

    def release(self) -> None:
        self._active = max(0, self._active - 1)
        self._dispatch()

    def _dispatch(self) -> None:
        # One DWRR sweep a batch of free slots: classes highest weight
        # first, each credited quantum*weight, dequeuing while its deficit
        # covers unit cost. An emptied class forfeits its credit.
        while self._active < self.capacity:
            granted = False
            for cls in qos.CLASSES:
                q = self._queues[cls]
                if not q:
                    self._deficit[cls] = 0.0
                    continue
                self._deficit[cls] += self.quantum * qos.WEIGHTS[cls]
                while (q and self._deficit[cls] >= 1.0
                       and self._active < self.capacity):
                    fut = q.popleft()
                    if fut.done():        # cancelled while queued
                        continue
                    self._deficit[cls] -= 1.0
                    self._active += 1
                    fut.set_result(None)
                    granted = True
                self._depth[cls].set(len(q))
                if not q:
                    self._deficit[cls] = 0.0
            if not granted:
                break


class TenantBuckets:
    """Per-tenant token buckets re-split under one daemon-wide cap.

    A tenant's first serve makes its bucket and re-splits the cap evenly
    over the tenants, floored at ``min_share_fraction`` of it; past
    ``max_tenants`` a new tenant shares the default bucket. ``wait``
    blocks the calling thread on the tenant's bucket and attributes the
    bytes to ``peer_upload_bytes_total{tenant}``."""

    def __init__(self, total_rate: float = INF, *,
                 min_share_fraction: float = 0.1, max_tenants: int = 256):
        self.total_rate = total_rate if total_rate and total_rate > 0 else INF
        self.min_share_fraction = min_share_fraction
        self.max_tenants = max_tenants
        self._mu = threading.Lock()
        self._buckets: dict[str, BlockingLimiter] = {}
        self._bytes = {}

    def _resplit(self) -> None:
        if self.total_rate == INF:
            share = INF
        else:
            share = max(self.total_rate / len(self._buckets),
                        self.total_rate * self.min_share_fraction)
        for bucket in self._buckets.values():
            bucket.set_limit(share)

    def bucket(self, tenant: str) -> BlockingLimiter:
        t = qos.normalize_tenant(tenant)
        with self._mu:
            b = self._buckets.get(t)
            if b is None:
                if len(self._buckets) >= self.max_tenants:
                    # Cardinality backstop: overflow tenants share the
                    # default bucket.
                    t = qos.DEFAULT_TENANT
                    b = self._buckets.get(t)
                    if b is not None:
                        return b
                b = self._buckets[t] = BlockingLimiter(INF)
                self._resplit()
            return b

    def wait(self, tenant: str, n: int) -> float:
        t = qos.normalize_tenant(tenant)
        waited = self.bucket(t).wait(n)
        with self._mu:
            counter = self._bytes.get(t)
            if counter is None:
                counter = self._bytes[t] = TENANT_UPLOAD_BYTES.labels(t)
        counter.inc(n)
        return waited

    def shares(self) -> dict[str, float]:
        """The rate each tenant holds now."""
        with self._mu:
            return {t: b.limit for t, b in self._buckets.items()}
