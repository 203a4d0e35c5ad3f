"""Async token-bucket rate limiting: the port's copy of
``dragonfly2_tpu/pkg/ratelimit.py`` (standard library only).

Limits are bytes/second with a burst bucket, as golang.org/x/time/rate
gives the reference's piece manager, upload manager and traffic shaper.
"""

from __future__ import annotations

import asyncio
import threading
import time

INF = float("inf")


class Limiter:
    """Token bucket. ``limit`` tokens/second, bucket size ``burst``.

    asyncio-native: waiters sleep exactly until their reservation matures,
    which keeps a single-core daemon responsive under load.
    """

    def __init__(self, limit: float = INF, burst: int | None = None):
        self._limit = limit
        if burst is None:
            burst = int(limit) if limit != INF else 1 << 62
        self._burst = max(1, burst)
        self._tokens = float(self._burst)
        self._last = time.monotonic()
        self._lock = asyncio.Lock()
        self._resume: asyncio.Event | None = None  # waiters parked on limit<=0

    @property
    def limit(self) -> float:
        return self._limit

    def set_limit(self, limit: float, burst: int | None = None) -> None:
        """Dynamic re-allocation (traffic shaper re-tunes per-task limits)."""
        self._advance()
        self._limit = limit
        if burst is not None:
            self._burst = max(1, burst)
        elif limit != INF:
            self._burst = max(int(limit), 1)
        self._tokens = min(self._tokens, float(self._burst))
        if limit > 0 and self._resume is not None:
            self._resume.set()  # wake waiters parked by a zero limit
            self._resume = None

    def _advance(self) -> None:
        now = time.monotonic()
        if self._limit != INF:
            self._tokens = min(float(self._burst), self._tokens + (now - self._last) * self._limit)
        else:
            self._tokens = float(self._burst)
        self._last = now

    def allow(self, n: int = 1) -> bool:
        self._advance()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def can_allow(self, n: int = 1) -> bool:
        """Non-mutating: would allow(n) succeed right now? Lets callers
        check SEVERAL buckets before debiting any (all-or-nothing takes
        across clusters must not drain earlier buckets on a later deny)."""
        self._advance()
        return self._tokens >= n

    async def wait(self, n: int = 1) -> float:
        """Block until ``n`` tokens are available; returns seconds waited."""
        if self._limit == INF:
            return 0.0
        while self._limit <= 0:
            # Limit 0 pauses the transfer; a later set_limit(>0) resumes it
            # (the traffic shaper uses this to pause/resume tasks).
            if self._resume is None:
                self._resume = asyncio.Event()
            await self._resume.wait()
        if n > self._burst:
            # A single request larger than the bucket: pay for it across
            # multiple bucket fills rather than deadlocking. Non-virtual
            # call — subclasses that override wait() for accounting (the
            # traffic shaper's window counter) must see ONE request, not
            # request + its chunks.
            waited = 0.0
            remaining = n
            while remaining > 0:
                chunk = min(remaining, self._burst)
                waited += await Limiter.wait(self, chunk)
                remaining -= chunk
            return waited
        start = time.monotonic()
        async with self._lock:  # lock held through the sleep → FIFO fairness
            self._advance()
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            deficit = n - self._tokens
            delay = deficit / self._limit
            self._tokens -= n  # reserve (goes negative; matures over time)
            try:
                await asyncio.sleep(delay)
            except asyncio.CancelledError:
                # Cancelled waiters must not consume budget (x/time/rate
                # returns the reservation on ctx cancel).
                self._tokens += n
                raise
        return time.monotonic() - start


class BlockingLimiter:
    """The same token bucket for worker threads: ``wait`` sleeps the
    calling thread, and one lock held through the sleep keeps waiters in
    order (the upload server's threads share one)."""

    def __init__(self, limit: float = INF):
        self._limit = limit
        # A second's worth of tokens, as Limiter's default burst.
        self._burst = max(1, int(limit)) if limit != INF else 1 << 62
        self._tokens = float(self._burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def wait(self, n: int = 1) -> float:
        """Block until ``n`` tokens are available; returns seconds waited.
        A request larger than the bucket pays across several fills."""
        if self._limit == INF:
            return 0.0
        waited = 0.0
        while n > 0:
            take = min(n, self._burst)
            n -= take
            with self._lock:
                now = time.monotonic()
                self._tokens = min(float(self._burst), self._tokens
                                   + (now - self._last) * self._limit)
                self._last = now
                self._tokens -= take
                if self._tokens < 0:
                    delay = -self._tokens / self._limit
                    time.sleep(delay)
                    waited += delay
        return waited
