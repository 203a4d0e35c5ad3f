"""The one retry/backoff policy: the port's copy of
``dragonfly2_tpu/pkg/retry.py`` (standard library only).

  * capped exponential delay: ``min(cap, base * multiplier**attempt)``
  * full jitter by default: the actual sleep is uniform in [0, delay], so
    many daemons that lost one origin do not retry in lockstep waves
  * a progress watchdog (``watch_idle``) that bounds the gap BETWEEN
    chunks — the slow-loris defense an overall timeout can't express
    without also capping legitimate large transfers.

The piece manager's origin retry uses it for temporary failures only, so
a permanent 403/404 never burns the back-to-source budget.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass
from typing import AsyncIterator, Awaitable, Callable, TypeVar

T = TypeVar("T")


class ProgressTimeout(asyncio.TimeoutError):
    """No forward progress (no chunk/no byte) within the idle budget."""


@dataclass(frozen=True)
class BackoffPolicy:
    """Capped exponential backoff with full jitter.

    ``delay(attempt)`` for attempt = 0, 1, 2, ... — attempt 0 is the delay
    BEFORE the first retry (the first try itself is free).
    """

    base: float = 0.1
    cap: float = 5.0
    multiplier: float = 2.0
    jitter: bool = True

    def raw_delay(self, attempt: int) -> float:
        """The jitterless ceiling for ``attempt`` (tests pin this)."""
        if attempt < 0:
            return 0.0
        return min(self.cap, self.base * self.multiplier ** attempt)

    def delay(self, attempt: int,
              rng: Callable[[], float] = random.random) -> float:
        raw = self.raw_delay(attempt)
        if not self.jitter:
            return raw
        # Full jitter: uniform in [0, raw]. rng is injectable so seeded
        # tests stay deterministic.
        return raw * rng()


# Shared defaults, tuned per call family:
#   RECONNECT — rpc client to a flapping scheduler: fast first retry,
#     bounded so a unary call's own timeout still dominates.
#   ANNOUNCE — conductor announce-stream recovery: a little slower; the
#     piece workers keep downloading while it runs.
#   SOURCE — origin refetch: origins rate-limit; back off harder.
RECONNECT = BackoffPolicy(base=0.05, cap=2.0)
ANNOUNCE = BackoffPolicy(base=0.1, cap=3.0)
SOURCE = BackoffPolicy(base=0.2, cap=10.0)


async def run(
    fn: Callable[[], Awaitable[T]],
    *,
    policy: BackoffPolicy | None = None,
    max_attempts: int = 5,
    cancel: asyncio.Event | None = None,
    retryable: Callable[[BaseException], bool] | None = None,
    rng: Callable[[], float] = random.random,
    init_backoff: float | None = None,
    max_backoff: float | None = None,
) -> T:
    """Run ``fn`` until success with the shared backoff policy.

    Raises the last error after ``max_attempts``. ``retryable`` can mark
    errors as terminal (returns False → raise immediately). The legacy
    ``init_backoff``/``max_backoff`` kwargs build an equivalent policy.
    """
    if policy is None:
        policy = BackoffPolicy(base=init_backoff if init_backoff is not None
                               else 0.2,
                               cap=max_backoff if max_backoff is not None
                               else 5.0)
    last: BaseException | None = None
    for attempt in range(max_attempts):
        if cancel is not None and cancel.is_set():
            raise asyncio.CancelledError()
        try:
            return await fn()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            last = e
            if retryable is not None and not retryable(e):
                raise
            if attempt == max_attempts - 1:
                break
            await asyncio.sleep(policy.delay(attempt, rng))
    assert last is not None
    raise last


async def watch_idle(chunks: AsyncIterator[bytes], idle_timeout: float,
                     what: str = "stream") -> AsyncIterator[bytes]:
    """Per-chunk progress watchdog: yield from ``chunks`` but raise
    ``ProgressTimeout`` when the gap between consecutive chunks exceeds
    ``idle_timeout``. An overall deadline cannot distinguish a healthy
    10 GiB transfer from a slow-loris parent trickling one byte a minute;
    a chunk-gap bound can. ``idle_timeout <= 0`` disables the watchdog."""
    if idle_timeout <= 0:
        async for chunk in chunks:
            yield chunk
        return
    it = chunks.__aiter__()
    while True:
        try:
            chunk = await asyncio.wait_for(it.__anext__(), idle_timeout)
        except StopAsyncIteration:
            return
        except asyncio.TimeoutError:
            raise ProgressTimeout(
                f"{what}: no data for {idle_timeout:.1f}s (stalled)")
        yield chunk
