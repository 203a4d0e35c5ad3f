"""Traffic shaper, total-bandwidth sharing across concurrent tasks: the
port's copy of ``dragonfly2_tpu/daemon/peer/traffic_shaper.py``.

``plain`` gives every task the same shared limiter; ``sampling`` samples
each task's bytes every interval and re-splits the total in proportion to
observed need, so one hot checkpoint pull does not starve under an even
split and idle tasks release their bandwidth.

The ``TaskManager`` owns one (``total_rate_limit``, ``traffic_shaper``)
and takes each task's limiter from it; the daemon runs the ``serve()``
loop that re-splits a sampling shaper.
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.ratelimit import INF, Limiter

log = dflog.get("peer.traffic_shaper")

TYPE_PLAIN = "plain"
TYPE_SAMPLING = "sampling"

DEFAULT_SAMPLING_INTERVAL = 1.0
# Floor share of an active-but-idle task: keeps it able to ramp back up
# (reference traffic_shaper.go uses a per-task default of total/10).
MIN_SHARE_FRACTION = 0.1


class _TaskLimiter(Limiter):
    """Per-task limiter that counts bytes granted in the current window."""

    def __init__(self, limit: float):
        super().__init__(limit)
        self.window_bytes = 0

    async def wait(self, n: int = 1) -> float:
        waited = await super().wait(n)
        self.window_bytes += n
        return waited

    def take_window(self) -> int:
        used, self.window_bytes = self.window_bytes, 0
        return used


class TrafficShaper:
    def __init__(self, total_rate: float = INF, *,
                 algorithm: str = TYPE_PLAIN,
                 sampling_interval: float = DEFAULT_SAMPLING_INTERVAL):
        if algorithm not in (TYPE_PLAIN, TYPE_SAMPLING):
            # A config typo must not stop the daemon: fall back to the plain
            # shaper like the reference (traffic_shaper.go:59).
            log.warning("unknown traffic shaper algorithm, using plain",
                        algorithm=algorithm)
            algorithm = TYPE_PLAIN
        self.algorithm = algorithm
        self.total_rate = total_rate
        self.sampling_interval = sampling_interval
        self._shared = Limiter(total_rate)
        self._tasks: dict[str, _TaskLimiter] = {}
        self._loop_task: asyncio.Task | None = None

    # -- task lifecycle ----------------------------------------------------

    def start_task(self, task_id: str) -> Limiter:
        """Limiter a task's transfers must ride. plain → the one shared
        bucket; sampling → a per-task bucket re-tuned by the sampler."""
        if self.algorithm == TYPE_PLAIN or self.total_rate == INF:
            return self._shared
        lim = self._tasks.get(task_id)
        if lim is None:
            lim = _TaskLimiter(self._fair_share(len(self._tasks) + 1))
            self._tasks[task_id] = lim
            self._rebalance_even()
        return lim

    def finish_task(self, task_id: str) -> None:
        if self._tasks.pop(task_id, None) is not None and self._tasks:
            self._rebalance_even()

    def _fair_share(self, n: int) -> float:
        return self.total_rate / max(1, n)

    def _rebalance_even(self) -> None:
        """New/finished task: reset to an even split; the sampler skews it
        toward observed need at the next tick."""
        share = self._fair_share(len(self._tasks))
        for lim in self._tasks.values():
            lim.set_limit(share)

    # -- sampling loop (reference :125+) -----------------------------------

    def serve(self) -> None:
        if self.algorithm == TYPE_SAMPLING and self._loop_task is None:
            self._loop_task = asyncio.create_task(self._loop())

    def stop(self) -> None:
        if self._loop_task is not None:
            self._loop_task.cancel()
            self._loop_task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.sampling_interval)
            self.reallocate()

    def reallocate(self) -> None:
        """Split total_rate across tasks proportionally to bytes moved in
        the last window, with a floor so starved tasks can recover."""
        if not self._tasks or self.total_rate == INF:
            return
        usages = {tid: lim.take_window() for tid, lim in self._tasks.items()}
        total_used = sum(usages.values())
        n = len(self._tasks)
        floor = self.total_rate * MIN_SHARE_FRACTION / n
        if total_used == 0:
            self._rebalance_even()
            return
        distributable = self.total_rate - floor * n
        for tid, lim in self._tasks.items():
            share = floor + distributable * (usages[tid] / total_used)
            lim.set_limit(share)
        log.debug("reallocated bandwidth", tasks=n, total_used=total_used)
