"""The periodic GC runner: the port's copy of ``GC`` and ``GCTask`` from
``dragonfly2_tpu/pkg/cache.py`` (its ``TTLCache`` has no user in the port
yet).

Each named task runs on its own interval inside the daemon's event loop;
a task that raises is logged and runs again at its next tick, and one
that outlasts its timeout is cancelled.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Awaitable, Callable


@dataclass
class GCTask:
    """One named periodic GC job."""

    id: str
    interval: float
    timeout: float
    runner: Callable[[], Awaitable[None]] | Callable[[], None]


class GC:
    """Runs each registered task on its own interval in the running loop."""

    def __init__(self, logger=None):
        self._tasks: dict[str, GCTask] = {}
        self._handles: list[asyncio.Task] = []
        self._log = logger
        self._running = False

    def add(self, task: GCTask) -> None:
        if task.id in self._tasks:
            raise ValueError(f"gc task {task.id} exists")
        self._tasks[task.id] = task

    async def _loop(self, task: GCTask) -> None:
        while True:
            await asyncio.sleep(task.interval)
            try:
                result = task.runner()
                if asyncio.iscoroutine(result):
                    await asyncio.wait_for(result, timeout=task.timeout)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # GC must never kill the server
                if self._log:
                    self._log.error(f"gc task {task.id} failed", error=str(e))

    def serve(self) -> None:
        if self._running:
            return
        self._running = True
        for task in self._tasks.values():
            self._handles.append(
                asyncio.get_running_loop().create_task(self._loop(task)))

    def stop(self) -> None:
        for h in self._handles:
            h.cancel()
        self._handles.clear()
        self._running = False
