"""The TTL cache and the periodic GC runner: the port's copy of
``TTLCache``, ``GC`` and ``GCTask`` from ``dragonfly2_tpu/pkg/cache.py``.

``TTLCache`` is the manager's short-lived cache of the read paths that
dynconfig clients poll (``manager/service.py``). Each named GC task runs
on its own interval inside the server's event loop; a task that raises
is logged and runs again at its next tick, and one that outlasts its
timeout is cancelled.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

NO_EXPIRATION = -1.0


class TTLCache:
    """A thread-safe cache whose entries expire ``ttl`` seconds after
    they are set (``NO_EXPIRATION``: never)."""

    def __init__(self, default_ttl: float = NO_EXPIRATION):
        self._default_ttl = default_ttl
        self._items: dict[str, tuple[Any, float]] = {}
        self._mu = threading.Lock()

    def set(self, key: str, value: Any, ttl: float | None = None) -> None:
        ttl = self._default_ttl if ttl is None else ttl
        expires = (NO_EXPIRATION if ttl == NO_EXPIRATION
                   else time.monotonic() + ttl)
        with self._mu:
            self._items[key] = (value, expires)

    def get(self, key: str) -> tuple[Any, bool]:
        with self._mu:
            item = self._items.get(key)
            if item is None:
                return None, False
            value, expires = item
            if expires != NO_EXPIRATION and time.monotonic() > expires:
                del self._items[key]
                return None, False
            return value, True

    def delete(self, key: str) -> None:
        with self._mu:
            self._items.pop(key, None)

    def keys(self) -> list[str]:
        with self._mu:
            now = time.monotonic()
            return [k for k, (_, exp) in self._items.items()
                    if exp == NO_EXPIRATION or exp >= now]

    def purge_expired(self) -> int:
        with self._mu:
            now = time.monotonic()
            dead = [k for k, (_, exp) in self._items.items()
                    if exp != NO_EXPIRATION and exp < now]
            for k in dead:
                del self._items[k]
            return len(dead)

    def __len__(self) -> int:
        return len(self.keys())


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
