"""The dynamic-config pull cache: the port's copy of
``dragonfly2_tpu/pkg/dynconfig.py``.

A ``Dynconfig`` refreshes its data from a fetcher every
``refresh_interval`` seconds, keeps the last data in a cache file that
survives a manager outage, and calls its observers when the data
changed. ``scheduler/dynconfig.py`` specialises it.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Any, Awaitable, Callable

from dragonfly2_tpu_torch.pkg import dflog

log = dflog.get("dynconfig")

Fetcher = Callable[[], Awaitable[dict[str, Any]]]
Observer = Callable[[dict[str, Any]], None]

DEFAULT_REFRESH_INTERVAL = 10.0


class Dynconfig:
    def __init__(self, name: str, fetch: Fetcher, *,
                 refresh_interval: float = DEFAULT_REFRESH_INTERVAL,
                 cache_dir: str = ""):
        self.name = name
        self._fetch = fetch
        self.refresh_interval = refresh_interval
        self._cache_file = (os.path.join(cache_dir, f"dynconfig-{name}.json")
                            if cache_dir else "")
        self._data: dict[str, Any] | None = None
        self._observers: list[Observer] = []
        self._task: asyncio.Task | None = None

    def register(self, observer: Observer) -> None:
        """The observer fires on every successful refresh that changed
        the data."""
        self._observers.append(observer)

    def cached(self) -> dict[str, Any]:
        """Non-blocking view of the last-fetched data ({} before the first
        refresh). Falls back to the on-disk cache file so consumers see
        data immediately after a restart."""
        if self._data is None and self._cache_file and os.path.exists(self._cache_file):
            try:
                with open(self._cache_file) as f:
                    self._data = json.load(f)
            except (OSError, ValueError):
                pass
        return self._data or {}

    async def get(self) -> dict[str, Any]:
        if self._data is None:
            await self.refresh()
        return self._data or {}

    async def refresh(self) -> bool:
        """Pull once. On failure fall back to the on-disk cache; returns
        True if data is available afterwards."""
        try:
            data = await self._fetch()
        except Exception as e:
            log.warning("dynconfig fetch failed", name=self.name, error=str(e))
            if self._data is None and self._cache_file and os.path.exists(self._cache_file):
                try:
                    with open(self._cache_file) as f:
                        self._data = json.load(f)
                    log.info("dynconfig loaded from cache file", name=self.name)
                except Exception:
                    pass
            return self._data is not None
        changed = data != self._data
        self._data = data
        if self._cache_file:
            try:
                os.makedirs(os.path.dirname(self._cache_file), exist_ok=True)
                tmp = self._cache_file + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(data, f)
                os.replace(tmp, self._cache_file)
            except OSError as e:
                log.warning("dynconfig cache write failed", error=str(e))
        if changed:
            for obs in self._observers:
                try:
                    obs(data)
                except Exception as e:
                    log.warning("dynconfig observer failed", error=str(e))
        return True

    def serve(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            try:
                await self.refresh()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # fetcher bugs must not kill the loop
                log.warning("dynconfig refresh error", name=self.name, error=str(e))
            await asyncio.sleep(self.refresh_interval)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
