"""asyncio helpers: the port's copy of ``dragonfly2_tpu/pkg/aio.py``.

``spawn`` is the fire-and-forget task launcher: the event loop keeps only
weak references to tasks, so a bare ``ensure_future`` can be garbage
collected mid-flight; spawned tasks are held strongly until done.
"""

from __future__ import annotations

import asyncio
from typing import Coroutine

_BACKGROUND: set[asyncio.Task] = set()


def spawn(coro: Coroutine) -> asyncio.Task:
    task = asyncio.ensure_future(coro)
    _BACKGROUND.add(task)
    task.add_done_callback(_BACKGROUND.discard)
    return task
