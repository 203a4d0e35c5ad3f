"""Piece broker, per-task pub/sub for piece arrivals: the port's copy of
``dragonfly2_tpu/daemon/peer/broker.py``.

The task manager publishes each landed piece, a task's completion and its
failure; subscribers (the P2P piece sync and stream tasks, when ported)
receive them in order.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field


@dataclass
class PieceEvent:
    piece_nums: list[int]
    total_piece_count: int = -1
    content_length: int = -1
    piece_size: int = 0
    done: bool = False
    failed: bool = False
    # piece_num → "algo:encoded" — children verify against the parent's
    # advertised digest (reference commonv1 PieceInfo.piece_md5).
    digests: dict[int, str] = field(default_factory=dict)


@dataclass
class _TaskChannel:
    queues: set[asyncio.Queue] = field(default_factory=set)
    done: bool = False
    failed: bool = False


class PieceBroker:
    def __init__(self):
        self._tasks: dict[str, _TaskChannel] = {}

    def _chan(self, task_id: str) -> _TaskChannel:
        ch = self._tasks.get(task_id)
        if ch is None:
            ch = _TaskChannel()
            self._tasks[task_id] = ch
        return ch

    def publish(self, task_id: str, event: PieceEvent) -> None:
        # No subscribers → nothing to deliver; creating a channel here would
        # leak one per task ever downloaded.
        ch = self._tasks.get(task_id)
        if ch is None:
            return
        if event.done:
            ch.done = True
        if event.failed:
            ch.failed = True
        for q in list(ch.queues):
            q.put_nowait(event)

    def subscribe(self, task_id: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._chan(task_id).queues.add(q)
        return q

    def unsubscribe(self, task_id: str, q: asyncio.Queue) -> None:
        ch = self._tasks.get(task_id)
        if ch is not None:
            ch.queues.discard(q)
            if not ch.queues:
                self._tasks.pop(task_id, None)

    def is_done(self, task_id: str) -> bool:
        ch = self._tasks.get(task_id)
        return ch is not None and ch.done
