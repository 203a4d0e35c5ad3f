"""A minimal finite-state machine: the port's copy of
``dragonfly2_tpu/pkg/fsm.py``, with the same events, states and
``TransitionError`` text.

Events name transitions; a callback fires after a successful transition.
The scheduler's peers and tasks run their lifecycles on it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable


class TransitionError(Exception):
    def __init__(self, event: str, state: str):
        super().__init__(f"event {event!r} inappropriate in current state {state!r}")
        self.event = event
        self.state = state


@dataclass(frozen=True)
class EventDesc:
    name: str
    src: tuple[str, ...]
    dst: str


class FSM:
    def __init__(
        self,
        initial: str,
        events: list[EventDesc],
        callbacks: dict[str, Callable[[str, str, str], None]] | None = None,
    ):
        self._state = initial
        self._events: dict[str, EventDesc] = {e.name: e for e in events}
        self._callbacks = callbacks or {}
        self._mu = threading.RLock()

    @property
    def current(self) -> str:
        with self._mu:
            return self._state

    def is_state(self, *states: str) -> bool:
        with self._mu:
            return self._state in states

    def can(self, event: str) -> bool:
        with self._mu:
            desc = self._events.get(event)
            return desc is not None and self._state in desc.src

    def restore(self, state: str) -> None:
        """Set the state directly, with no transition and no callback:
        only for rebuilding an FSM from a durable snapshot (the
        scheduler's HA restore), whose recorded state was reached through
        real transitions in an earlier process."""
        with self._mu:
            self._state = state

    def event(self, name: str) -> None:
        with self._mu:
            desc = self._events.get(name)
            if desc is None or self._state not in desc.src:
                raise TransitionError(name, self._state)
            src = self._state
            self._state = desc.dst
            cb = self._callbacks.get(name)
        if cb is not None:
            cb(name, src, desc.dst)
