"""Consistent-hash balancer, pinning each task id to one scheduler: the
port's copy of ``dragonfly2_tpu/rpc/balancer.py``.

A hash ring over scheduler addresses, so every peer working on one task
talks to the same scheduler instance (scheduler state is per instance).
The ring's points are the JAX package's, so both pick the same member.
"""

from __future__ import annotations

import bisect
import hashlib


class HashRing:
    def __init__(self, members: list[str] | None = None, replicas: int = 97):
        self._replicas = replicas
        self._ring: list[tuple[int, str]] = []
        self._keys: list[int] = []
        self._members: set[str] = set()
        for m in members or []:
            self.add(m)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for i in range(self._replicas):
            h = self._hash(f"{member}#{i}")
            idx = bisect.bisect(self._keys, h)
            self._keys.insert(idx, h)
            self._ring.insert(idx, (h, member))

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        kept = [(h, m) for h, m in self._ring if m != member]
        self._ring = kept
        self._keys = [h for h, _ in kept]

    def members(self) -> list[str]:
        return sorted(self._members)

    def pick(self, key: str) -> str | None:
        """Member owning ``key`` (clockwise successor on the ring)."""
        if not self._ring:
            return None
        h = self._hash(key)
        idx = bisect.bisect(self._keys, h)
        if idx == len(self._keys):
            idx = 0
        return self._ring[idx][1]

    def pick_n(self, key: str, n: int) -> list[str]:
        """First n distinct members clockwise from ``key`` (failover order)."""
        if not self._ring:
            return []
        out: list[str] = []
        h = self._hash(key)
        idx = bisect.bisect(self._keys, h)
        for i in range(len(self._ring)):
            m = self._ring[(idx + i) % len(self._ring)][1]
            if m not in out:
                out.append(m)
                if len(out) >= n:
                    break
        return out
