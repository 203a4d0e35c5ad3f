"""A generic DAG, the scheduler's per-task peer tree: the port's copy of
``dragonfly2_tpu/pkg/dag.py``.

A lock-guarded DAG with random-vertex sampling; the scheduler stores each
task's peers as vertices and parent-to-child download edges.

One divergence: ``random_vertices`` draws from the ``random.Random`` the
DAG was given (``rng=``), where the JAX DAG draws from the global
generator. The draw is the same call (``sample(range(m), n)``), so a
``Random(s)`` and the global generator after ``random.seed(s)`` give the
same sample when the same calls come in the same order.
"""

from __future__ import annotations

import random
import threading
from typing import Generic, Iterator, TypeVar

T = TypeVar("T")


class DAGError(Exception):
    pass


class CycleError(DAGError):
    pass


class VertexNotFoundError(DAGError):
    pass


class Vertex(Generic[T]):
    def __init__(self, vid: str, value: T):
        self.id = vid
        self.value = value
        self.parents: dict[str, "Vertex[T]"] = {}
        self.children: dict[str, "Vertex[T]"] = {}

    def in_degree(self) -> int:
        return len(self.parents)

    def out_degree(self) -> int:
        return len(self.children)


class DAG(Generic[T]):
    """Thread-safe DAG. Edges are parent -> child."""

    def __init__(self, rng: random.Random | None = None):
        self._v: dict[str, Vertex[T]] = {}
        # The sampling index: an id list with swap-remove and a position
        # map, so random_vertices costs O(sample), not O(vertices).
        self._order: list[str] = []
        self._pos: dict[str, int] = {}
        self._rng = rng if rng is not None else random.Random()
        self._mu = threading.RLock()

    def add_vertex(self, vid: str, value: T) -> None:
        with self._mu:
            if vid in self._v:
                raise DAGError(f"vertex {vid} exists")
            self._v[vid] = Vertex(vid, value)
            self._pos[vid] = len(self._order)
            self._order.append(vid)

    def delete_vertex(self, vid: str) -> None:
        with self._mu:
            v = self._v.pop(vid, None)
            if v is None:
                return
            i = self._pos.pop(vid)
            last = self._order.pop()
            if last != vid:
                self._order[i] = last
                self._pos[last] = i
            for p in v.parents.values():
                p.children.pop(vid, None)
            for c in v.children.values():
                c.parents.pop(vid, None)

    def get_vertex(self, vid: str) -> Vertex[T]:
        with self._mu:
            v = self._v.get(vid)
            if v is None:
                raise VertexNotFoundError(vid)
            return v

    def has_vertex(self, vid: str) -> bool:
        with self._mu:
            return vid in self._v

    def vertex_count(self) -> int:
        with self._mu:
            return len(self._v)

    def vertex_ids(self) -> list[str]:
        with self._mu:
            return list(self._v.keys())

    def add_edge(self, from_id: str, to_id: str) -> None:
        with self._mu:
            if from_id == to_id:
                raise CycleError("self edge")
            src = self._v.get(from_id)
            dst = self._v.get(to_id)
            if src is None or dst is None:
                raise VertexNotFoundError(from_id if src is None else to_id)
            if to_id in src.children:
                raise DAGError(f"edge {from_id}->{to_id} exists")
            if self._reachable(dst, src):
                raise CycleError(f"edge {from_id}->{to_id} creates a cycle")
            src.children[to_id] = dst
            dst.parents[from_id] = src

    def delete_edge(self, from_id: str, to_id: str) -> None:
        with self._mu:
            src = self._v.get(from_id)
            dst = self._v.get(to_id)
            if src is None or dst is None:
                return
            src.children.pop(to_id, None)
            dst.parents.pop(from_id, None)

    def delete_vertex_in_edges(self, vid: str) -> None:
        """Drop every parent edge of a vertex (a peer's reschedule detaches
        it from its current parents)."""
        with self._mu:
            v = self._v.get(vid)
            if v is None:
                raise VertexNotFoundError(vid)
            for p in list(v.parents.values()):
                p.children.pop(vid, None)
            v.parents.clear()

    def delete_vertex_out_edges(self, vid: str) -> None:
        with self._mu:
            v = self._v.get(vid)
            if v is None:
                raise VertexNotFoundError(vid)
            for c in list(v.children.values()):
                c.parents.pop(vid, None)
            v.children.clear()

    def can_add_edge(self, from_id: str, to_id: str) -> bool:
        with self._mu:
            src = self._v.get(from_id)
            dst = self._v.get(to_id)
            if src is None or dst is None or from_id == to_id:
                return False
            if to_id in src.children:
                return False
            return not self._reachable(dst, src)

    def _reachable(self, start: Vertex[T], target: Vertex[T]) -> bool:
        """Depth-first: is ``target`` reachable from ``start`` along
        children."""
        stack = [start]
        seen: set[str] = set()
        while stack:
            v = stack.pop()
            if v.id == target.id:
                return True
            if v.id in seen:
                continue
            seen.add(v.id)
            stack.extend(v.children.values())
        return False

    def random_vertices(self, n: int) -> list[Vertex[T]]:
        """A random sample of ``n`` vertices (all of them when there are
        no more), drawn from the DAG's generator."""
        with self._mu:
            m = len(self._order)
            if n >= m:
                sample = list(self._order)
            else:
                sample = [self._order[i]
                          for i in self._rng.sample(range(m), n)]
            return [self._v[i] for i in sample]

    def find_value(self, pred) -> "T | None":
        """The first vertex value matching ``pred``, in insertion order,
        with an early exit; ``pred`` must not edit the DAG."""
        with self._mu:
            for v in self._v.values():
                if pred(v.value):
                    return v.value
            return None

    def values(self) -> Iterator[T]:
        with self._mu:
            vs = list(self._v.values())
        for v in vs:
            yield v.value
