"""The durable scheduler snapshot, bounded task, peer and host state for
HA: the port's copy of ``dragonfly2_tpu/scheduler/resource/snapshot.py``.

The same sqlite schema and the same piece bitmaps, so the port's and the
JAX package's schedulers restore each other's snapshot files.

Contract: a snapshot load followed by resume re-registrations converges
to the same Task and Peer state as re-registration into an empty
scheduler. That shapes what is written:

  - peers only in RUNNING or SUCCEEDED, the states the live
    re-registration paths can reproduce;
  - tasks only when at least one such peer holds them;
  - no task piece metadata: the restore rebuilds it from the peers'
    bitsets through the same apply path that live resume uses.

Piece bitsets are stored as bitmap blobs (a 25k-piece task costs about
3 KiB a peer).
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time

from dragonfly2_tpu_torch.pkg import dflog

log = dflog.get("scheduler.snapshot")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS snap_meta (
  k TEXT PRIMARY KEY, v TEXT
);
CREATE TABLE IF NOT EXISTS snap_hosts (
  host_id TEXT PRIMARY KEY,
  wire TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS snap_tasks (
  task_id TEXT PRIMARY KEY,
  url TEXT DEFAULT '',
  tag TEXT DEFAULT '',
  application TEXT DEFAULT '',
  digest TEXT DEFAULT '',
  range_header TEXT DEFAULT '',
  content_length INTEGER DEFAULT -1,
  piece_size INTEGER DEFAULT 0,
  total_piece_count INTEGER DEFAULT -1,
  state TEXT DEFAULT 'pending',
  updated_at REAL
);
CREATE TABLE IF NOT EXISTS snap_peers (
  peer_id TEXT PRIMARY KEY,
  task_id TEXT NOT NULL,
  host_id TEXT NOT NULL,
  state TEXT NOT NULL,
  pieces BLOB,
  pod_broadcast INTEGER DEFAULT 0,
  is_seed INTEGER DEFAULT 0,
  priority INTEGER DEFAULT 3,
  range_header TEXT DEFAULT ''
);
CREATE INDEX IF NOT EXISTS snap_peers_task ON snap_peers(task_id);
"""


def pieces_to_blob(nums) -> bytes:
    """Piece-number set → bitmap blob (bit n set ⇔ piece n landed)."""
    if not nums:
        return b""
    top = max(nums)
    buf = bytearray(top // 8 + 1)
    for n in nums:
        buf[n >> 3] |= 1 << (n & 7)
    return bytes(buf)


def blob_to_pieces(blob: bytes) -> list[int]:
    out: list[int] = []
    for i, byte in enumerate(blob or b""):
        if not byte:
            continue
        base = i << 3
        for bit in range(8):
            if byte & (1 << bit):
                out.append(base + bit)
    return out


class SnapshotStore:
    """sqlite-backed snapshot rows. Synchronous — each flush is one
    bounded transaction; row counts are capped by HAConfig."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.executescript(_SCHEMA)
        self._lock = threading.Lock()

    def close(self) -> None:
        self._conn.close()

    # -- save --------------------------------------------------------------

    def save(self, hosts, tasks, peers, *, max_tasks: int = 1024,
             max_peers: int = 65536) -> dict:
        """Replace the snapshot with the current live state. ``peers`` is
        every live peer; only RUNNING/SUCCEEDED ones are written (see
        module docstring), newest tasks win the ``max_tasks`` cap."""
        from dragonfly2_tpu_torch.scheduler.resource.peer import PeerState

        eligible = [p for p in peers
                    if p.fsm.current in (PeerState.RUNNING,
                                         PeerState.SUCCEEDED)]
        by_task: dict[str, list] = {}
        for p in eligible:
            by_task.setdefault(p.task.id, []).append(p)
        kept_tasks = sorted(
            (t for t in tasks if t.id in by_task),
            key=lambda t: t.updated_at, reverse=True)[:max_tasks]
        kept_ids = {t.id for t in kept_tasks}
        peer_rows = []
        for tid in kept_ids:
            peer_rows.extend(by_task[tid])
        peer_rows = peer_rows[:max_peers]
        host_ids = {p.host.id for p in peer_rows}
        kept_hosts = [h for h in hosts if h.id in host_ids]

        with self._lock:
            cur = self._conn
            cur.execute("BEGIN")
            try:
                cur.execute("DELETE FROM snap_hosts")
                cur.execute("DELETE FROM snap_tasks")
                cur.execute("DELETE FROM snap_peers")
                cur.executemany(
                    "INSERT INTO snap_hosts (host_id, wire) VALUES (?,?)",
                    [(h.id, json.dumps(h.to_wire())) for h in kept_hosts])
                # Task state is NORMALIZED to what its written peers back:
                # "succeeded" only when a durable SUCCEEDED holder is in
                # the snapshot, else "running". A task FSM that says
                # SUCCEEDED because a long-gone peer once finished would
                # restore a claim no live holder backs — and it is what
                # keeps snapshot-load ∘ re-registration convergent with
                # pure re-registration (the property test's contract).
                cur.executemany(
                    "INSERT INTO snap_tasks (task_id, url, tag, application,"
                    " digest, range_header, content_length, piece_size,"
                    " total_piece_count, state, updated_at)"
                    " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                    [(t.id, t.url, t.tag, t.application, t.digest,
                      t.range_header, t.content_length, t.piece_size,
                      t.total_piece_count,
                      "succeeded" if any(
                          p.fsm.current == PeerState.SUCCEEDED
                          for p in by_task[t.id]) else "running",
                      t.updated_at)
                     for t in kept_tasks])
                cur.executemany(
                    "INSERT INTO snap_peers (peer_id, task_id, host_id,"
                    " state, pieces, pod_broadcast, is_seed, priority,"
                    " range_header) VALUES (?,?,?,?,?,?,?,?,?)",
                    [(p.id, p.task.id, p.host.id, p.fsm.current,
                      pieces_to_blob(p.finished_pieces),
                      int(p.pod_broadcast), int(p.is_seed), p.priority,
                      p.range_header)
                     for p in peer_rows])
                cur.execute(
                    "INSERT INTO snap_meta (k, v) VALUES ('saved_at', ?)"
                    " ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                    (repr(time.time()),))
                cur.execute("COMMIT")
            except BaseException:
                cur.execute("ROLLBACK")
                raise
        return {"hosts": len(kept_hosts), "tasks": len(kept_tasks),
                "peers": len(peer_rows)}

    # -- load --------------------------------------------------------------

    def load(self) -> dict:
        """All snapshot rows, decoded; the service layer rebuilds the live
        objects (scheduler/service.restore_from_snapshot)."""
        with self._lock:
            hosts = [json.loads(r["wire"]) for r in self._conn.execute(
                "SELECT wire FROM snap_hosts").fetchall()]
            tasks = [dict(r) for r in self._conn.execute(
                "SELECT * FROM snap_tasks").fetchall()]
            peers = []
            for r in self._conn.execute("SELECT * FROM snap_peers"):
                row = dict(r)
                row["piece_nums"] = blob_to_pieces(row.pop("pieces"))
                peers.append(row)
            meta = self._conn.execute(
                "SELECT v FROM snap_meta WHERE k='saved_at'").fetchone()
        return {"hosts": hosts, "tasks": tasks, "peers": peers,
                "saved_at": float(meta["v"]) if meta else 0.0}
