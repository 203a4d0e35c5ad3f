"""The persistent-cache resource: durable task, peer and host records with
replica management. The port's copy of
``dragonfly2_tpu/scheduler/resource/persistentcache.py``, on the same
sqlite schema.

A persistent cache task is a dfcache entry (the task id of
``dfcache://{id}``) whose desired ``replica_count`` the scheduler
enforces: when the uploader finishes, the scheduler fans download
triggers to other hosts until enough persistent replicas exist, and
checks again when hosts leave. The records survive a scheduler restart,
unlike the in-memory standard resource.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time

from dragonfly2_tpu_torch.pkg import dflog

log = dflog.get("scheduler.persistentcache")

STATE_PENDING = "pending"
STATE_UPLOADING = "uploading"
STATE_SUCCEEDED = "succeeded"
STATE_FAILED = "failed"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS pc_tasks (
  task_id TEXT PRIMARY KEY,
  url TEXT DEFAULT '',
  tag TEXT DEFAULT '',
  application TEXT DEFAULT '',
  piece_size INTEGER DEFAULT 0,
  content_length INTEGER DEFAULT -1,
  total_piece_count INTEGER DEFAULT -1,
  replica_count INTEGER DEFAULT 1,
  ttl REAL DEFAULT 0,
  digest TEXT DEFAULT '',
  state TEXT DEFAULT 'pending',
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS pc_peers (
  peer_id TEXT PRIMARY KEY,
  task_id TEXT NOT NULL,
  host_id TEXT NOT NULL,
  persistent INTEGER DEFAULT 1,
  state TEXT DEFAULT 'pending',
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS pc_hosts (
  host_id TEXT PRIMARY KEY,
  hostname TEXT DEFAULT '',
  ip TEXT DEFAULT '',
  port INTEGER DEFAULT 0,
  upload_port INTEGER DEFAULT 0,
  info JSON DEFAULT '{}',
  updated_at REAL
);
CREATE INDEX IF NOT EXISTS pc_peers_task ON pc_peers(task_id);
"""


class PersistentCacheResource:
    """sqlite-backed persistent cache state. All methods are synchronous —
    row counts are small and sqlite is local."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.executescript(_SCHEMA)
        self._lock = threading.Lock()

    def close(self) -> None:
        self._conn.close()

    def _exec(self, sql: str, args=()) -> sqlite3.Cursor:
        with self._lock:
            cur = self._conn.execute(sql, args)
            self._conn.commit()
            return cur

    # -- tasks -------------------------------------------------------------

    def upsert_task(self, task_id: str, **fields) -> dict:
        now = time.time()
        existing = self.get_task(task_id)
        if existing is None:
            cols = {"task_id": task_id, "created_at": now, "updated_at": now,
                    **fields}
            names = ",".join(cols)
            self._exec(
                f"INSERT INTO pc_tasks ({names}) VALUES "
                f"({','.join('?' * len(cols))})", list(cols.values()))
        elif fields:
            sets = ",".join(f"{k}=?" for k in fields)
            self._exec(f"UPDATE pc_tasks SET {sets}, updated_at=? "
                       f"WHERE task_id=?",
                       [*fields.values(), now, task_id])
        return self.get_task(task_id)

    def get_task(self, task_id: str) -> dict | None:
        row = self._exec("SELECT * FROM pc_tasks WHERE task_id=?",
                         (task_id,)).fetchone()
        return dict(row) if row else None

    def list_tasks(self, state: str = "") -> list[dict]:
        if state:
            rows = self._exec("SELECT * FROM pc_tasks WHERE state=?",
                              (state,)).fetchall()
        else:
            rows = self._exec("SELECT * FROM pc_tasks").fetchall()
        return [dict(r) for r in rows]

    def delete_task(self, task_id: str) -> None:
        self._exec("DELETE FROM pc_peers WHERE task_id=?", (task_id,))
        self._exec("DELETE FROM pc_tasks WHERE task_id=?", (task_id,))

    def expired_tasks(self, now: float | None = None) -> list[dict]:
        now = now if now is not None else time.time()
        rows = self._exec(
            "SELECT * FROM pc_tasks WHERE ttl > 0 AND created_at + ttl < ?",
            (now,)).fetchall()
        return [dict(r) for r in rows]

    # -- peers (replicas) --------------------------------------------------

    def upsert_peer(self, peer_id: str, task_id: str, host_id: str, *,
                    persistent: bool = True,
                    state: str = STATE_PENDING) -> None:
        now = time.time()
        self._exec(
            "INSERT INTO pc_peers (peer_id, task_id, host_id, persistent,"
            " state, created_at, updated_at) VALUES (?,?,?,?,?,?,?) "
            "ON CONFLICT(peer_id) DO UPDATE SET state=excluded.state,"
            " persistent=excluded.persistent, updated_at=excluded.updated_at",
            (peer_id, task_id, host_id, int(persistent), state, now, now))

    def peers_of(self, task_id: str, state: str = "") -> list[dict]:
        if state:
            rows = self._exec(
                "SELECT * FROM pc_peers WHERE task_id=? AND state=?",
                (task_id, state)).fetchall()
        else:
            rows = self._exec("SELECT * FROM pc_peers WHERE task_id=?",
                              (task_id,)).fetchall()
        return [dict(r) for r in rows]

    def delete_peer_if_not_succeeded(self, peer_id: str) -> None:
        """Drop a failed uploader's row without touching healthy replicas."""
        self._exec("DELETE FROM pc_peers WHERE peer_id=? AND state != ?",
                   (peer_id, STATE_SUCCEEDED))

    def delete_peers_of_host(self, host_id: str) -> list[str]:
        """Remove a departing host's replicas; returns affected task ids."""
        rows = self._exec("SELECT DISTINCT task_id FROM pc_peers WHERE host_id=?",
                          (host_id,)).fetchall()
        self._exec("DELETE FROM pc_peers WHERE host_id=?", (host_id,))
        return [r["task_id"] for r in rows]

    def replica_count(self, task_id: str) -> int:
        row = self._exec(
            "SELECT COUNT(*) AS n FROM pc_peers WHERE task_id=? AND state=?",
            (task_id, STATE_SUCCEEDED)).fetchone()
        return row["n"]

    # -- hosts -------------------------------------------------------------

    def upsert_host(self, host_id: str, *, hostname: str = "", ip: str = "",
                    port: int = 0, upload_port: int = 0,
                    info: dict | None = None) -> None:
        self._exec(
            "INSERT INTO pc_hosts (host_id, hostname, ip, port, upload_port,"
            " info, updated_at) VALUES (?,?,?,?,?,?,?) "
            "ON CONFLICT(host_id) DO UPDATE SET hostname=excluded.hostname,"
            " ip=excluded.ip, port=excluded.port,"
            " upload_port=excluded.upload_port, info=excluded.info,"
            " updated_at=excluded.updated_at",
            (host_id, hostname, ip, port, upload_port,
             json.dumps(info or {}), time.time()))

    def get_host(self, host_id: str) -> dict | None:
        row = self._exec("SELECT * FROM pc_hosts WHERE host_id=?",
                         (host_id,)).fetchone()
        return dict(row) if row else None

    def list_hosts(self) -> list[dict]:
        return [dict(r) for r in self._exec("SELECT * FROM pc_hosts").fetchall()]

    def delete_host(self, host_id: str) -> None:
        self._exec("DELETE FROM pc_hosts WHERE host_id=?", (host_id,))

    # -- wire --------------------------------------------------------------

    def task_wire(self, task_id: str) -> dict | None:
        task = self.get_task(task_id)
        if task is None:
            return None
        peers = self.peers_of(task_id)
        return {
            **task,
            "current_replicas": self.replica_count(task_id),
            "peers": [{"peer_id": p["peer_id"], "host_id": p["host_id"],
                       "state": p["state"], "persistent": bool(p["persistent"])}
                      for p in peers],
        }
