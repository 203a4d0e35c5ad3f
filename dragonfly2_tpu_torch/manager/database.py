"""The manager's relational store: the port's copy of
``dragonfly2_tpu/manager/database.py`` on ``sqlite3``, with the same
tables, columns, JSON columns and dict rows.

A row is a dict of its columns; the JSON columns (``_JSON_COLS``) are
decoded on read. ``insert`` and ``update`` stamp ``created_at`` and
``updated_at`` where the table has them.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from typing import Any, Iterable

# The model surface; the scheduler cluster <-> seed-peer cluster relation
# is a join table.
_SCHEMA = """
CREATE TABLE IF NOT EXISTS scheduler_clusters (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  bio TEXT DEFAULT '',
  config JSON DEFAULT '{}',
  client_config JSON DEFAULT '{}',
  scopes JSON DEFAULT '{}',
  is_default INTEGER DEFAULT 0,
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS schedulers (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  hostname TEXT NOT NULL,
  idc TEXT DEFAULT '',
  location TEXT DEFAULT '',
  ip TEXT NOT NULL,
  port INTEGER NOT NULL,
  state TEXT DEFAULT 'inactive',
  features JSON DEFAULT '[]',
  scheduler_cluster_id INTEGER NOT NULL,
  last_keepalive_at REAL DEFAULT 0,
  created_at REAL, updated_at REAL,
  UNIQUE(hostname, ip, scheduler_cluster_id)
);
CREATE TABLE IF NOT EXISTS seed_peer_clusters (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  bio TEXT DEFAULT '',
  config JSON DEFAULT '{}',
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS scheduler_cluster_seed_peer_cluster (
  scheduler_cluster_id INTEGER NOT NULL,
  seed_peer_cluster_id INTEGER NOT NULL,
  UNIQUE(scheduler_cluster_id, seed_peer_cluster_id)
);
CREATE TABLE IF NOT EXISTS seed_peers (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  hostname TEXT NOT NULL,
  type TEXT DEFAULT 'super',
  idc TEXT DEFAULT '',
  location TEXT DEFAULT '',
  ip TEXT NOT NULL,
  port INTEGER NOT NULL,
  download_port INTEGER DEFAULT 0,
  object_storage_port INTEGER DEFAULT 0,
  state TEXT DEFAULT 'inactive',
  seed_peer_cluster_id INTEGER NOT NULL,
  last_keepalive_at REAL DEFAULT 0,
  created_at REAL, updated_at REAL,
  UNIQUE(hostname, ip, seed_peer_cluster_id)
);
CREATE TABLE IF NOT EXISTS peers (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  hostname TEXT NOT NULL,
  type TEXT DEFAULT 'normal',
  idc TEXT DEFAULT '',
  location TEXT DEFAULT '',
  ip TEXT NOT NULL,
  port INTEGER DEFAULT 0,
  download_port INTEGER DEFAULT 0,
  object_storage_port INTEGER DEFAULT 0,
  state TEXT DEFAULT 'active',
  os TEXT DEFAULT '', platform TEXT DEFAULT '',
  platform_family TEXT DEFAULT '', platform_version TEXT DEFAULT '',
  kernel_version TEXT DEFAULT '',
  git_version TEXT DEFAULT '', git_commit TEXT DEFAULT '',
  build_platform TEXT DEFAULT '',
  scheduler_cluster_id INTEGER DEFAULT 0,
  created_at REAL, updated_at REAL,
  UNIQUE(hostname, ip, scheduler_cluster_id)
);
CREATE TABLE IF NOT EXISTS users (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  encrypted_password TEXT NOT NULL,
  email TEXT DEFAULT '',
  phone TEXT DEFAULT '',
  avatar TEXT DEFAULT '',
  location TEXT DEFAULT '',
  bio TEXT DEFAULT '',
  state TEXT DEFAULT 'enabled',
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS user_roles (
  user_id INTEGER NOT NULL,
  role TEXT NOT NULL,
  UNIQUE(user_id, role)
);
CREATE TABLE IF NOT EXISTS applications (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  url TEXT DEFAULT '',
  bio TEXT DEFAULT '',
  priority JSON DEFAULT '{}',
  user_id INTEGER DEFAULT 0,
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS configs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  value TEXT DEFAULT '',
  bio TEXT DEFAULT '',
  user_id INTEGER DEFAULT 0,
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS personal_access_tokens (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  token TEXT NOT NULL UNIQUE,
  bio TEXT DEFAULT '',
  scopes JSON DEFAULT '[]',
  state TEXT DEFAULT 'active',
  expired_at REAL DEFAULT 0,
  user_id INTEGER DEFAULT 0,
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS oauth (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  bio TEXT DEFAULT '',
  client_id TEXT DEFAULT '',
  client_secret TEXT DEFAULT '',
  redirect_url TEXT DEFAULT '',
  auth_url TEXT DEFAULT '',
  token_url TEXT DEFAULT '',
  user_info_url TEXT DEFAULT '',
  scopes TEXT DEFAULT '',
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS jobs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  task_id TEXT DEFAULT '',
  bio TEXT DEFAULT '',
  type TEXT NOT NULL,
  state TEXT DEFAULT 'PENDING',
  args JSON DEFAULT '{}',
  result JSON DEFAULT '{}',
  user_id INTEGER DEFAULT 0,
  scheduler_cluster_ids JSON DEFAULT '[]',
  created_at REAL, updated_at REAL
);
CREATE TABLE IF NOT EXISTS buckets (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  created_at REAL, updated_at REAL
);
"""

# Columns stored as JSON text, decoded on read.
_JSON_COLS = {
    "scheduler_clusters": {"config", "client_config", "scopes"},
    "schedulers": {"features"},
    "seed_peer_clusters": {"config"},
    "applications": {"priority"},
    "personal_access_tokens": {"scopes"},
    "jobs": {"args", "result", "scheduler_cluster_ids"},
}


class Database:
    """Dict-row CRUD over sqlite3, thread-safe under one lock."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.executescript(_SCHEMA)
        self._lock = threading.RLock()
        self._columns: dict[str, set[str]] = {}

    def _cols(self, table: str) -> set[str]:
        if table not in self._columns:
            rows = self._conn.execute(f"PRAGMA table_info({table})").fetchall()
            self._columns[table] = {r["name"] for r in rows}
        return self._columns[table]

    def close(self) -> None:
        self._conn.close()

    # -- generic CRUD ------------------------------------------------------

    def _encode(self, table: str, values: dict[str, Any]) -> dict[str, Any]:
        jcols = _JSON_COLS.get(table, set())
        return {k: (json.dumps(v) if k in jcols else v) for k, v in values.items()}

    def _decode(self, table: str, row: sqlite3.Row | None) -> dict[str, Any] | None:
        if row is None:
            return None
        jcols = _JSON_COLS.get(table, set())
        out = dict(row)
        for k in jcols:
            if k in out and isinstance(out[k], str):
                try:
                    out[k] = json.loads(out[k])
                except ValueError:
                    pass
        return out

    def insert(self, table: str, values: dict[str, Any]) -> dict[str, Any]:
        now = time.time()
        values = dict(values)
        if "created_at" in self._cols(table):
            values.setdefault("created_at", now)
            values.setdefault("updated_at", now)
        enc = self._encode(table, values)
        cols = ", ".join(enc)
        ph = ", ".join("?" for _ in enc)
        with self._lock:
            cur = self._conn.execute(
                f"INSERT INTO {table} ({cols}) VALUES ({ph})", list(enc.values()))
            self._conn.commit()
            if "id" not in self._cols(table):
                return dict(values)
            return self.get(table, cur.lastrowid)

    def get(self, table: str, row_id: int) -> dict[str, Any] | None:
        with self._lock:
            row = self._conn.execute(
                f"SELECT * FROM {table} WHERE id = ?", (row_id,)).fetchone()
        return self._decode(table, row)

    def find(self, table: str, **where: Any) -> dict[str, Any] | None:
        rows = self.list(table, limit=1, **where)
        return rows[0] if rows else None

    def list(self, table: str, limit: int = 0, offset: int = 0,
             order_by: str = "rowid", **where: Any) -> list[dict[str, Any]]:
        sql = f"SELECT * FROM {table}"
        args: list[Any] = []
        if where:
            conds = []
            for k, v in where.items():
                conds.append(f"{k} = ?")
                args.append(v)
            sql += " WHERE " + " AND ".join(conds)
        sql += f" ORDER BY {order_by}"
        if limit:
            sql += " LIMIT ? OFFSET ?"
            args += [limit, offset]
        with self._lock:
            rows = self._conn.execute(sql, args).fetchall()
        return [self._decode(table, r) for r in rows]

    def count(self, table: str, **where: Any) -> int:
        sql = f"SELECT COUNT(*) FROM {table}"
        args: list[Any] = []
        if where:
            sql += " WHERE " + " AND ".join(f"{k} = ?" for k in where)
            args = list(where.values())
        with self._lock:
            return self._conn.execute(sql, args).fetchone()[0]

    def update(self, table: str, row_id: int, values: dict[str, Any]) -> dict[str, Any] | None:
        if not values:
            return self.get(table, row_id)
        values = dict(values)
        if "updated_at" in self._cols(table):
            values["updated_at"] = time.time()
        enc = self._encode(table, values)
        sets = ", ".join(f"{k} = ?" for k in enc)
        with self._lock:
            self._conn.execute(
                f"UPDATE {table} SET {sets} WHERE id = ?", [*enc.values(), row_id])
            self._conn.commit()
        return self.get(table, row_id)

    def delete(self, table: str, row_id: int) -> bool:
        with self._lock:
            cur = self._conn.execute(f"DELETE FROM {table} WHERE id = ?", (row_id,))
            self._conn.commit()
            return cur.rowcount > 0

    def execute(self, sql: str, args: Iterable[Any] = ()) -> list[sqlite3.Row]:
        with self._lock:
            rows = self._conn.execute(sql, list(args)).fetchall()
            self._conn.commit()
            return rows

    # -- relations ---------------------------------------------------------

    def link_seed_peer_cluster(self, scheduler_cluster_id: int,
                               seed_peer_cluster_id: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR IGNORE INTO scheduler_cluster_seed_peer_cluster VALUES (?, ?)",
                (scheduler_cluster_id, seed_peer_cluster_id))
            self._conn.commit()

    def seed_peer_clusters_of(self, scheduler_cluster_id: int) -> list[int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT seed_peer_cluster_id FROM scheduler_cluster_seed_peer_cluster "
                "WHERE scheduler_cluster_id = ?", (scheduler_cluster_id,)).fetchall()
        return [r[0] for r in rows]
