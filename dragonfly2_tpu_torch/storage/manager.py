"""Storage manager, the registry of task stores with reload and quota
GC: the port's copy of ``dragonfly2_tpu/storage/manager.py``.

The stores live at ``<data_dir>/tasks/<task_id[:3]>/<task_id>``, as the
JAX package lays them out, so either package's ``reload`` restores the
other's. ``gc`` (the daemon runs it every ``gc_interval``) also closes
the data-file descriptor of a store idle longer than ``fd_idle_close``
(``gc_interval`` when 0); the store reopens it at its next read. Not
ported: the serving-index observer of the JAX native upload server.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.errors import Code, StorageError
from dragonfly2_tpu_torch.storage.local_store import (
    LocalTaskStore,
    TaskStoreMetadata,
)

log = dflog.get("storage")


@dataclass
class StorageOption:
    data_dir: str
    task_ttl: float = 3 * 60 * 60.0          # reference DataExpireTime default
    disk_gc_threshold: int = 0               # bytes; 0 = unlimited
    gc_interval: float = 60.0
    # Idle seconds before an un-expired store drops its data-file fd (lazily
    # reopened). 0 = follow gc_interval.
    fd_idle_close: float = 0.0


class StorageManager:
    def __init__(self, opt: StorageOption):
        self.opt = opt
        self._stores: dict[str, LocalTaskStore] = {}
        os.makedirs(opt.data_dir, exist_ok=True)

    # -- paths -------------------------------------------------------------

    def _task_dir(self, task_id: str) -> str:
        return os.path.join(self.opt.data_dir, "tasks", task_id[:3], task_id)

    # -- registration ------------------------------------------------------

    def register_task(self, metadata: TaskStoreMetadata) -> LocalTaskStore:
        store = self._stores.get(metadata.task_id)
        if store is not None:
            if store.metadata.invalid:
                # A failed attempt poisoned this store; retries must start
                # clean rather than resume over untrusted pieces.
                self.delete_task(metadata.task_id)
            else:
                store.touch()
                return store
        store = LocalTaskStore.create(self._task_dir(metadata.task_id),
                                      metadata)
        self._stores[metadata.task_id] = store
        return store

    def get(self, task_id: str) -> LocalTaskStore:
        store = self._stores.get(task_id)
        if store is None:
            raise StorageError(f"task {task_id} not registered", Code.StorageTaskNotFound)
        return store

    def try_get(self, task_id: str) -> LocalTaskStore | None:
        return self._stores.get(task_id)

    def delete_task(self, task_id: str) -> None:
        store = self._stores.pop(task_id, None)
        if store is not None:
            store.destroy()

    def tasks(self) -> list[LocalTaskStore]:
        return list(self._stores.values())

    # -- reuse lookups ---------------------------------------------------

    def find_completed_task(self, task_id: str) -> LocalTaskStore | None:
        store = self._stores.get(task_id)
        if store is not None and store.metadata.done and not store.metadata.invalid:
            store.touch()
            return store
        return None

    def find_partial_completed_task(self, task_id: str) -> LocalTaskStore | None:
        store = self._stores.get(task_id)
        if store is not None and not store.metadata.invalid and store.metadata.pieces:
            store.touch()
            return store
        return None

    # -- reload ----------------------------------------------------------

    def reload(self) -> int:
        """Restore task stores from disk after a daemon restart. Invalid or
        unreadable dirs are swept. Returns the number of restored tasks."""
        root = os.path.join(self.opt.data_dir, "tasks")
        if not os.path.isdir(root):
            return 0
        restored = 0
        for prefix in os.listdir(root):
            pdir = os.path.join(root, prefix)
            if not os.path.isdir(pdir):
                continue
            for task_id in os.listdir(pdir):
                tdir = os.path.join(pdir, task_id)
                try:
                    store = LocalTaskStore.load(tdir)
                except Exception as e:
                    log.warning("sweeping unreadable task dir", dir=tdir,
                                error=str(e))
                    shutil.rmtree(tdir, ignore_errors=True)
                    continue
                if store.metadata.invalid:
                    store.destroy()
                    continue
                self._stores[store.metadata.task_id] = store
                restored += 1
        if restored:
            log.info("reloaded task stores", count=restored)
        return restored

    # -- GC ---------------------------------------------------------------

    def gc(self) -> list[str]:
        """TTL sweep + LRU eviction under the disk quota. Returns reclaimed
        task IDs."""
        now = time.time()
        reclaimed: list[str] = []
        for task_id, store in list(self._stores.items()):
            if store.pinned:
                continue  # active download/upload; never yank mid-flight
            m = store.metadata
            if m.invalid or (now - m.last_access) > self.opt.task_ttl:
                self.delete_task(task_id)
                reclaimed.append(task_id)
                continue
            # Without this a long-lived daemon holds one fd per task it
            # ever served until the task's TTL delete.
            idle_close = self.opt.fd_idle_close or self.opt.gc_interval
            if now - m.last_access > idle_close:
                store.close()
        if self.opt.disk_gc_threshold > 0:
            usage = sum(s.disk_usage() for s in self._stores.values())
            if usage > self.opt.disk_gc_threshold:
                # Oldest-access first until under quota.
                by_lru = sorted(self._stores.values(), key=lambda s: s.metadata.last_access)
                for store in by_lru:
                    if usage <= self.opt.disk_gc_threshold:
                        break
                    if store.pinned:
                        continue
                    usage -= store.disk_usage()
                    reclaimed.append(store.metadata.task_id)
                    self.delete_task(store.metadata.task_id)
        if reclaimed:
            log.info("storage gc reclaimed", count=len(reclaimed))
        return reclaimed

    def total_disk_usage(self) -> int:
        return sum(s.disk_usage() for s in self._stores.values())

    def close(self) -> None:
        """Close every store's fd; the data stays on disk for ``reload``."""
        for store in self._stores.values():
            store.close()
