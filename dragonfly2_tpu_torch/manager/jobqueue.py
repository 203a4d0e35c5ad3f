"""The manager's job queue: the port's copy of
``dragonfly2_tpu/manager/jobqueue.py``.

One ``asyncio.Queue`` a scheduler cluster (``scheduler_<id>``); a job
fans out one item a cluster, each with a task uuid of its own, and the
cluster's scheduler long-polls it over drpc (``Manager.PollJob``) and
reports back (``Manager.CompleteJob``). The job row's state and its
``group_results`` follow the members' completions. The queues live on
the manager's event loop: every caller runs there (the REST handlers
are sent onto it, ``manager/rest.py``). Delivery is at least once: a
restart re-enqueues every unfinished job of a durable database.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from dragonfly2_tpu_torch.manager.database import Database
from dragonfly2_tpu_torch.pkg import dflog

log = dflog.get("manager.jobqueue")

# Job states.
PENDING = "PENDING"
STARTED = "STARTED"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"

# Job types.
PREHEAT_JOB = "preheat"
SYNC_PEERS_JOB = "sync_peers"
GET_TASK_JOB = "get_task"
DELETE_TASK_JOB = "delete_task"


def queue_name(scheduler_cluster_id: int) -> str:
    """The queue of a scheduler cluster."""
    return f"scheduler_{scheduler_cluster_id}"


@dataclass
class QueueItem:
    group_id: str
    job_id: int
    task_uuid: str
    type: str
    args: dict[str, Any]
    queue: str
    enqueued_at: float = field(default_factory=time.time)

    def to_wire(self) -> dict[str, Any]:
        return {
            "group_id": self.group_id, "job_id": self.job_id,
            "task_uuid": self.task_uuid, "type": self.type,
            "args": self.args, "queue": self.queue,
        }


class JobQueue:
    """Per-queue FIFO with long-poll waiters plus group-result aggregation
    persisted into the jobs table."""

    def __init__(self, db: Database):
        self.db = db
        self._queues: dict[str, asyncio.Queue[QueueItem]] = {}
        self._pending_members: dict[str, set[str]] = {}   # group_id -> task uuids
        self._group_results: dict[str, list[dict]] = {}
        self._recover()

    def _recover(self) -> None:
        """Re-enqueue unfinished jobs found in a persistent DB after restart
        (queue state is memory-only; job rows are durable). At-least-once:
        every member cluster gets the work again with fresh task uuids."""
        for state in (PENDING, STARTED):
            for job in self.db.list("jobs", state=state):
                if self._fanout(job, job.get("scheduler_cluster_ids") or []):
                    self.db.update("jobs", job["id"], {"state": PENDING})
                    log.info("job recovered after restart", job_id=job["id"])

    def _fanout(self, job: dict[str, Any], scheduler_cluster_ids: list[int]) -> bool:
        """Fan one queue item per cluster and arm the group bookkeeping."""
        group_id = job["task_id"]
        members: set[str] = set()
        for cid in scheduler_cluster_ids:
            item = QueueItem(group_id=group_id, job_id=job["id"],
                             task_uuid=uuid.uuid4().hex, type=job["type"],
                             args=job.get("args", {}), queue=queue_name(cid))
            members.add(item.task_uuid)
            self._q(item.queue).put_nowait(item)
        if members:
            self._pending_members[group_id] = members
            self._group_results[group_id] = []
        return bool(members)

    def _q(self, name: str) -> asyncio.Queue[QueueItem]:
        if name not in self._queues:
            self._queues[name] = asyncio.Queue()
        return self._queues[name]

    def enqueue_job(self, job_type: str, args: dict[str, Any],
                    scheduler_cluster_ids: list[int], user_id: int = 0,
                    bio: str = "") -> dict[str, Any]:
        """Create the job row and fan one queue item out per cluster."""
        group_id = uuid.uuid4().hex
        job = self.db.insert("jobs", {
            "task_id": group_id, "type": job_type, "state": PENDING,
            "args": args, "user_id": user_id, "bio": bio,
            "scheduler_cluster_ids": scheduler_cluster_ids,
        })
        self._fanout(job, scheduler_cluster_ids)
        log.info("job enqueued", job_id=job["id"], type=job_type,
                 clusters=scheduler_cluster_ids)
        return job

    async def poll(self, queue: str, timeout: float = 30.0) -> QueueItem | None:
        """Long-poll one item; None on timeout (consumer re-polls)."""
        try:
            item = await asyncio.wait_for(self._q(queue).get(), timeout)
        except asyncio.TimeoutError:
            return None
        self.db.update("jobs", item.job_id, {"state": STARTED})
        return item

    def complete(self, group_id: str, task_uuid: str, state: str,
                 result: dict[str, Any]) -> None:
        members = self._pending_members.get(group_id)
        if members is None or task_uuid not in members:
            log.warning("unknown job completion", group_id=group_id, task=task_uuid)
            return
        members.discard(task_uuid)
        self._group_results[group_id].append({**result, "state": state})
        if not members:
            results = self._group_results.pop(group_id)
            self._pending_members.pop(group_id, None)
            job = self.db.find("jobs", task_id=group_id)
            if job:
                final = SUCCESS if all(r["state"] == SUCCESS for r in results) else FAILURE
                self.db.update("jobs", job["id"], {
                    "state": final, "result": {"group_results": results}})
                log.info("job finished", job_id=job["id"], state=final)
