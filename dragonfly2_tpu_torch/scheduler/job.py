"""The scheduler's job worker: the port's copy of
``dragonfly2_tpu/scheduler/job.py``.

It long-polls the manager's queue of its cluster (``Manager.PollJob``,
30 s), runs each job against the live resource model and reports it
(``Manager.CompleteJob``): a preheat (one ``Peer.TriggerDownloadTask`` a
target host of its scope, single seed peer, all seed peers or all
peers, for each URL and byte span, then a wait for the task to succeed;
``device: "tpu"`` lands it in each target's device sink), sync peers
(the host inventory up to the manager's peers table), and get or delete
a task at the hosts that hold it.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

from dragonfly2_tpu_torch.pkg import dflog, idgen
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.scheduler.resource import TaskState

log = dflog.get("scheduler.job")

# Job types and states: the wire constants of manager/jobqueue.py.
PREHEAT_JOB = "preheat"
SYNC_PEERS_JOB = "sync_peers"
GET_TASK_JOB = "get_task"
DELETE_TASK_JOB = "delete_task"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"

SCOPE_SINGLE_SEED = "single_seed_peer"
SCOPE_ALL_SEEDS = "all_seed_peers"
SCOPE_ALL_PEERS = "all_peers"


class JobWorker:
    """Long-polls the manager job queue for this scheduler's cluster and
    executes jobs against the live resource model."""

    def __init__(self, service, manager_client, scheduler_cluster_id: int,
                 *, poll_timeout: float = 30.0):
        self.service = service
        self.manager = manager_client
        self.cluster_id = scheduler_cluster_id
        self.queue = f"scheduler_{scheduler_cluster_id}"
        self.poll_timeout = poll_timeout
        self._task: asyncio.Task | None = None

    def serve(self) -> None:
        self._task = asyncio.create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        while True:
            try:
                item = await self.manager.poll_job(self.queue, timeout=self.poll_timeout)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.warning("job poll failed", error=str(e))
                await asyncio.sleep(5.0)
                continue
            if item is None:
                continue
            state, result = await self._execute(item)
            try:
                await self.manager.complete_job(
                    item["group_id"], item["task_uuid"], state, result)
            except Exception as e:
                log.warning("job completion report failed", error=str(e))

    async def _execute(self, item: dict) -> tuple[str, dict]:
        jtype, args = item.get("type", ""), item.get("args") or {}
        log.info("job received", type=jtype, queue=self.queue)
        try:
            if jtype == PREHEAT_JOB:
                return await self._preheat(args)
            if jtype == SYNC_PEERS_JOB:
                return await self._sync_peers(args)
            if jtype == GET_TASK_JOB:
                return await self._get_task(args)
            if jtype == DELETE_TASK_JOB:
                return await self._delete_task(args)
            return FAILURE, {"error": f"unknown job type {jtype!r}"}
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.error("job failed", type=jtype, error=str(e))
            return FAILURE, {"error": str(e)}

    # -- preheat -----------------------------------------------------------

    def _preheat_targets(self, scope: str) -> list:
        hosts = [h for h in self.service.hosts.all() if h.port > 0]
        seeds = [h for h in hosts if h.is_seed()]
        if scope == SCOPE_ALL_PEERS:
            return hosts
        if scope == SCOPE_ALL_SEEDS:
            return seeds
        # A single seed peer: the least loaded (the seed trigger's pick).
        seeds.sort(key=lambda h: len(h.peer_ids))
        return seeds[:1]

    async def _preheat(self, args: dict[str, Any]) -> tuple[str, dict]:
        urls = args.get("urls") or ([args["url"]] if args.get("url") else [])
        if not urls:
            return FAILURE, {"error": "preheat without urls"}
        scope = args.get("scope", SCOPE_SINGLE_SEED)
        timeout = float(args.get("timeout", 60.0))
        targets = self._preheat_targets(scope)
        if not targets:
            return FAILURE, {"error": f"no hosts for scope {scope!r}"}

        tag = args.get("tag", "")
        application = args.get("application", "")
        filters = args.get("filtered_query_params", "")
        if isinstance(filters, list):
            filters = "&".join(filters)
        # A sharded preheat: each span ("a-b" or "bytes=a-b") is a ranged
        # task of its own for each URL. A bad span fails the job here,
        # named: sent on, it would fail inside the daemons' seed tasks
        # after their ACK, and the job would wait out its timeout.
        raw = args.get("ranges")
        if raw is None:
            raw = [args["range"]] if args.get("range") else []
        if isinstance(raw, str) or not isinstance(raw, (list, tuple)):
            return FAILURE, {
                "error": f"ranges must be a list of spans, got {type(raw).__name__}"}
        ranges: list[str] = []
        for r in raw:
            try:
                norm = Range.normalize_header(r) if isinstance(r, str) else ""
                if not norm:
                    raise ValueError("empty span")
            except ValueError as e:
                return FAILURE, {"error": f"bad range {r!r}: {e}"}
            ranges.append(norm)
        if not ranges:
            ranges = [""]

        async def one_url(url: str, rng: str = "") -> dict:
            task_id = idgen.task_id_v1(
                url, tag=tag, application=application, filters=filters,
                range_header=rng)
            spec = {
                "task_id": task_id, "url": url, "tag": tag,
                "application": application,
                "filters": idgen.parse_filtered_query_params(filters),
                "header": args.get("headers") or {},
                # device="tpu": every triggered daemon also lands the
                # content in its device sink (a daemon without one warms
                # its disk only).
                "device": args.get("device", ""),
            }
            if rng:
                spec["range"] = rng
            # A concurrent fan-out: unreachable hosts cost one RPC
            # timeout in total, not one each.
            results = await asyncio.gather(*(
                self.service.seed_clients.trigger_download_task(h, spec)
                for h in targets))
            triggered = sum(1 for r in results if r)
            done = await self._wait_task(task_id, timeout) if triggered else False
            out = {"url": url, "task_id": task_id, "triggered": triggered,
                   "targets": len(targets), "succeeded": done}
            if rng:
                out["range"] = rng
            return out

        per_url = list(await asyncio.gather(*(
            one_url(u, r) for u in urls for r in ranges)))
        ok_all = all(r["triggered"] > 0 and r["succeeded"] for r in per_url)
        return (SUCCESS if ok_all else FAILURE), {"preheat": per_url, "scope": scope}

    async def _wait_task(self, task_id: str, timeout: float) -> bool:
        """Wait for the resource model to see the task succeed (the
        triggered daemons report on their own AnnouncePeer streams). A
        FAILED state left from an earlier attempt counts only once the
        task has been seen to leave it: the trigger restarts the task."""
        deadline = time.monotonic() + timeout
        seen_fresh = False
        while time.monotonic() < deadline:
            task = self.service.tasks.load(task_id)
            if task is not None:
                state = task.state
                if state == TaskState.SUCCEEDED:
                    return True
                if state == TaskState.FAILED:
                    if seen_fresh:
                        return False
                else:
                    seen_fresh = True
            await asyncio.sleep(0.2)
        return False

    # -- sync peers ---------------------------------------------------------

    async def _sync_peers(self, args: dict[str, Any]) -> tuple[str, dict]:
        """Push the live host inventory up to the manager's peers table."""
        count = 0
        for host in self.service.hosts.all():
            try:
                await self.manager.upsert_peer(
                    host_id=host.id, hostname=host.hostname, ip=host.ip,
                    port=host.port, type=int(host.type),
                    idc=host.idc, location=host.location,
                    scheduler_cluster_id=self.cluster_id,
                    state="active")
                count += 1
            except Exception as e:
                log.warning("peer sync failed", host=host.id, error=str(e))
        return SUCCESS, {"synced": count}

    # -- get / delete task --------------------------------------------------

    def _holders(self, task_id: str) -> list:
        task = self.service.tasks.load(task_id)
        if task is None:
            return []
        hosts = {}
        for p in task.peers():
            if p.is_done() or p.finished_pieces:
                hosts[p.host.id] = p.host
        return list(hosts.values())

    async def _get_task(self, args: dict[str, Any]) -> tuple[str, dict]:
        task_id = args.get("task_id", "")
        holders = self._holders(task_id)
        return SUCCESS, {
            "task_id": task_id,
            "peers": [{"host_id": h.id, "ip": h.ip, "hostname": h.hostname}
                      for h in holders],
        }

    async def _delete_task(self, args: dict[str, Any]) -> tuple[str, dict]:
        """Fan Peer.DeleteTask out to every host holding the task."""
        task_id = args.get("task_id", "")
        holders = self._holders(task_id)
        deleted, failed = [], []
        for host in holders:
            ok = await self.service.seed_clients.delete_task(host, task_id)
            (deleted if ok else failed).append(host.id)
        task = self.service.tasks.load(task_id)
        if task is not None and not failed:
            self.service.tasks.delete(task_id)
        return (SUCCESS if not failed else FAILURE), {
            "task_id": task_id, "deleted": deleted, "failed": failed}
