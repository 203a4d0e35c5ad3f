"""The daemon's scheduler client: the port's copy of
``dragonfly2_tpu/daemon/schedulerclient.py``, on the port's drpc.

A consistent-hash pick of a scheduler per task, the AnnouncePeer stream
the conductor drives (opened on the task's ring owner, failing over
clockwise), routed unary calls classified by ``RPC_TABLE``, and the
ring-rebuild observers that let a conductor re-home its stream, and the
host announcements the daemon's announcer sends to every ring member
(``announce_host``, ``leave_host``).
"""

from __future__ import annotations

import asyncio

from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Client, ClientStream
from dragonfly2_tpu_torch.rpc.balancer import HashRing

log = dflog.get("daemon.schedulerclient")

FAILOVER_COUNT = metrics.counter(
    "peer_scheduler_failover_total",
    "Announce-stream opens by ring outcome: owner (the consistent-hash "
    "owner answered), failover (a clockwise substitute answered while "
    "the owner was unreachable), exhausted (no ring member reachable)",
    ("result",))

# --------------------------------------------------------------------- #
# RPC classification: every scheduler RPC the daemon speaks has a row.
# A misclassified RPC is a failover bug: ring failover of a state-bearing
# call turns a retryable connection error into an authoritative-looking
# "not found" from a member that never owned the task.
#
#   stream         AnnouncePeer: ring-ordered open with clockwise
#                  failover; recovery re-registers with resume state and
#                  re-reports idempotently, so ANY member can adopt it.
#   idempotent     safe to land on any ring member — registration-shaped
#                  or read-only; ``unary()`` fails over on connection
#                  errors.
#   state_bearing  must land on the member holding the task FSM; NO ring
#                  failover — the owning member's (retryable) connection
#                  error is the correct surface.
#   fanout         sent to every ring member (each keeps its own view).
# --------------------------------------------------------------------- #

STREAM = "stream"
IDEMPOTENT = "idempotent"
STATE_BEARING = "state_bearing"
FANOUT = "fanout"

RPC_TABLE: dict[str, str] = {
    "Scheduler.AnnouncePeer": STREAM,
    "Scheduler.AnnounceHost": FANOUT,
    "Scheduler.LeaveHost": FANOUT,
    "Scheduler.AnnounceTask": IDEMPOTENT,
    "Scheduler.LeavePeer": IDEMPOTENT,
    "Scheduler.StatTask": IDEMPOTENT,
    "Scheduler.StatPeer": IDEMPOTENT,
    "Scheduler.PodTimeline": IDEMPOTENT,
    "Scheduler.UploadPersistentCacheTaskStarted": STATE_BEARING,
    "Scheduler.UploadPersistentCacheTaskFinished": STATE_BEARING,
    "Scheduler.UploadPersistentCacheTaskFailed": STATE_BEARING,
    "Scheduler.StatPersistentCacheTask": STATE_BEARING,
    "Scheduler.ListPersistentCacheTasks": STATE_BEARING,
    "Scheduler.DeletePersistentCacheTask": STATE_BEARING,
}


class SchedulerClient:
    def __init__(self, addrs: list[str]):
        if not addrs:
            raise DfError(Code.BadRequest, "no scheduler addresses")
        self._ring = HashRing(addrs)
        self._clients: dict[str, Client] = {}
        # Ring-rebuild observers: task_id → callback(new_owner_addr),
        # fired when a scheduler-set change moves the task's ownership
        # away from the member its announce stream sits on (the conductor
        # re-homes).
        self._watchers: dict[str, object] = {}
        self._stream_addrs: dict[str, str] = {}

    async def _routed_call(self, task_id: str, method: str, body: dict,
                           timeout: float, idempotent: bool = False):
        """Unary call with the same clockwise ring failover as the
        announce stream: connection-level failures try the next member;
        the OWNING member's error is what surfaces if all fail (it is the
        one operators need to diagnose).

        Failover is OPT-IN per method (``idempotent=True``, resolved from
        RPC_TABLE by ``unary``): a state-bearing call (e.g. the
        persistent-cache family, whose Started/Finished pair must land on
        the member holding the task FSM) must NOT fail over — the
        substitute member would give an authoritative-looking "not found"
        where the caller needs a retryable connection error."""
        members = (self._ring.pick_n(task_id, len(self._ring.members()))
                   if idempotent else self._ring.pick_n(task_id, 1))
        first: DfError | None = None
        for i, addr in enumerate(members):
            try:
                return await self._client_for_addr(addr).call(
                    method, body, timeout=timeout)
            except DfError as e:
                if first is None:
                    first = e
                if e.code != Code.ClientConnectionError:
                    raise  # a scheduler ANSWERED: its verdict stands
                if i + 1 < len(members):
                    log.warning("scheduler unreachable, trying next ring "
                                "member", addr=addr, method=method,
                                error=e.message)
        raise first if first is not None else DfError(
            Code.SchedError, "no scheduler addresses")

    def update_addrs(self, addrs: list[str]) -> None:
        """Rebuild the hash ring when the scheduler set changes.
        Clients for removed schedulers are closed, not leaked; announce
        streams sitting on a still-alive but NO-LONGER-OWNING member get
        their conductor's ring-change callback so they can drain and
        re-home instead of riding a stale shard."""
        if not addrs or set(addrs) == set(self._ring.members()):
            return
        log.info("scheduler set changed", addrs=addrs)
        self._ring = HashRing(addrs)
        stale = [a for a in self._clients if a not in set(addrs)]
        for addr in stale:
            cli = self._clients.pop(addr)
            try:
                asyncio.get_running_loop().create_task(cli.close())
            except RuntimeError:  # no loop: close() at daemon stop handled it
                pass
        for task_id, cb in list(self._watchers.items()):
            owner = self._ring.pick(task_id)
            current = self._stream_addrs.get(task_id)
            if owner and current and owner != current:
                try:
                    cb(owner)
                except Exception:
                    log.warning("ring-change callback failed",
                                task=task_id[:16], exc_info=True)

    # -- ring-rebuild observation (conductor re-homing) --------------------

    def watch_ring(self, task_id: str, cb) -> None:
        """Register ``cb(new_owner_addr)`` to fire when a ring rebuild
        moves ``task_id``'s ownership off the member its announce stream
        was opened on."""
        self._watchers[task_id] = cb

    def unwatch_ring(self, task_id: str) -> None:
        self._watchers.pop(task_id, None)
        self._stream_addrs.pop(task_id, None)

    def stream_addr(self, task_id: str) -> str:
        """The ring member the task's announce stream last opened on."""
        return self._stream_addrs.get(task_id, "")

    async def open_announce_stream(self, open_body: dict) -> ClientStream:
        """Open the AnnouncePeer stream on the ring member owning this
        task, failing over clockwise to the other members when one is
        unreachable (a dead scheduler must not push its ~1/N of tasks to
        origin while healthy schedulers sit idle; dynconfig eventually
        drops the dead member from the ring)."""
        task_id = open_body["task_id"]
        members = self._ring.pick_n(task_id, len(self._ring.members()))
        first: DfError | None = None
        for i, addr in enumerate(members):
            try:
                cli = self._client_for_addr(addr)
                stream = await cli.open_stream("Scheduler.AnnouncePeer",
                                               open_body)
            except DfError as e:
                if first is None:
                    first = e
                if i + 1 < len(members):
                    log.warning("scheduler unreachable, trying next ring "
                                "member", addr=addr, error=e.message)
                continue
            self._stream_addrs[task_id] = addr
            FAILOVER_COUNT.labels("owner" if i == 0 else "failover").inc()
            return stream
        FAILOVER_COUNT.labels("exhausted").inc()
        if first is not None:
            raise first
        raise DfError(Code.SchedError, "no scheduler addresses")

    async def unary(self, task_id: str, method: str, body: dict,
                    timeout: float = 10.0,
                    idempotent: "bool | None" = None):
        """Unary call routed by task id through the consistent-hash ring
        (public surface for call families without a dedicated wrapper,
        e.g. the persistent cache RPCs). Ring failover is resolved from
        RPC_TABLE — only ``idempotent``-classified methods fail over; the
        safe posture for state-bearing methods is the owning member's
        error, retryable. An explicit ``idempotent=`` overrides (plugin
        methods the table cannot know)."""
        if idempotent is None:
            idempotent = RPC_TABLE.get(method) == IDEMPOTENT
        return await self._routed_call(task_id, method, body, timeout,
                                       idempotent=idempotent)

    async def announce_host(self, host_wire: dict) -> "dict | None":
        """``Scheduler.AnnounceHost`` to every scheduler (each keeps its own
        view of the hosts). Returns the first answer: it carries the
        scheduler's ``sched_wall`` clock echo and this host's scorecard."""
        first: "dict | None" = None
        for addr in self._ring.members():
            try:
                resp = await self._client_for_addr(addr).call(
                    "Scheduler.AnnounceHost", host_wire, timeout=10.0)
                if first is None and isinstance(resp, dict):
                    first = resp
            except DfError as e:
                log.warning("announce host failed", addr=addr,
                            error=e.message)
        return first

    async def leave_host(self, host_id: str) -> None:
        """``Scheduler.LeaveHost`` to every scheduler; a failure is
        dropped (the scheduler's host GC ends the host anyway)."""
        for addr in self._ring.members():
            try:
                await self._client_for_addr(addr).call(
                    "Scheduler.LeaveHost", {"id": host_id}, timeout=5.0)
            except DfError:
                pass

    async def announce_task(self, body: dict) -> None:
        """Advertise a locally complete task (an import). Idempotent
        registration: safe to land on a failover member."""
        await self._routed_call(body.get("task_id", ""),
                                "Scheduler.AnnounceTask", body, 10.0,
                                idempotent=True)

    def _client_for_addr(self, addr: str) -> Client:
        cli = self._clients.get(addr)
        if cli is None:
            host, _, port = addr.rpartition(":")
            cli = Client(NetAddr.tcp(host, int(port)))
            self._clients[addr] = cli
        return cli

    async def close(self) -> None:
        for cli in self._clients.values():
            await cli.close()
        self._clients.clear()
