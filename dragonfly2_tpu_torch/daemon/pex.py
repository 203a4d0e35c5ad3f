"""PEX, gossip peer exchange among daemons (peers find each other without
a scheduler): the port's copy of ``dragonfly2_tpu/daemon/pex.py``.

A SWIM-lite UDP gossip: pings to random members every
``gossip_interval`` piggyback the full membership view and each node's
task-possession list (versioned, so stale gossip never regresses fresher
state). Liveness flows through heartbeats (a member not heard of for
``DEAD_AFTER`` is dropped with its possession), and with a shared
``secret`` every datagram is sealed with a 16-byte HMAC-SHA256 tag over a
wall-clock stamp and the payload, and a forged, unsealed or stale one (60 s
either way) is dropped. Task payloads ride the normal upload path; PEX
only answers "who has task X" (``find_holders``).

Wire (MessagePack over UDP, through the port's own codec ``rpc/codec.py``,
whose bytes are ``msgpack``'s, so port and JAX nodes gossip in one group)::

  {"t": "ping"|"ack"|"join"|"join_ack",
   "from": {node_id, ip, pex_port, peer_port, upload_port, incarnation,
            heartbeat},
   "members": [member...],
   "tasks": {node_id: {"v": version, "ids": [task_id...]}}}
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac as hmac_mod
import random
import time
import uuid
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.rpc import codec

log = dflog.get("daemon.pex")

GOSSIP_INTERVAL = 1.0
SUSPECT_AFTER = 5.0     # no direct/indirect news → suspect
DEAD_AFTER = 15.0       # suspect this long → removed
MAX_DATAGRAM = 60_000


@dataclass
class Member:
    node_id: str
    ip: str
    pex_port: int
    peer_port: int = 0
    upload_port: int = 0
    incarnation: int = 0
    # Monotone per-node counter bumped every gossip round; liveness flows
    # transitively: ANY message carrying a higher heartbeat proves the node
    # was alive recently, so big clusters don't need direct contact pairs
    # (the role memberlist's suspicion protocol plays in the reference).
    heartbeat: int = 0
    last_seen: float = field(default_factory=time.monotonic)

    def to_wire(self) -> dict:
        return {"node_id": self.node_id, "ip": self.ip,
                "pex_port": self.pex_port, "peer_port": self.peer_port,
                "upload_port": self.upload_port,
                "incarnation": self.incarnation,
                "heartbeat": self.heartbeat}

    @classmethod
    def from_wire(cls, d: dict) -> "Member":
        return cls(node_id=d["node_id"], ip=d["ip"], pex_port=d["pex_port"],
                   peer_port=d.get("peer_port", 0),
                   upload_port=d.get("upload_port", 0),
                   incarnation=d.get("incarnation", 0),
                   heartbeat=d.get("heartbeat", 0))


class _Proto(asyncio.DatagramProtocol):
    def __init__(self, pex: "PeerExchange"):
        self.pex = pex

    def datagram_received(self, data: bytes, addr) -> None:
        data = self.pex._authenticate(data)
        if data is None:
            return
        try:
            msg = codec.unpackb(data)
        except Exception:
            return
        self.pex._on_message(msg, addr)


class PeerExchange:
    """One gossip endpoint per daemon."""

    def __init__(self, *, ip: str, peer_port: int = 0, upload_port: int = 0,
                 node_id: str = "", gossip_interval: float = GOSSIP_INTERVAL,
                 secret: str | bytes = ""):
        self.node_id = node_id or uuid.uuid4().hex[:16]
        self.ip = ip
        self.peer_port = peer_port
        self.upload_port = upload_port
        self.gossip_interval = gossip_interval
        self.secret = (secret.encode() if isinstance(secret, str) else
                       bytes(secret))
        self.incarnation = int(time.time())
        self.heartbeat = 0
        self._seeds: list[tuple[str, int]] = []
        self.members: dict[str, Member] = {}
        # node_id → (version, set(task_ids)); own entry lives here too.
        self._possession: dict[str, tuple[int, set[str]]] = {
            self.node_id: (0, set())}
        self._transport: asyncio.DatagramTransport | None = None
        self._loop_task: asyncio.Task | None = None
        self._port = 0

    # -- lifecycle ---------------------------------------------------------

    async def start(self, port: int = 0, seeds: list[str] | None = None) -> int:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Proto(self), local_addr=(self.ip, port))
        self._port = self._transport.get_extra_info("sockname")[1]
        self._seeds = []
        for seed in seeds or []:
            host, sep, p = seed.rpartition(":")
            if not sep or not host or not p.isdigit():
                log.warning("ignoring malformed pex seed (want host:port)",
                            seed=seed)
                continue
            self._seeds.append((host, int(p)))
        for addr in self._seeds:
            self._send({"t": "join", **self._envelope()}, addr)
        self._loop_task = asyncio.create_task(self._gossip_loop())
        log.info("pex up", node=self.node_id, port=self._port,
                 seeds=len(seeds or []))
        return self._port

    async def stop(self) -> None:
        if self._loop_task is not None:
            self._loop_task.cancel()
            self._loop_task = None
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    @property
    def port(self) -> int:
        return self._port

    # -- possession API (reference peer_pool.go) ---------------------------

    def add_task(self, task_id: str) -> None:
        version, ids = self._possession[self.node_id]
        if task_id not in ids:
            ids.add(task_id)
            self._possession[self.node_id] = (version + 1, ids)

    def remove_task(self, task_id: str) -> None:
        version, ids = self._possession[self.node_id]
        if task_id in ids:
            ids.discard(task_id)
            self._possession[self.node_id] = (version + 1, ids)

    def find_holders(self, task_id: str) -> list[Member]:
        """Live members that gossiped possession of ``task_id``."""
        out = []
        for node_id, (_, ids) in self._possession.items():
            if node_id == self.node_id or task_id not in ids:
                continue
            m = self.members.get(node_id)
            if m is not None:
                out.append(m)
        return out

    def alive_members(self) -> list[Member]:
        return list(self.members.values())

    # -- gossip ------------------------------------------------------------

    # Possession payload budget per datagram: a ~70 B/task-id estimate
    # under the 60 KB datagram cap, leaving room for membership.
    _TASK_BUDGET = 40_000
    _TASK_ID_COST = 70

    def _envelope(self) -> dict:
        me = Member(self.node_id, self.ip, self._port, self.peer_port,
                    self.upload_port, self.incarnation, self.heartbeat)
        # Possession rides in randomized, budget-bounded subsets: every
        # round carries different nodes' entries, so large clusters converge
        # over a few rounds instead of silently dropping the payload.
        tasks: dict[str, dict] = {}
        budget = self._TASK_BUDGET
        entries = list(self._possession.items())
        random.shuffle(entries)
        # Own entry first — it is the one only we can originate.
        entries.sort(key=lambda kv: kv[0] != self.node_id)
        for nid, (v, ids) in entries:
            cost = self._TASK_ID_COST * max(1, len(ids))
            if cost > budget:
                continue
            budget -= cost
            tasks[nid] = {"v": v, "ids": list(ids)}
        return {"from": me.to_wire(),
                "members": [m.to_wire() for m in self.members.values()]
                + [me.to_wire()],
                "tasks": tasks}

    # Gossip authentication: with a shared secret configured, every
    # datagram is MAC'd (sha256 HMAC, 16-byte tag) over a wall-clock
    # timestamp plus the payload, and unauthenticated, forged, or stale
    # packets are dropped on receipt — membership and possession state can
    # then only be injected by secret holders, and a captured datagram
    # cannot be replayed outside the freshness window to resurrect departed
    # peers or deleted task announcements.
    _MAC_LEN = 16
    _TS_LEN = 8
    _FRESHNESS_S = 60.0

    def _seal(self, data: bytes) -> bytes:
        if not self.secret:
            return data
        ts = int(time.time() * 1000).to_bytes(self._TS_LEN, "big")
        mac = hmac_mod.new(self.secret, ts + data, hashlib.sha256).digest()
        return mac[: self._MAC_LEN] + ts + data

    def _authenticate(self, data: bytes) -> bytes | None:
        if not self.secret:
            return data
        if len(data) <= self._MAC_LEN + self._TS_LEN:
            return None
        mac = data[: self._MAC_LEN]
        ts_bytes = data[self._MAC_LEN: self._MAC_LEN + self._TS_LEN]
        payload = data[self._MAC_LEN + self._TS_LEN:]
        want = hmac_mod.new(self.secret, ts_bytes + payload,
                            hashlib.sha256).digest()[: self._MAC_LEN]
        if not hmac_mod.compare_digest(mac, want):
            return None
        ts = int.from_bytes(ts_bytes, "big") / 1000.0
        if abs(time.time() - ts) > self._FRESHNESS_S:
            return None
        return payload

    def _send(self, msg: dict, addr: tuple[str, int]) -> None:
        if self._transport is None:
            return
        data = codec.packb(msg)
        if len(data) > MAX_DATAGRAM:
            # Membership alone overflowed (very large cluster): ship a
            # random member subset; convergence is probabilistic per round.
            slim = dict(msg)
            slim["tasks"] = {}
            members = msg.get("members") or []
            random.shuffle(members)
            slim["members"] = members[:200]
            data = codec.packb(slim)
        try:
            self._transport.sendto(self._seal(data), addr)
        except OSError:
            pass

    async def _gossip_loop(self) -> None:
        while True:
            await asyncio.sleep(self.gossip_interval)
            self.heartbeat += 1
            self._expire()
            targets = list(self.members.values())
            if not targets:
                # Isolated (lost join datagram, seeds down): keep knocking
                # on the seed doors — memberlist retries joins too.
                for addr in self._seeds:
                    self._send({"t": "join", **self._envelope()}, addr)
                continue
            for m in random.sample(targets, min(3, len(targets))):
                self._send({"t": "ping", **self._envelope()}, (m.ip, m.pex_port))

    def _expire(self) -> None:
        now = time.monotonic()
        dead = [nid for nid, m in self.members.items()
                if now - m.last_seen > DEAD_AFTER]
        for nid in dead:
            self.members.pop(nid, None)
            self._possession.pop(nid, None)
            log.info("pex member dead", node=nid)

    def _merge(self, msg: dict, sender_addr) -> None:
        sender = Member.from_wire(msg["from"])
        if sender.node_id != self.node_id:
            existing = self.members.get(sender.node_id)
            if existing is None or sender.incarnation >= existing.incarnation:
                sender.last_seen = time.monotonic()
                sender.heartbeat = max(sender.heartbeat,
                                       existing.heartbeat if existing else 0)
                self.members[sender.node_id] = sender
        for w in msg.get("members") or []:
            m = Member.from_wire(w)
            if m.node_id == self.node_id:
                continue
            existing = self.members.get(m.node_id)
            if existing is None:
                # Learned indirectly: not yet "seen"; give it a grace window.
                m.last_seen = time.monotonic() - SUSPECT_AFTER
                self.members[m.node_id] = m
            elif (m.incarnation > existing.incarnation
                  or m.heartbeat > existing.heartbeat):
                # Fresher news (restart or newer heartbeat) proves recent
                # life even without direct contact — transitive liveness.
                m.last_seen = time.monotonic()
                self.members[m.node_id] = m
        for nid, entry in (msg.get("tasks") or {}).items():
            if nid == self.node_id:
                continue  # nobody else is authoritative for our tasks
            version = entry.get("v", 0)
            current = self._possession.get(nid)
            if current is None or version > current[0]:
                self._possession[nid] = (version, set(entry.get("ids") or []))

    def _on_message(self, msg: dict, addr) -> None:
        t = msg.get("t")
        if t not in ("ping", "ack", "join", "join_ack") or "from" not in msg:
            return
        self._merge(msg, addr)
        if t == "ping":
            sender = msg["from"]
            self._send({"t": "ack", **self._envelope()},
                       (sender["ip"], sender["pex_port"]))
        elif t == "join":
            sender = msg["from"]
            self._send({"t": "join_ack", **self._envelope()},
                       (sender["ip"], sender["pex_port"]))
