"""The manager's business logic: the port's copy of
``dragonfly2_tpu/manager/service.py``, which the REST handlers and the
drpc server both call.

Users and tokens, the scheduler and seed-peer registry with keepalive
generations, the job queue with per-cluster job token buckets, tenant
admission from the schedulers' burn snapshots, and the dynconfig read
paths behind a 10 s ``TTLCache``. Divergences, each intended: no cluster
control tower is built (``pkg/cluster.py`` is ROADMAP A7.4 item 6), so a
keepalive's fleet frame is dropped and ``note_admission_429`` records
nothing. A ``searcher_plugin`` names a searcher of the plugin registry
(``pkg/dfplugin.py``).
"""

from __future__ import annotations

import time
from typing import Any

from dragonfly2_tpu_torch.manager import auth, jobqueue
from dragonfly2_tpu_torch.manager.database import Database
from dragonfly2_tpu_torch.manager.rbac import Enforcer
from dragonfly2_tpu_torch.manager.searcher import Searcher, SearchRequest
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.cache import TTLCache
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.ratelimit import Limiter
from dragonfly2_tpu_torch.qos.admission import AdmissionController

log = dflog.get("manager.service")

ACTIVE = "active"
INACTIVE = "inactive"

# The keepalive liveness window.
KEEPALIVE_TIMEOUT = 60.0
_CACHE_TTL = 10.0


class ManagerService:
    def __init__(self, db: Database | None = None, *,
                 searcher_plugin: str = "",
                 keepalive_timeout: float = KEEPALIVE_TIMEOUT):
        self.db = db or Database()
        self.keepalive_timeout = keepalive_timeout
        if searcher_plugin:
            # A plugin-replaceable scheduler-cluster searcher.
            from dragonfly2_tpu_torch.pkg import dfplugin

            self.searcher = dfplugin.registry().create(
                dfplugin.TYPE_SEARCHER, searcher_plugin)
        else:
            self.searcher = Searcher()
        self.jobs = jobqueue.JobQueue(self.db)
        self.signer = auth.TokenSigner()
        self.rbac = Enforcer(self.db)
        self._cache = TTLCache(default_ttl=_CACHE_TTL)
        # Keepalive stream generations: the newest stream per instance owns
        # liveness; stale stream teardowns must not flip an instance inactive.
        self._ka_gen: dict[tuple, int] = {}
        # Per-scheduler-cluster job token buckets: every job enters
        # through this manager's REST API or drpc queue, so a bucket here
        # bounds the whole fleet's job rate. Keyed (rate, Limiter) so a
        # config change retunes it.
        self._job_limiters: dict[int, tuple[float, Limiter]] = {}
        # Tenant burn-rate admission: schedulers piggyback their burn
        # snapshots on keepalives, and a job of a breaching tenant gets a
        # 429 with Retry-After. A stale view admits.
        self.admission = AdmissionController()
        self._ensure_defaults()

    def _ensure_defaults(self) -> None:
        """Seed a root user and default clusters, so a fresh deployment
        works as it is."""
        if not self.db.find("users", name="root"):
            root = self.db.insert("users", {
                "name": "root",
                "encrypted_password": auth.hash_password("dragonfly"),
            })
            self.db.insert("user_roles", {"user_id": root["id"], "role": auth.ROLE_ROOT})
        if not self.db.find("scheduler_clusters", name="default"):
            sc = self.db.insert("scheduler_clusters", {
                "name": "default", "is_default": 1,
                "config": {"candidate_parent_limit": 4, "filter_parent_limit": 15},
                "client_config": {"load_limit": 200},
            })
            spc = self.db.insert("seed_peer_clusters", {
                "name": "default",
                "config": {"load_limit": 2000},
            })
            self.db.link_seed_peer_cluster(sc["id"], spc["id"])

    # -- distributed job rate limiting -------------------------------------

    # 10 job requests a second a scheduler cluster by default.
    DEFAULT_JOB_RATE_LIMIT = 10.0

    def take_job_tokens(self, cluster_ids, tokens: int = 1) -> tuple[bool, float]:
        """Draw ``tokens`` from every listed cluster's job bucket, all or
        nothing: a denial debits no bucket. Returns (granted,
        retry_after_s). Each cluster's rate is its config's
        ``job_rate_limit``, read at every take (a change retunes the
        bucket in place). The REST face maps a denial to 429; drpc
        callers share the same buckets. Synchronous on the event loop,
        so check-all then debit-all is atomic.

        Raises DfError(NotFound) when none of the ids names a cluster
        (an empty list of buckets would grant with no debit); unknown
        ids beside known ones are skipped."""
        tokens = max(1, int(tokens))  # negative/zero must never credit
        # Dedupe before the check/debit loop: cluster_ids=[1,1] must not
        # double-debit one job, nor slip past can_allow when only one
        # token remains (each occurrence checked independently would).
        try:
            cluster_ids = list(dict.fromkeys(int(cid) for cid in cluster_ids))
        except (TypeError, ValueError):
            raise DfError(Code.InvalidArgument,
                          f"malformed scheduler cluster ids {cluster_ids!r}")
        limiters: list[Limiter] = []
        retry_after = 0.0
        for cid in cluster_ids:
            cluster = self.db.get("scheduler_clusters", int(cid))
            if cluster is None:
                continue
            rate = float((cluster.get("config") or {}).get(
                "job_rate_limit", self.DEFAULT_JOB_RATE_LIMIT))
            cached = self._job_limiters.get(int(cid))
            if cached is None:
                cached = (rate, Limiter(rate, burst=max(1, int(rate))))
                self._job_limiters[int(cid)] = cached
            elif cached[0] != rate:
                cached[1].set_limit(rate, burst=max(1, int(rate)))
                cached = (rate, cached[1])
                self._job_limiters[int(cid)] = cached
            if not cached[1].can_allow(tokens):
                retry_after = max(retry_after,
                                  tokens / max(rate, 1e-9), 0.05)
            limiters.append(cached[1])
        if cluster_ids and not limiters:
            raise DfError(Code.NotFound,
                          "no listed scheduler cluster exists")
        if retry_after > 0:
            return False, retry_after
        for lim in limiters:
            # can_allow passed for every bucket and nothing ran between
            # check and debit (one event loop).
            assert lim.allow(tokens), "job bucket drained between check and debit"
        return True, 0.0

    # -- users / auth ------------------------------------------------------

    def signup(self, name: str, password: str, email: str = "") -> dict:
        if self.db.find("users", name=name):
            raise DfError(Code.InvalidArgument, f"user {name} exists")
        user = self.db.insert("users", {
            "name": name, "encrypted_password": auth.hash_password(password),
            "email": email,
        })
        self.db.insert("user_roles", {"user_id": user["id"], "role": auth.ROLE_GUEST})
        return self._public_user(user)

    def signin(self, name: str, password: str) -> str:
        user = self.db.find("users", name=name)
        if not user or not auth.verify_password(password, user["encrypted_password"]):
            raise DfError(Code.Unauthorized, "bad credentials")
        return self.signer.sign(user["id"], name, self.roles_of(user["id"]))

    def roles_of(self, user_id: int) -> list[str]:
        return [r["role"] for r in self.db.list("user_roles", user_id=user_id)]

    def grant_role(self, user_id: int, role: str) -> None:
        if not self.db.find("user_roles", user_id=user_id, role=role):
            self.db.insert("user_roles", {"user_id": user_id, "role": role})

    def revoke_role(self, user_id: int, role: str) -> None:
        # user_roles has no surrogate id (pure join table) — delete by key.
        self.db.execute("DELETE FROM user_roles WHERE user_id=? AND role=?",
                        (user_id, role))

    def reset_password(self, user_id: int, new_password: str) -> None:
        self.db.update("users", user_id,
                       {"encrypted_password": auth.hash_password(new_password)})

    def _public_user(self, user: dict) -> dict:
        out = dict(user)
        out.pop("encrypted_password", None)
        return out

    def verify_token(self, token: str) -> dict | None:
        """Session token or personal access token -> identity payload."""
        payload = self.signer.verify(token)
        if payload:
            return payload
        pat = self.db.find("personal_access_tokens", token=token)
        if pat and pat["state"] == "active" and (
                pat["expired_at"] == 0 or pat["expired_at"] > time.time()):
            # Fail closed: a PAT grants exactly its owner's roles; an owner
            # with no roles (disabled account) authenticates to nothing.
            return {"uid": pat["user_id"], "name": pat["name"],
                    "roles": self.roles_of(pat["user_id"]), "pat": True}
        return None

    # -- registry (self-registration + keepalive) --------------------------

    def update_scheduler(self, req: dict[str, Any]) -> dict:
        """Upsert by (hostname, ip, cluster)."""
        cluster_id = int(req.get("scheduler_cluster_id") or
                         self._default_cluster_id("scheduler_clusters"))
        row = self.db.find("schedulers", hostname=req["hostname"], ip=req["ip"],
                           scheduler_cluster_id=cluster_id)
        values = {
            "hostname": req["hostname"], "ip": req["ip"],
            "port": int(req.get("port", 8002)),
            "idc": req.get("idc", ""), "location": req.get("location", ""),
            "features": req.get("features", []),
            "scheduler_cluster_id": cluster_id,
            "state": ACTIVE, "last_keepalive_at": time.time(),
        }
        self._cache = TTLCache(default_ttl=_CACHE_TTL)  # invalidate
        ka_key = ("scheduler", req["hostname"], req["ip"], cluster_id)
        self._ka_gen[ka_key] = self._ka_gen.get(ka_key, 0) + 1
        if row:
            return self.db.update("schedulers", row["id"], values)
        return self.db.insert("schedulers", values)

    def update_seed_peer(self, req: dict[str, Any]) -> dict:
        cluster_id = int(req.get("seed_peer_cluster_id") or
                         self._default_cluster_id("seed_peer_clusters"))
        row = self.db.find("seed_peers", hostname=req["hostname"], ip=req["ip"],
                           seed_peer_cluster_id=cluster_id)
        values = {
            "hostname": req["hostname"], "ip": req["ip"],
            "port": int(req.get("port", 65000)),
            "download_port": int(req.get("download_port", 0)),
            "object_storage_port": int(req.get("object_storage_port", 0)),
            "type": req.get("type", "super"),
            "idc": req.get("idc", ""), "location": req.get("location", ""),
            "seed_peer_cluster_id": cluster_id,
            "state": ACTIVE, "last_keepalive_at": time.time(),
        }
        self._cache = TTLCache(default_ttl=_CACHE_TTL)
        ka_key = ("seed_peer", req["hostname"], req["ip"], cluster_id)
        self._ka_gen[ka_key] = self._ka_gen.get(ka_key, 0) + 1
        if row:
            return self.db.update("seed_peers", row["id"], values)
        return self.db.insert("seed_peers", values)

    def _default_cluster_id(self, table: str) -> int:
        row = self.db.find(table, name="default")
        if not row:
            raise DfError(Code.NotFound, f"no default {table}")
        return row["id"]

    def keepalive_open(self, source_type: str, hostname: str, ip: str,
                       cluster_id: int) -> int:
        """New keepalive stream: bump the generation and mark active. The
        returned token must be passed back to mark_inactive."""
        key = (source_type, hostname, ip, cluster_id)
        gen = self._ka_gen.get(key, 0) + 1
        self._ka_gen[key] = gen
        self.keepalive(source_type, hostname, ip, cluster_id)
        return gen

    def keepalive(self, source_type: str, hostname: str, ip: str, cluster_id: int) -> None:
        table = "schedulers" if source_type == "scheduler" else "seed_peers"
        key = ("scheduler_cluster_id" if table == "schedulers"
               else "seed_peer_cluster_id")
        row = self.db.find(table, hostname=hostname, ip=ip, **{key: cluster_id})
        if row:
            self.db.update(table, row["id"],
                           {"state": ACTIVE, "last_keepalive_at": time.time()})

    def mark_inactive(self, source_type: str, hostname: str, ip: str,
                      cluster_id: int, gen: int | None = None) -> None:
        if gen is not None and self._ka_gen.get(
                (source_type, hostname, ip, cluster_id)) != gen:
            return  # a newer stream (or re-registration) owns liveness
        table = "schedulers" if source_type == "scheduler" else "seed_peers"
        key = ("scheduler_cluster_id" if table == "schedulers"
               else "seed_peer_cluster_id")
        row = self.db.find(table, hostname=hostname, ip=ip, **{key: cluster_id})
        if row:
            self.db.update(table, row["id"], {"state": INACTIVE})

    # -- tenant QoS admission (qos/admission.py) ---------------------------

    def ingest_tenant_burn(self, snapshot: Any) -> int:
        """Fold a scheduler's keepalive-piggybacked per-tenant burn
        snapshot into the admission controller's merged view. Returns the
        number of tenant entries applied (0 for malformed payloads —
        keepalives keep flowing regardless)."""
        if not isinstance(snapshot, dict):
            return 0
        try:
            return self.admission.ingest(snapshot)
        except Exception:
            return 0

    def check_admission(self, tenant: str) -> tuple[bool, float, dict]:
        """(admitted, retry_after_s, detail) for a job submission by
        ``tenant``. Fails open on no/stale data."""
        return self.admission.check(tenant)

    def note_admission_429(self, tenant: str) -> None:
        """A job refused with 429. The JAX manager journals it in its
        cluster tower; the port has no tower and records nothing."""

    def expire_stale(self) -> int:
        """Flip rows whose keepalive lapsed to inactive (a GC task)."""
        cutoff = time.time() - self.keepalive_timeout
        n = 0
        for table in ("schedulers", "seed_peers"):
            for row in self.db.list(table, state=ACTIVE):
                if row["last_keepalive_at"] < cutoff:
                    self.db.update(table, row["id"], {"state": INACTIVE})
                    n += 1
        return n

    # -- dynconfig read paths ---------------------------------------------

    def list_schedulers(self, req: dict[str, Any]) -> list[dict]:
        """Searcher-ranked active schedulers for a requesting daemon."""
        cache_key = "ls:" + repr(sorted(req.items()))
        hit, ok = self._cache.get(cache_key)
        if ok:
            return hit
        sreq = SearchRequest(hostname=req.get("hostname", ""), ip=req.get("ip", ""),
                             idc=req.get("idc", ""), location=req.get("location", ""),
                             pod=req.get("pod", ""))
        clusters = self.searcher.find_scheduler_clusters(
            self.db.list("scheduler_clusters"), sreq)
        out: list[dict] = []
        for cluster in clusters:
            out += self.db.list("schedulers", scheduler_cluster_id=cluster["id"],
                                state=ACTIVE)
        self._cache.set(cache_key, out)
        return out

    def get_scheduler_cluster_config(self, cluster_id: int) -> dict:
        cluster = self.db.get("scheduler_clusters", cluster_id)
        if not cluster:
            raise DfError(Code.NotFound, f"scheduler cluster {cluster_id}")
        return cluster

    def list_seed_peers_for_cluster(self, scheduler_cluster_id: int) -> list[dict]:
        """Active seed peers of every seed-peer cluster linked to this
        scheduler cluster (what scheduler dynconfig pulls)."""
        cache_key = f"sp:{scheduler_cluster_id}"
        hit, ok = self._cache.get(cache_key)
        if ok:
            return hit
        out: list[dict] = []
        for spc_id in self.db.seed_peer_clusters_of(scheduler_cluster_id):
            out += self.db.list("seed_peers", seed_peer_cluster_id=spc_id,
                                state=ACTIVE)
        self._cache.set(cache_key, out)
        return out

    def list_applications(self) -> list[dict]:
        return self.db.list("applications")

    # -- peers (sync-peers results) ---------------------------------------

    def upsert_peer(self, req: dict[str, Any]) -> dict:
        cluster_id = int(req.get("scheduler_cluster_id", 0))
        row = self.db.find("peers", hostname=req.get("hostname", ""),
                           ip=req.get("ip", ""), scheduler_cluster_id=cluster_id)
        values = {k: req[k] for k in (
            "hostname", "type", "idc", "location", "ip", "port", "download_port",
            "object_storage_port", "os", "platform", "platform_family",
            "platform_version", "kernel_version", "git_version", "git_commit",
            "build_platform") if k in req}
        values["scheduler_cluster_id"] = cluster_id
        values["state"] = ACTIVE
        if row:
            return self.db.update("peers", row["id"], values)
        return self.db.insert("peers", values)
