"""The port's QoS plane (``qos/``) against the JAX package's.

- ``normalize_tenant``, ``class_of`` and ``weight_of`` equal to JAX's
  over a hypothesis corpus (the exception too, where both raise);
  ``CLASSES``, ``WEIGHTS`` and ``DEFAULT_TENANT`` equal.
- ``WFQGate``: the same grant order as JAX's under scripted arrival
  sequences, cancellation included; the same grants and queue depths by
  class; capacity never exceeded under random churn.
- ``TenantBuckets``: the same shares after the same tenant sequences
  (unlimited and finite caps, the overflow backstop), the same byte
  accounting (``peer_upload_bytes_total{tenant}``); eight threads waiting
  at once lose no byte; the upload server with buckets attributes each
  tenant's bytes as the JAX upload server does.
- Two tasks contending through two port conductors and one gate issue
  their piece requests in the JAX conductors' order, with the same grant
  counts by class.

Tolerance 0, but for one wait time (stated where it is checked).
"""

from __future__ import annotations

import asyncio
import http.client
import random
import threading
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dragonfly2_tpu import qos as jqos
from dragonfly2_tpu.daemon.peer import conductor as jcond
from dragonfly2_tpu.daemon.upload import UploadManager as JUpload
from dragonfly2_tpu.qos import wfq as jwfq
from dragonfly2_tpu.storage import StorageManager as JSM
from dragonfly2_tpu.storage import StorageOption as JSMOption
from dragonfly2_tpu.storage import TaskStoreMetadata as JMetadata
from dragonfly2_tpu_torch import qos as pqos
from dragonfly2_tpu_torch.daemon.peer import conductor as pcond
from dragonfly2_tpu_torch.daemon.upload import UploadManager
from dragonfly2_tpu_torch.qos import wfq as pwfq
from dragonfly2_tpu_torch.storage import StorageManager, StorageOption
from dragonfly2_tpu_torch.storage.local_store import TaskStoreMetadata
from tests.test_torch_p2p import _fill_stores


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:
        return ("raises", type(e).__name__)


def test_the_constants_are_jaxs():
    assert pqos.CLASSES == jqos.CLASSES
    assert pqos.WEIGHTS == jqos.WEIGHTS
    assert pqos.DEFAULT_TENANT == jqos.DEFAULT_TENANT
    assert pcond.normalize_tenant is pqos.normalize_tenant
    assert not hasattr(pqos, "AdmissionController")
    assert not hasattr(pqos, "TenantBurnBook")


@settings(max_examples=400, deadline=None)
@given(st.one_of(st.none(), st.text(max_size=90),
                 st.from_regex(r"[A-Za-z0-9._\- /\r\n:]{0,80}",
                               fullmatch=True)))
def test_normalize_tenant_matches_jax(tag):
    assert pqos.normalize_tenant(tag) == jqos.normalize_tenant(tag)


@settings(max_examples=400, deadline=None)
@given(st.one_of(st.none(), st.integers(-20, 20), st.booleans(),
                 st.floats(allow_nan=True, allow_infinity=True),
                 st.text(max_size=6), st.sampled_from(["5", " 6 ", "x"])))
def test_class_of_and_weight_of_match_jax(priority):
    assert _outcome(pqos.class_of, priority) == _outcome(jqos.class_of,
                                                         priority)
    assert _outcome(pqos.weight_of, priority) == _outcome(jqos.weight_of,
                                                          priority)


def _grants(module) -> dict:
    return {c: module.GRANTS.labels(c)._value.get()
            if hasattr(module.GRANTS.labels(c), "_value")
            else module.GRANTS.value(c) for c in pqos.CLASSES}


def _depths(module) -> dict:
    return {c: module.QUEUE_DEPTH.labels(c)._value.get()
            if hasattr(module.QUEUE_DEPTH.labels(c), "_value")
            else module.QUEUE_DEPTH.value(c) for c in pqos.CLASSES}


async def _scripted(module, capacity: int, script: list) -> dict:
    """Run ``script`` against a fresh gate: ("acq", name, priority) starts
    a waiter, ("rel",) releases one slot, ("cancel", name) cancels a
    waiter; every step then lets the loop run. Returns the grant order,
    the gate's state after each step and the metric deltas."""
    gate = module.WFQGate(capacity)
    g0, order, states, tasks = _grants(module), [], [], {}

    async def waiter(name, prio):
        await gate.acquire(prio)
        order.append(name)

    for step in script:
        if step[0] == "acq":
            tasks[step[1]] = asyncio.ensure_future(waiter(step[1], step[2]))
        elif step[0] == "rel":
            gate.release()
        else:
            tasks[step[1]].cancel()
        for _ in range(3):
            await asyncio.sleep(0)
        states.append((gate.active, gate.queued()))
    for t in tasks.values():
        t.cancel()
    await asyncio.gather(*tasks.values(), return_exceptions=True)
    g1 = _grants(module)
    return {"order": order, "states": states,
            "grants": {c: g1[c] - g0[c] for c in g1},
            "depths": _depths(module)}


def _script(seed: int) -> list:
    rng = random.Random(seed)
    script, names = [], []
    for i in range(60):
        r = rng.random()
        if r < 0.55:
            name = f"w{i}"
            names.append(name)
            script.append(("acq", name, rng.choice(
                [0, 1, 2, 3, 4, 5, 6, None, "7"])))
        elif r < 0.9:
            script.append(("rel",))
        elif names:
            script.append(("cancel", rng.choice(names)))
    return script + [("rel",)] * 40


@pytest.mark.parametrize("capacity", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", range(6))
def test_wfq_gate_grants_as_jax(run_async, capacity, seed):
    script = _script(seed)
    got = run_async(_scripted(pwfq, capacity, script))
    want = run_async(_scripted(jwfq, capacity, script))
    assert got == want


def test_a_full_gate_serves_interactive_first_without_starving(run_async):
    # Capacity 1: one holder, then 17 waiters of each class. The
    # interactive class's credit carries it through its queue first;
    # every waiter is granted in the end.
    script = [("acq", "h", 3)]
    for i in range(17):
        for prio, cls in ((6, "i"), (3, "n"), (1, "b")):
            script.append(("acq", f"{cls}{i}", prio))
    script += [("rel",)] * 52
    got = run_async(_scripted(pwfq, 1, script))
    assert got == run_async(_scripted(jwfq, 1, script))
    assert [n[0] for n in got["order"][1:18]] == ["i"] * 17
    assert len(got["order"]) == 52
    assert got["grants"] == {"interactive": 17, "normal": 18,
                             "background": 17}


def test_capacity_is_never_exceeded_under_churn(run_async):
    async def churn():
        gate = pwfq.WFQGate(3)
        peak, held = [0], [0]

        async def worker(rng):
            for _ in range(40):
                await gate.acquire(rng.randint(0, 6))
                held[0] += 1
                try:
                    peak[0] = max(peak[0], held[0])
                    assert gate.active <= gate.capacity
                    await asyncio.sleep(rng.random() / 1000)
                finally:
                    held[0] -= 1
                    gate.release()

        tasks = [asyncio.ensure_future(worker(random.Random(i)))
                 for i in range(12)]
        await asyncio.sleep(0.02)
        tasks[0].cancel()              # a cancel mid-churn
        await asyncio.gather(*tasks, return_exceptions=True)
        return peak[0], gate.active, gate.queued()

    peak, active, queued = run_async(churn())
    assert peak == 3
    assert active == 0
    assert sum(queued.values()) == 0


def _tenant_bytes(module, tenant: str) -> float:
    child = module.TENANT_UPLOAD_BYTES.labels(tenant)
    return child._value.get() if hasattr(child, "_value") \
        else module.TENANT_UPLOAD_BYTES.value(tenant)


SEQUENCES = {
    "three tenants": ["a", "b", "c", "a", "b"],
    "unsafe tags": ["x y", "x-y", "", None, "\r\nevil", "._-", "ok.1"],
    "overflow": [f"t{i}" for i in range(7)] + ["t0", "t9", "default"],
}


@pytest.mark.parametrize("rate", [0, -5, 1 << 20, 3000.0])
@pytest.mark.parametrize("seq", SEQUENCES)
def test_tenant_buckets_split_and_account_as_jax(run_async, rate, seq):
    tags = SEQUENCES[seq]
    kw = {"min_share_fraction": 0.2, "max_tenants": 4}
    port = pwfq.TenantBuckets(rate, **kw)
    jax = jwfq.TenantBuckets(rate, **kw)
    names = {pqos.normalize_tenant(t) for t in tags} | {"default"}
    before = {t: (_tenant_bytes(pwfq, t), _tenant_bytes(jwfq, t))
              for t in names}
    shares = []
    for t in tags:
        port.bucket(t)
        run_async(asyncio.sleep(0))
        jax.bucket(t)
        shares.append((port.shares(), jax.shares()))
    assert [p for p, _ in shares] == [j for _, j in shares]
    assert port.total_rate == jax.total_rate
    # Accounting: one small debit a tag (within every burst).
    for t in tags:
        port.wait(t, 7)
        run_async(jax.wait(t, 7))
    for t in names:
        assert (_tenant_bytes(pwfq, t) - before[t][0]
                == _tenant_bytes(jwfq, t) - before[t][1])


def test_a_finite_share_blocks_the_calling_thread():
    """A 1000 B/s cap split over two tenants: 500 B/s each, a burst of
    500 B; 750 B waits 0.5 s. The port's wait returns the delay it slept
    (computed, so the tolerance is 0.05 s for the clock between calls)."""
    b = pwfq.TenantBuckets(1000.0)
    b.bucket("a")
    b.bucket("b")
    assert b.shares() == {"a": 500.0, "b": 500.0}
    assert b.wait("a", 500) == 0.0
    assert abs(b.wait("a", 250) - 0.5) < 0.05
    assert b.wait("b", 500) == 0.0


def test_tenant_buckets_are_thread_safe():
    b = pwfq.TenantBuckets()
    tenants = [f"th{i}" for i in range(5)]
    before = {t: _tenant_bytes(pwfq, t) for t in tenants}
    want = {t: 0 for t in tenants}
    plans = []
    rng = random.Random(3)
    for _ in range(8):
        plan = [(rng.choice(tenants), rng.randint(1, 9999))
                for _ in range(2000)]
        for t, n in plan:
            want[t] += n
        plans.append(plan)
    barrier = threading.Barrier(8)

    def run(plan):
        barrier.wait()
        for t, n in plan:
            b.wait(t, n)

    threads = [threading.Thread(target=run, args=(p,), name=f"df-test-{i}")
               for i, p in enumerate(plans)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert {t: _tenant_bytes(pwfq, t) - before[t] for t in tenants} == want
    assert sorted(b.shares()) == sorted(tenants)


def _get(port: int, path: str) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def test_the_upload_server_attributes_tenants_as_jax(run_async, tmp_path):
    paths = ["/download/don/done?pieceNum=0&tenant=qa",
             "/download/don/done?pieceNum=10&tenant=qa",
             "/download/don/done?pieceNum=3",
             "/download/don/done?pieceNum=4&tenant=x%20y",
             "/download/par/partial?pieceNum=5&tenant=qa",   # 404
             "/download/don/done?tenant=rb"]                  # 400
    names = ["qa", "default", "xy", "rb"]

    async def body():
        jax = JUpload(_fill_stores(lambda: JSM(JSMOption(
            data_dir=str(tmp_path / "j"))), JMetadata),
            qos_buckets=jwfq.TenantBuckets())
        port = UploadManager(_fill_stores(lambda: StorageManager(
            StorageOption(data_dir=str(tmp_path / "p"))), TaskStoreMetadata),
            qos_buckets=pwfq.TenantBuckets())
        jport = await jax.serve("127.0.0.1")
        pport = port.serve("127.0.0.1")
        out = {}
        try:
            for side, module, p in (("jax", jwfq, jport),
                                    ("port", pwfq, pport)):
                before = {t: _tenant_bytes(module, t) for t in names}
                statuses = [await asyncio.to_thread(_get, p, path)
                            for path in paths]
                out[side] = (statuses, {t: _tenant_bytes(module, t)
                                        - before[t] for t in names})
        finally:
            await jax.close()
            port.close()
        return out

    out = run_async(body(), timeout=30)
    assert out["port"] == out["jax"]
    assert out["port"][1]["qa"] == 4096 + (10 * 4096 + 1234 - 10 * 4096)


class _Dispatcher:
    """A conductor's dispatcher reduced to a count of pieces to hand out."""

    def __init__(self, pieces: int):
        self.left = pieces

    async def get(self, timeout: float = 30.0):
        await asyncio.sleep(0)
        if self.left <= 0:
            return None
        self.left -= 1
        return object()

    @staticmethod
    def extend_run(a, _max):
        return [a]

    def release_assignment(self, a) -> None:
        pass


async def _contend(cond_module, gate_module) -> dict:
    """Two tasks (priority 6 and 1), 4 workers each, 24 pieces each,
    through one gate of 2 slots; each piece request takes three loop
    turns. Returns the order requests were issued in and the grants."""
    gate = gate_module.WFQGate(2)
    g0 = _grants(gate_module)
    issued = []
    store = types.SimpleNamespace(metadata=types.SimpleNamespace(
        content_length=-1, piece_size=0, total_piece_count=-1))
    conductors = []
    for name, prio in (("hi", 6), ("lo", 1)):
        c = cond_module.PeerTaskConductor(
            task_id=name, peer_id=name, url="http://x/", store=store,
            scheduler_client=None, piece_manager=None, host_info={},
            meta={"priority": prio}, wfq=gate, piece_parallelism=4)
        c.dispatcher = _Dispatcher(24)
        done = [0]

        async def one(a, name=name, done=done):
            issued.append(name)
            for _ in range(3):
                await asyncio.sleep(0)
            done[0] += 1

        async def starve():
            return False

        c._download_one = one
        c._complete = lambda done=done: done[0] >= 24
        c._handle_starvation = starve
        conductors.append(c)
    await asyncio.gather(*(c._piece_worker(i) for c in conductors
                           for i in range(c.piece_parallelism)))
    g1 = _grants(gate_module)
    return {"issued": issued, "active": gate.active,
            "grants": {c: g1[c] - g0[c] for c in g1}}


def test_two_contending_conductors_grant_as_jax(run_async):
    got = run_async(_contend(pcond, pwfq))
    want = run_async(_contend(jcond, jwfq))
    assert got == want
    assert got["grants"]["interactive"] >= 24
    assert got["grants"]["background"] >= 24
    assert got["active"] == 0
    # The interactive task finishes its pieces first.
    assert max(i for i, n in enumerate(got["issued"]) if n == "hi") < max(
        i for i, n in enumerate(got["issued"]) if n == "lo")
