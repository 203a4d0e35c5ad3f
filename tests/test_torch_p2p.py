"""The port's P2P half against the JAX package's, on one fabric.

The JAX harness of ``tests/test_p2p_e2e.py``: an aiohttp origin, the JAX
``SchedulerServer`` (its fast test intervals) and JAX ``Daemon``s. Beside
them, port peers (``PortPeer``): the port's ``StorageManager``,
``PieceManager`` and ``TaskManager`` with the port's ``SchedulerClient``
and conductor factory, its ``UploadManager`` and ``DaemonRpcServer``.

- A port child pulls from a JAX seed as a JAX child does: the bytes, the
  store's piece records (num, offset, size, digest) and ``from_p2p`` are
  the JAX child's; the origin is fetched once; with a digest the
  completion re-hash is skipped; ``device="tpu"`` lands through the
  port's sink on the CPU, every tensor equal.
- A JAX child pulls from a port parent: the same bytes and records, served
  by the port's upload server.
- Twins of the JAX P2P tests: a dead scheduler at registration, the
  scheduler and the seed dying mid-transfer, the certified digest maps'
  provenance, the bounded wait for certification (each case run on both
  packages, the same outcome), and the warm pull's skipped re-hash.
- The store's certification and the completion decision (skipped or
  hashed) against the JAX store's, a corrupt parent's map forcing the
  re-hash.
- The upload server and ``DaemonRpcServer`` answer as the JAX ones do.
- ``chip_smoke.py``'s stand-in scheduler answers with the JAX scheduler's
  keys, and a port child completes against it.

Content comes from numpy seeds. Tolerance 0: bytes and records exact.
"""

from __future__ import annotations

import asyncio
import hashlib
import http.client
import types

import numpy as np
import pytest

import chip_smoke
from dragonfly2_tpu.daemon.daemon import Daemon
from dragonfly2_tpu.daemon.peer.conductor import (
    PeerTaskConductor as JConductor,
)
from dragonfly2_tpu.daemon.peer.piece_dispatcher import (
    PieceDispatcher as JDispatcher,
)
from dragonfly2_tpu.daemon.peer.piece_manager import PieceManager as JPM
from dragonfly2_tpu.daemon.peer.piece_manager import (
    PieceManagerOption as JPMOption,
)
from dragonfly2_tpu.daemon.peer.task_manager import (
    COMPLETION_REHASH as JREHASH,
)
from dragonfly2_tpu.daemon.peer.task_manager import (
    FileTaskRequest as JRequest,
)
from dragonfly2_tpu.daemon.peer.task_manager import TaskManager as JTM
from dragonfly2_tpu.daemon.rpcserver import DaemonRpcServer as JRpcServer
from dragonfly2_tpu.daemon.upload import UploadManager as JUpload
from dragonfly2_tpu.pkg.types import NetAddr as JNetAddr
from dragonfly2_tpu.proto.common import UrlMeta as JMeta
from dragonfly2_tpu.rpc import Client as JClient
from dragonfly2_tpu.storage import LocalTaskStore as JStore
from dragonfly2_tpu.storage import StorageManager as JSM
from dragonfly2_tpu.storage import StorageOption as JSMOption
from dragonfly2_tpu.storage import TaskStoreMetadata as JMetadata
from dragonfly2_tpu_torch.client import device as pdev
from dragonfly2_tpu_torch.daemon.pex import PeerExchange as PPeerExchange
from dragonfly2_tpu_torch.daemon.peer.conductor import (
    PeerTaskConductor,
    conductor_factory,
)
from dragonfly2_tpu_torch.daemon.peer.device_sink import DeviceSinkManager
from dragonfly2_tpu_torch.daemon.peer.piece_dispatcher import PieceDispatcher
from dragonfly2_tpu_torch.daemon.peer.piece_manager import (
    PieceManager,
    PieceManagerOption,
)
from dragonfly2_tpu_torch.daemon.peer.task_manager import (
    COMPLETION_REHASH,
    FileTaskRequest,
    TaskManager,
)
from dragonfly2_tpu_torch.daemon.rpcserver import DaemonRpcServer
from dragonfly2_tpu_torch.daemon.schedulerclient import SchedulerClient
from dragonfly2_tpu_torch.daemon.upload import UPLOAD_BYTES, UploadManager
from dragonfly2_tpu_torch.pkg import digest as pkgdigest
from dragonfly2_tpu_torch.pkg.errors import Code
from dragonfly2_tpu_torch.pkg.piece import compute_piece_count
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.proto.common import UrlMeta
from dragonfly2_tpu_torch.proto.reportcodec import decode_packed as pdecode
from dragonfly2_tpu_torch.rpc import Client
from dragonfly2_tpu_torch.storage import (
    LocalTaskStore,
    StorageManager,
    StorageOption,
    TaskStoreMetadata,
)
from tests.test_p2p_e2e import (
    CONTENT,
    SHA,
    daemon_config,
    dfget_via,
    start_daemon,
    start_origin,
    start_scheduler,
)

MB = 1 << 20


class PortPeer:
    """A port daemon's P2P parts, assembled as the JAX ``Daemon`` builds
    its own: storage, a piece manager (one origin stream, as the JAX
    harness configures its daemons), the task manager with the scheduler
    client and the conductor factory, the upload server and the peer
    drpc server. ``host`` is the record the scheduler sees."""

    def __init__(self, root, name: str, scheduler_port: int, *,
                 seed: bool = False, device_sinks=None):
        self.name = name
        self.storage = StorageManager(StorageOption(data_dir=str(root / name)))
        self.piece_manager = PieceManager(PieceManagerOption(
            concurrency=1, concurrent_min_length=1 << 40))
        self.scheduler_client = SchedulerClient(
            [f"127.0.0.1:{scheduler_port}"])
        self.host: dict = {}
        self.task_manager = TaskManager(
            self.storage, self.piece_manager,
            scheduler_client=self.scheduler_client,
            host_wire=lambda: self.host, device_sinks=device_sinks)
        make = conductor_factory(
            scheduler_client=self.scheduler_client,
            piece_manager=self.piece_manager, host_wire=lambda: self.host,
            task_manager=self.task_manager)

        def factory(**kw):
            # A seed registers every task as a seed's, as a JAX daemon
            # configured as a seed peer does.
            conductor = make(**kw)
            conductor.is_seed = conductor.is_seed or seed
            return conductor
        self.task_manager.conductor_factory = factory
        self.upload = UploadManager(self.storage)
        self.rpc = DaemonRpcServer(self.task_manager)
        self._seed = seed

    async def start(self) -> "PortPeer":
        upload_port = self.upload.serve("127.0.0.1")
        await self.rpc.serve_peer(NetAddr.tcp("127.0.0.1", 0))
        self.host.update(chip_smoke.host_record(
            self.name, self.rpc.peer_server.port(), upload_port,
            host_type=1 if self._seed else 0))
        return self

    async def stop(self) -> None:
        await self.rpc.close()
        self.upload.close()
        await self.scheduler_client.close()
        self.storage.close()

    async def get(self, url: str, output: str = "", digest: str = SHA):
        req = FileTaskRequest(url=url, output=output,
                              meta=UrlMeta(digest=digest))
        return [p async for p in self.task_manager.start_file_task(req)][-1]


def _records(stores) -> set:
    (store,) = [s for s in stores if s.metadata.done]
    return {(p.num, p.offset, p.size, p.digest)
            for p in store.metadata.pieces.values()}


def _crc32c_records(content: bytes, piece_size: int) -> set:
    return {(n, n * piece_size, len(content[n * piece_size:
                                            (n + 1) * piece_size]),
             "crc32c:%08x" % pkgdigest.crc32c(
                 content[n * piece_size:(n + 1) * piece_size]))
            for n in range(compute_piece_count(len(content), piece_size))}


async def _stop(*things) -> None:
    for t in things:
        if t is not None:
            await t.stop()


# --------------------------------------------------------------------- #
# A port child on the JAX fabric, and a JAX child on a port parent
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("digest", ["", SHA], ids=["no-digest", "digest"])
def test_port_child_pulls_from_a_jax_seed_as_a_jax_child_does(
        run_async, tmp_path, digest):
    async def body():
        origin, oport, stats = await start_origin()
        sched = await start_scheduler()
        url = f"http://127.0.0.1:{oport}/blob"
        seed = jchild = child = None
        try:
            seed = await start_daemon(tmp_path, "seed", sched.port(),
                                      seed=True)
            r = await dfget_via(seed, url, str(tmp_path / "s.bin"), digest)
            assert r["state"] == "done", r
            streams = dict(stats)
            jchild = await start_daemon(tmp_path, "jchild", sched.port())
            jr = await dfget_via(jchild, url, str(tmp_path / "j.bin"), digest)
            child = await PortPeer(tmp_path, "child", sched.port()).start()
            skipped = COMPLETION_REHASH.value("skipped")
            hashed = COMPLETION_REHASH.value("hashed")
            pr = await child.get(url, str(tmp_path / "p.bin"), digest)
            rehash = (COMPLETION_REHASH.value("skipped") - skipped,
                      COMPLETION_REHASH.value("hashed") - hashed)
            return (jr, pr, stats, streams, rehash,
                    _records(jchild.storage.tasks()),
                    _records(child.storage.tasks()),
                    child.storage.try_get(pr.task_id).metadata.digest)
        finally:
            await _stop(child, jchild, seed)
            await sched.stop()
            await origin.cleanup()

    jr, pr, stats, streams, rehash, jrecs, precs, pdigest = run_async(
        body(), timeout=120)
    assert jr["state"] == pr.state == "done", (jr, pr)
    assert jr["from_p2p"] and pr.from_p2p and not pr.from_reuse
    assert pr.task_id == jr["task_id"]
    assert (tmp_path / "p.bin").read_bytes() == CONTENT
    assert (tmp_path / "j.bin").read_bytes() == CONTENT
    assert precs == jrecs == _crc32c_records(CONTENT, 4 * MB)
    assert stats == streams             # the origin: the seed's fetch only
    assert rehash == ((1, 0) if digest else (0, 0))
    assert pdigest == digest


def _checkpoint() -> tuple[dict, bytes]:
    from tests.test_safetensors import make_safetensors

    rng = np.random.default_rng(31)
    tensors = {
        "model.embed": rng.standard_normal((1024, 2048)).astype(np.float32),
        "model.w_bf16": rng.integers(0, 1 << 16, (1024, 1024), np.uint16),
        "model.norm": rng.standard_normal(4096).astype(np.float16),
    }
    dtypes = {"model.embed": "F32", "model.w_bf16": "BF16",
              "model.norm": "F16"}
    return tensors, make_safetensors(tensors, dtypes)


def test_port_child_lands_a_jax_seeds_pieces_on_the_device_sink(
        run_async, tmp_path):
    """``download_to_device`` on a port child (the sink on the CPU, K2's
    plain version) pulling every piece from a JAX seed: the tensors are
    the checkpoint's, bit for bit."""
    from tests.test_torch_task_manager import start_origin as start_blob

    tensors, blob = _checkpoint()

    async def body():
        runner, base, stats = await start_blob(blob)
        sched = await start_scheduler()
        url = f"{base}/blob"
        seed = child = None
        try:
            seed = await start_daemon(tmp_path, "seed", sched.port(),
                                      seed=True)
            r = await dfget_via(seed, url, str(tmp_path / "s.bin"), "")
            assert r["state"] == "done", r
            gets = dict(stats)
            child = await PortPeer(
                tmp_path, "child", sched.port(),
                device_sinks=DeviceSinkManager(device="cpu")).start()
            result = await pdev.download_to_device(
                types.SimpleNamespace(task_manager=child.task_manager), url)
            got = result.load_safetensors()
            return result.from_p2p, {k: v.clone() for k, v in got.items()}, \
                stats == gets
        finally:
            await _stop(child, seed)
            await sched.stop()
            await runner.cleanup()

    from_p2p, got, no_origin = run_async(body(), timeout=120)
    assert from_p2p and no_origin
    assert set(got) == set(tensors)
    for name, want in tensors.items():
        assert got[name].reshape(-1).view(dtype=__import__("torch").uint8) \
            .numpy().tobytes() == want.tobytes()


def test_a_jax_child_pulls_from_a_port_parent(run_async, tmp_path):
    """The roles swapped: a port parent (seed) fetches back-to-source
    through the JAX scheduler; a JAX child's pieces then come from its
    upload server and DaemonRpcServer."""
    async def body():
        origin, oport, stats = await start_origin()
        sched = await start_scheduler()
        url = f"http://127.0.0.1:{oport}/blob"
        parent = jchild = None
        try:
            parent = await PortPeer(tmp_path, "parent", sched.port(),
                                    seed=True).start()
            pr = await parent.get(url, str(tmp_path / "p.bin"))
            streams = dict(stats)
            served = UPLOAD_BYTES.value()
            jchild = await start_daemon(tmp_path, "jchild", sched.port())
            jr = await dfget_via(jchild, url, str(tmp_path / "j.bin"))
            return (pr, jr, stats == streams, UPLOAD_BYTES.value() - served,
                    _records(parent.storage.tasks()),
                    _records(jchild.storage.tasks()))
        finally:
            await _stop(jchild, parent)
            await sched.stop()
            await origin.cleanup()

    pr, jr, no_origin, served, precs, jrecs = run_async(body(), timeout=120)
    assert pr.state == "done" and not pr.from_p2p
    assert jr["state"] == "done" and jr["from_p2p"], jr
    assert (tmp_path / "j.bin").read_bytes() == CONTENT
    assert no_origin and served == len(CONTENT)
    assert jrecs == precs == _crc32c_records(CONTENT, 4 * MB)


# --------------------------------------------------------------------- #
# Twins of the JAX P2P tests (tests/test_p2p_e2e.py)
# --------------------------------------------------------------------- #

def test_dead_scheduler_at_register_degrades_to_back_source(run_async,
                                                            tmp_path):
    async def body():
        origin, oport, stats = await start_origin()
        url = f"http://127.0.0.1:{oport}/blob"
        peer = None
        try:
            peer = await PortPeer(tmp_path, "p1", 1).start()
            r = await peer.get(url, str(tmp_path / "o.bin"))
            r2 = await peer.get(url, str(tmp_path / "o2.bin"))
            return r, r2
        finally:
            await _stop(peer)
            await origin.cleanup()

    r, r2 = run_async(body(), timeout=60)
    assert r.state == "done" and not r.from_p2p
    assert (tmp_path / "o.bin").read_bytes() == CONTENT
    assert r2.from_reuse


def test_scheduler_death_mid_transfer_download_still_lands(run_async,
                                                           tmp_path):
    async def body():
        origin, oport, stats = await start_origin()
        sched = await start_scheduler()
        url = f"http://127.0.0.1:{oport}/blob"
        seed = p1 = None
        try:
            seed_cfg = daemon_config(tmp_path, "seed", sched.port(), seed=True)
            seed_cfg.upload.rate_limit = 4 * MB  # slow serving
            seed = Daemon(seed_cfg)
            await seed.start()
            p1 = await PortPeer(tmp_path, "p1", sched.port()).start()

            async def killer():
                for _ in range(200):
                    if any(s.metadata.pieces for s in p1.storage.tasks()):
                        break
                    await asyncio.sleep(0.02)
                await sched.stop()

            kill = asyncio.ensure_future(killer())
            r = await p1.get(url, str(tmp_path / "s1.bin"))
            await kill
            return r
        finally:
            await _stop(p1, seed)
            try:
                await sched.stop()
            except Exception:
                pass
            await origin.cleanup()

    r = run_async(body(), timeout=120)
    assert r.state == "done", r
    assert hashlib.sha256((tmp_path / "s1.bin").read_bytes()).hexdigest() \
        == SHA.split(":")[1]


def test_seed_death_mid_transfer_peers_recover(run_async, tmp_path):
    async def body():
        origin, oport, stats = await start_origin()
        sched = await start_scheduler()
        url = f"http://127.0.0.1:{oport}/blob"
        seed = p1 = p2 = None
        try:
            seed_cfg = daemon_config(tmp_path, "seed", sched.port(), seed=True)
            seed_cfg.upload.rate_limit = 4 * MB
            seed = Daemon(seed_cfg)
            await seed.start()
            p1 = await PortPeer(tmp_path, "p1", sched.port()).start()
            p2 = await PortPeer(tmp_path, "p2", sched.port()).start()

            async def killer():
                for _ in range(200):
                    if any(s.metadata.pieces for d in (p1, p2)
                           for s in d.storage.tasks()):
                        break
                    await asyncio.sleep(0.02)
                await seed.stop()

            kill = asyncio.ensure_future(killer())
            try:
                results = await asyncio.gather(
                    p1.get(url, str(tmp_path / "k1.bin")),
                    p2.get(url, str(tmp_path / "k2.bin")))
                await kill
            finally:
                kill.cancel()
            return results, dict(stats)
        finally:
            await _stop(p2, p1, seed)
            await sched.stop()
            await origin.cleanup()

    results, stats = run_async(body(), timeout=120)
    for i, r in enumerate(results):
        assert r.state == "done", r
        got = (tmp_path / f"k{i + 1}.bin").read_bytes()
        assert hashlib.sha256(got).hexdigest() == SHA.split(":")[1]
    assert stats["blob_bytes"] <= 3 * len(CONTENT) + MB, stats


@pytest.mark.parametrize("cls", [PieceDispatcher, JDispatcher],
                         ids=["port", "jax"])
def test_certified_digests_provenance(cls):
    d = cls()
    d.upsert_parent("corrupt", "10.0.0.1", 1)
    d.upsert_parent("honest", "10.0.0.2", 1)
    d.on_parent_pieces("corrupt", [0, 1],
                       digests={0: "crc32c:bad00000", 1: "crc32c:bad00001"})
    assert d.certified_digest_maps() == []
    d.on_parent_pieces("honest", [0, 1],
                       digests={0: "crc32c:00000aaa", 1: "crc32c:00000bbb"})
    d.note_parent_done("honest")
    assert d.certified_digest_maps() == [
        {0: "crc32c:00000aaa", 1: "crc32c:00000bbb"}]
    assert d.piece_digests[0] in ("crc32c:bad00000", "crc32c:00000aaa")
    d.note_parent_done("corrupt")
    maps = d.certified_digest_maps()
    assert {0: "crc32c:00000aaa", 1: "crc32c:00000bbb"} in maps
    assert {0: "crc32c:bad00000", 1: "crc32c:bad00001"} in maps
    assert d.pending_certifiers() is False


def _cert_stub(store_cls, content_length: int, pieces_verified: bool,
               certifies):
    """A minimal store: a pluggable ``certifies`` and the package's REAL
    ``apply_certification``."""
    stub = types.SimpleNamespace(
        metadata=types.SimpleNamespace(content_length=content_length),
        certified_digests=None,
        pieces_verified_against_digests=lambda: pieces_verified,
        certifies=lambda m: bool(m) and certifies(m))
    stub.apply_certification = lambda maps: store_cls.apply_certification(
        stub, maps)
    return stub


def _cert_conductor(pkg: str, content_length: int, meta: dict, *,
                    pieces_verified: bool = True, certifies=None):
    cls, store_cls = ((PeerTaskConductor, LocalTaskStore) if pkg == "port"
                      else (JConductor, JStore))
    return cls(task_id="t", peer_id="p", url="http://x/",
               store=_cert_stub(store_cls, content_length, pieces_verified,
                                certifies or (lambda m: True)),
               scheduler_client=None, piece_manager=None, host_info={},
               meta=meta)


async def _timed_wait(c) -> tuple[bool, float]:
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    ok = await c._await_certification()
    return ok, loop.time() - t0


@pytest.mark.parametrize("pkg", ["port", "jax"])
class TestAwaitCertification:
    """The bounded wait for a parent's certification, each case on both
    packages: the same outcome."""

    def test_catches_a_late_done(self, run_async, pkg):
        async def body():
            c = _cert_conductor(pkg, 512 << 20, {"digest": "sha256:x"})
            c.dispatcher.upsert_parent("seed", "10.0.0.1", 1)
            digests = {0: "crc32c:0000000a"}

            async def late_done():
                await asyncio.sleep(0.03)
                c.dispatcher.on_parent_pieces("seed", [0], digests=digests)
                c.dispatcher.note_parent_done("seed")

            t = asyncio.ensure_future(late_done())
            out = await _timed_wait(c)
            await t
            return out, c.store.certified_digests, digests

        (ok, elapsed), installed, digests = run_async(body(), timeout=10)
        assert ok is True and installed == digests
        assert elapsed < 0.5

    def test_corrupt_early_done_does_not_eat_the_budget(self, run_async, pkg):
        honest = {0: "crc32c:0000000a"}
        corrupt = {0: "crc32c:deadbeef"}

        async def body():
            c = _cert_conductor(pkg, 512 << 20, {"digest": "sha256:x"},
                                certifies=lambda m: m == honest)
            c.dispatcher.upsert_parent("bad", "10.0.0.1", 1)
            c.dispatcher.upsert_parent("good", "10.0.0.2", 1)
            c.dispatcher.on_parent_pieces("bad", [0], digests=corrupt)
            c.dispatcher.note_parent_done("bad")

            async def honest_done():
                await asyncio.sleep(0.03)
                c.dispatcher.on_parent_pieces("good", [0], digests=honest)
                c.dispatcher.note_parent_done("good")

            t = asyncio.ensure_future(honest_done())
            ok = await c._await_certification()
            await t
            return ok, c.store.certified_digests

        assert run_async(body(), timeout=10) == (True, honest)

    def test_bound_formula_stays_near_break_even(self, pkg):
        bound = (PeerTaskConductor if pkg == "port"
                 else JConductor)._cert_wait_bound
        assert bound(1 << 20) < 0.06
        assert 0.15 < bound(64 << 20) < 0.25
        assert bound(8 << 30) == 3.0
        assert bound(1 << 20) < bound(64 << 20) <= bound(8 << 30)
        assert bound(64 << 20) == JConductor._cert_wait_bound(64 << 20)

    def test_bound_is_the_estimated_rehash_cost(self, run_async, pkg):
        async def body():
            c = _cert_conductor(pkg, 64 << 20, {"digest": "sha256:x"})
            c.dispatcher.upsert_parent("seed", "10.0.0.1", 1)  # never done
            return await _timed_wait(c)

        ok, elapsed = run_async(body(), timeout=10)
        assert ok is False and 0.15 <= elapsed < 1.5, elapsed

    def test_unverified_piece_makes_the_wait_futile(self, run_async, pkg):
        async def body():
            c = _cert_conductor(pkg, 512 << 20, {"digest": "sha256:x"},
                                pieces_verified=False)
            c.dispatcher.upsert_parent("seed", "10.0.0.1", 1)
            return await _timed_wait(c)

        ok, elapsed = run_async(body(), timeout=10)
        assert ok is False and elapsed < 0.05

    def test_scheduler_demotion_ends_the_wait(self, run_async, pkg):
        async def body():
            c = _cert_conductor(pkg, 8 << 30, {"digest": "sha256:x"})
            c.dispatcher.upsert_parent("a", "10.0.0.1", 1)
            c.dispatcher.upsert_parent("b", "10.0.0.2", 1)

            async def demote():
                await asyncio.sleep(0.03)
                for pid in list(c.dispatcher.parents):
                    c.dispatcher.drop_parent(pid)

            t = asyncio.ensure_future(demote())
            out = await _timed_wait(c)
            await t
            return out

        ok, elapsed = run_async(body(), timeout=10)
        assert ok is False and elapsed < 1.0, elapsed

    def test_no_rehash_pending_no_wait(self, run_async, pkg):
        async def body():
            c = _cert_conductor(pkg, 64 << 20, {})
            c.dispatcher.upsert_parent("seed", "10.0.0.1", 1)
            return await _timed_wait(c)

        ok, elapsed = run_async(body(), timeout=10)
        assert ok is False and elapsed < 0.05

    def test_last_certifier_dropping_ends_the_wait(self, run_async, pkg):
        async def body():
            c = _cert_conductor(pkg, 8 << 30, {"digest": "sha256:x"})
            c.dispatcher.upsert_parent("seed", "10.0.0.1", 1)

            async def drop():
                await asyncio.sleep(0.03)
                c.dispatcher.drop_parent("seed")

            t = asyncio.ensure_future(drop())
            out = await _timed_wait(c)
            await t
            return out

        ok, elapsed = run_async(body(), timeout=10)
        assert ok is False and elapsed < 1.0, elapsed


def test_warm_pull_skips_whole_content_rehash(run_async, tmp_path,
                                              monkeypatch):
    """A port child pulling from a DONE (validated) JAX seed skips the
    completion re-hash; the seed, the trust anchor, still validates."""
    calls: list[str] = []
    real_port, real_jax = LocalTaskStore.validate_digest, JStore.validate_digest

    def spy(real):
        def f(self, expected=""):
            calls.append(self.dir)
            return real(self, expected)
        return f

    monkeypatch.setattr(LocalTaskStore, "validate_digest", spy(real_port))
    monkeypatch.setattr(JStore, "validate_digest", spy(real_jax))

    async def body():
        origin, oport, stats = await start_origin()
        sched = await start_scheduler()
        url = f"http://127.0.0.1:{oport}/blob"
        seed = p1 = None
        try:
            seed = await start_daemon(tmp_path, "seed", sched.port(),
                                      seed=True)
            r = await dfget_via(seed, url, str(tmp_path / "w0.bin"))
            assert r["state"] == "done", r
            p1 = await PortPeer(tmp_path, "p1", sched.port()).start()
            before = (COMPLETION_REHASH.value("skipped"),
                      COMPLETION_REHASH.value("hashed"))
            r = await p1.get(url, str(tmp_path / "w1.bin"))
            after = (COMPLETION_REHASH.value("skipped"),
                     COMPLETION_REHASH.value("hashed"))
            return r, before, after, [s.metadata.digest
                                      for s in p1.storage.tasks()]
        finally:
            await _stop(p1, seed)
            await sched.stop()
            await origin.cleanup()

    r, before, after, digests = run_async(body(), timeout=120)
    assert r.state == "done" and r.from_p2p
    assert (tmp_path / "w1.bin").read_bytes() == CONTENT
    assert [c for c in calls if "/seed/" in c], "the seed must validate"
    assert not [c for c in calls if "/p1/" in c], "the child re-hashed"
    assert digests == [SHA]
    assert after == (before[0] + 1, before[1])


# --------------------------------------------------------------------- #
# The store's certification and the completion decision
# --------------------------------------------------------------------- #

_PIECES = [np.random.default_rng(7 + i).integers(0, 256, 4096, np.uint8)
           .tobytes() for i in range(3)]
_OWN = {i: "crc32c:%08x" % pkgdigest.crc32c(p) for i, p in enumerate(_PIECES)}
_CORRUPT = {i: "crc32c:deadbee%d" % i for i in range(3)}

CERT_CASES = {
    # (pieces written with their advertised digest, candidate maps)
    "honest": ([0, 1, 2], [_OWN]),
    "corrupt": ([0, 1, 2], [_CORRUPT]),
    "corrupt-then-honest": ([0, 1, 2], [_CORRUPT, _OWN]),
    "one-piece-self-computed": ([0, 1], [_OWN]),
    "incomplete": ([0, 1], [_OWN]),
    "no-map": ([0, 1, 2], []),
}


@pytest.mark.parametrize("case", CERT_CASES)
def test_certification_decides_as_the_jax_store_does(run_async, tmp_path,
                                                     case):
    verified, maps = CERT_CASES[case]

    def fill(store):
        for n, data in enumerate(_PIECES):
            if case == "incomplete" and n == 2:
                continue
            store.write_piece(n, data, _OWN[n] if n in verified else "")
        return (store.pieces_verified_against_digests(),
                store.apply_certification(maps),
                store.pieces_all_digest_verified(), store.certified_digests)

    meta = dict(task_id="t", piece_size=4096, content_length=3 * 4096,
                total_piece_count=3)
    port = fill(LocalTaskStore.create(str(tmp_path / "p"),
                                      TaskStoreMetadata(**meta)))
    jax = fill(JStore.create(str(tmp_path / "j"), JMetadata(**meta)))
    assert port == jax
    assert port[2] is (case in ("honest", "corrupt-then-honest"))

    async def decide(tm, store, counter):
        def value(result):
            c = counter.labels(result)
            return c._value.get() if hasattr(c, "_value") else \
                counter.value(result)
        before = (value("skipped"), value("hashed"))
        try:
            await tm._finalize_content_digest(req, store)
            outcome = "ok"
        except Exception as e:
            outcome = type(e).__name__
        return outcome, value("skipped") - before[0], \
            value("hashed") - before[1]

    data = b"".join(_PIECES if case != "incomplete" else _PIECES[:2])
    sha = "sha256:" + hashlib.sha256(data).hexdigest()
    req = types.SimpleNamespace(meta=types.SimpleNamespace(digest=sha),
                                range=None)
    pstore = LocalTaskStore.load(str(tmp_path / "p"))
    jstore = JStore.load(str(tmp_path / "j"))
    for s, (_, _, _, installed) in ((pstore, port), (jstore, jax)):
        s._verified_pieces = {n: _OWN[n] for n in verified}
        s.certified_digests = installed
    ptm = TaskManager(StorageManager(StorageOption(
        data_dir=str(tmp_path / "ps"))), PieceManager())
    jtm = JTM(JSM(JSMOption(data_dir=str(tmp_path / "js"))), JPM(JPMOption()))
    got = run_async(decide(ptm, pstore, COMPLETION_REHASH))
    want = run_async(decide(jtm, jstore, JREHASH))
    assert got == want


# --------------------------------------------------------------------- #
# The upload server and DaemonRpcServer against the JAX ones
# --------------------------------------------------------------------- #

_UPLOAD = np.random.default_rng(5).integers(0, 256, 10 * 4096 + 1234,
                                            np.uint8).tobytes()


def _fill_stores(make_storage, metadata_cls):
    """A done task 'done' (11 pieces of 4 KiB) and a task 'partial' still
    downloading (pieces 0-3 and 6 landed)."""
    storage = make_storage()
    for task_id, nums in (("done", range(11)), ("partial", (0, 1, 2, 3, 6))):
        store = storage.register_task(metadata_cls(
            task_id=task_id, piece_size=4096, content_length=len(_UPLOAD),
            total_piece_count=11))
        for n in nums:
            store.write_piece(n, _UPLOAD[n * 4096:(n + 1) * 4096])
        if task_id == "done":
            store.mark_done()
    return storage


UPLOAD_CASES = {
    "no task": ("/download/non/none?peerId=x&pieceNum=0", {}),
    "bad pieceNum": ("/download/don/done?pieceNum=abc", {}),
    "missing piece": ("/download/par/partial?pieceNum=5", {}),
    "no range": ("/download/don/done?peerId=x", {}),
    "bad range": ("/download/don/done", {"Range": "bytes=9-3"}),
    "range not held": ("/download/par/partial", {"Range": "bytes=0-20479"}),
    "piece 0": ("/download/don/done?peerId=x&pieceNum=0&tenant=t", {}),
    "last piece": ("/download/don/done?pieceNum=10", {}),
    "range": ("/download/don/done", {"Range": "bytes=100-9000"}),
    "open range": ("/download/don/done", {"Range": "bytes=40000-"}),
    "suffix range": ("/download/don/done", {"Range": "bytes=-100"}),
    "partial store": ("/download/par/partial", {"Range": "bytes=4096-16383"}),
    "partial piece": ("/download/par/partial?pieceNum=6", {}),
    "healthy": ("/healthy", {}),
    "no route": ("/nope", {}),
    "over the limit": ("/download/don/done?pieceNum=1", {}),
}


def _get(port: int, path: str, headers: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        body = resp.read()
        return (resp.status, body if resp.status < 300 else None,
                resp.getheader("Content-Range"))
    finally:
        conn.close()


@pytest.mark.parametrize("case", UPLOAD_CASES)
def test_upload_server_answers_as_the_jax_one(run_async, tmp_path, case):
    path, headers = UPLOAD_CASES[case]

    async def body():
        # A rate limit keeps the JAX server on its aiohttp path (the
        # native one waits for the port's native slice).
        jax = JUpload(_fill_stores(lambda: JSM(JSMOption(
            data_dir=str(tmp_path / "j"))), JMetadata), rate_limit=1 << 40)
        port = UploadManager(_fill_stores(lambda: StorageManager(
            StorageOption(data_dir=str(tmp_path / "p"))), TaskStoreMetadata))
        jport = await jax.serve("127.0.0.1")
        pport = port.serve("127.0.0.1")
        if case == "over the limit":
            for m in (jax, port):
                m.concurrent_limit, m.concurrent = 1, 1
        try:
            return (await asyncio.to_thread(_get, jport, path, headers),
                    await asyncio.to_thread(_get, pport, path, headers))
        finally:
            await jax.close()
            port.close()

    want, got = run_async(body(), timeout=30)
    assert got == want
    if want[0] == 206:
        rng = want[2].split()[1].split("/")[0]
        start, end = (int(x) for x in rng.split("-"))
        assert got[1] == _UPLOAD[start:end + 1]


def test_daemon_rpc_server_answers_as_the_jax_one(run_async, tmp_path):
    """``Peer.GetPieceTasks`` and ``Peer.SyncPieceTasks`` over the same
    stores: a done task (one snapshot, then the close), a task still
    downloading (its snapshot, a piece landing, its completion), an
    unknown task (StorageTaskNotFound)."""
    from dragonfly2_tpu.daemon.peer.broker import PieceEvent as JEvent
    from dragonfly2_tpu_torch.daemon.peer.broker import PieceEvent

    async def one(tm, server, client_cls, addr_cls, event_cls) -> list:
        await server.serve_peer(addr_cls.tcp("127.0.0.1", 0))
        cli = client_cls(addr_cls.tcp("127.0.0.1", server.peer_server.port()))
        out = []
        try:
            for task in ("done", "partial"):
                out.append(await cli.call("Peer.GetPieceTasks",
                                          {"task_id": task}))
            for task in ("none", ""):
                try:
                    await cli.call("Peer.GetPieceTasks", {"task_id": task})
                except Exception as e:
                    out.append(int(e.code))
            s = await cli.open_stream("Peer.SyncPieceTasks",
                                      {"task_id": "done", "peer_id": "c"})
            out += [await s.recv(), await s.recv()]
            s = await cli.open_stream("Peer.SyncPieceTasks",
                                      {"task_id": "partial"})
            out.append(await s.recv())
            await s.send({"interested": True})
            tm.broker.publish("partial", event_cls(
                [7], 11, len(_UPLOAD), 4096, digests={7: "crc32c:00000007"}))
            out.append(await s.recv())
            tm.broker.publish("partial", event_cls([], 11, len(_UPLOAD),
                                                   4096, done=True))
            out += [await s.recv(), await s.recv()]
            bad = await cli.open_stream("Peer.SyncPieceTasks",
                                        {"task_id": "none"})
            try:
                await bad.recv()
            except Exception as e:
                out.append(int(e.code))
        finally:
            await cli.close()
            await server.close()
        return out

    async def body():
        jtm = JTM(_fill_stores(lambda: JSM(JSMOption(
            data_dir=str(tmp_path / "j"))), JMetadata), JPM(JPMOption()))
        ptm = TaskManager(_fill_stores(lambda: StorageManager(StorageOption(
            data_dir=str(tmp_path / "p"))), TaskStoreMetadata),
            PieceManager())
        return (await one(jtm, JRpcServer(jtm), JClient, JNetAddr, JEvent),
                await one(ptm, DaemonRpcServer(ptm), Client, NetAddr,
                          PieceEvent))

    want, got = run_async(body(), timeout=30)
    assert got == want
    assert want[2:4] == [int(Code.StorageTaskNotFound)] * 2
    assert want[-1] == int(Code.StorageTaskNotFound)


# --------------------------------------------------------------------- #
# chip_smoke.py's stand-in scheduler
# --------------------------------------------------------------------- #

def _shape(v):
    """The keys of ``v``, recursively (a list by its first item)."""
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()
                if not isinstance(k, int)}
    if isinstance(v, list) and v and isinstance(v[0], dict):
        return [_shape(v[0])]
    return None


async def _register(client, open_body: dict) -> dict:
    stream = await client.open_stream("Scheduler.AnnouncePeer", open_body)
    await stream.send({"type": "register"})
    msg = await stream.recv(timeout=30)
    await stream.close()
    return msg


def test_the_stand_in_scheduler_answers_as_the_jax_scheduler(run_async,
                                                             tmp_path):
    """The scenario of the ``p2p`` phase: a parent holds the task done, a
    child registers. The stand-in's ``normal_task`` has the keys of the
    JAX scheduler's (task, parent, host), and a port child completes
    against it: every piece from the parent's upload server, 3 pieces
    reported and one ``download_finished``."""
    async def body():
        origin, oport, stats = await start_origin()
        sched = await start_scheduler()
        url = f"http://127.0.0.1:{oport}/blob"
        seed = parent = child = None
        try:
            seed = await start_daemon(tmp_path, "seed", sched.port(),
                                      seed=True)
            await dfget_via(seed, url, str(tmp_path / "s.bin"))
            task_id = JRequest(url=url, output="",
                               meta=JMeta(digest=SHA)).task_id()
            open_body = {"host": chip_smoke.host_record("c", 1, 2),
                         "peer_id": "child-peer", "task_id": task_id,
                         "url": url, "digest": SHA}
            jcli = JClient(JNetAddr.tcp("127.0.0.1", sched.port()))
            # The seed's reports reach the scheduler after its dfget
            # returned: wait until the scheduler holds the task done.
            for _ in range(500):
                stat = await jcli.call("Scheduler.StatTask",
                                       {"task_id": task_id})
                if stat["state"] == "succeeded":
                    break
                await asyncio.sleep(0.01)
            want = await _register(jcli, open_body)
            await jcli.close()

            parent = chip_smoke.P2PParentDaemon()
            addr = await parent.start(str(tmp_path / "parent"))
            await parent.fetch(url, SHA)
            host, port = addr.rsplit(":", 1)
            pcli = Client(NetAddr.tcp(host, int(port)))
            got = await _register(pcli, open_body)
            await pcli.close()
            streams = dict(stats)
            child = await PortPeer(tmp_path, "child", int(port)).start()
            r = await child.get(url, str(tmp_path / "c.bin"))
            summary = await parent.scheduler.summary(task_id)
            return want, got, r, summary.get(task_id), stats == streams
        finally:
            await _stop(child, seed)
            if parent is not None:
                await parent.close()
            await sched.stop()
            await origin.cleanup()

    want, got, r, record, no_origin = run_async(body(), timeout=120)
    assert want["type"] == got["type"] == "normal_task"
    assert _shape(got) == _shape(want)
    assert got["packed_reports"] is want["packed_reports"] is True
    assert got["task"]["size_scope"] == want["task"]["size_scope"]
    assert got["parents"][0]["finished_pieces"] == \
        want["parents"][0]["finished_pieces"]
    assert got["parents"][0]["piece_digests"] == \
        want["parents"][0]["piece_digests"]
    assert r.state == "done" and r.from_p2p and no_origin
    assert (tmp_path / "c.bin").read_bytes() == CONTENT
    assert record["reported"] == record["pieces"] == 3
    assert record["messages"]["download_finished"] == 1
    assert "download_failed" not in record["messages"]


# --------------------------------------------------------------------- #
# The piece downloader against the JAX one
# --------------------------------------------------------------------- #

async def _chunks(parts):
    for p in parts:
        yield p


@pytest.mark.parametrize("case", [
    ("crc32c", 3 * 4096, ""), ("crc32c", 3 * 4096, "crc32c:0000abcd"),
    ("sha256", 3 * 4096, "sha256:" + "0" * 64), ("md5", -1, "md5:" + "1" * 32),
    ("over", 2 * 4096, ""), ("under", 4 * 4096, ""),
    ("malformed", 3 * 4096, "sha256:xyz")], ids=lambda c: c[0])
def test_assemble_piece_is_the_jax_one(run_async, case):
    from dragonfly2_tpu.daemon.peer.piece_downloader import (
        assemble_piece as jassemble,
    )
    from dragonfly2_tpu_torch.daemon.peer.piece_downloader import (
        assemble_piece,
        failure_reason,
    )

    _, size, digest = case
    parts = [_UPLOAD[i * 4096:(i + 1) * 4096] for i in range(3)]

    async def one(fn):
        try:
            chunks, got, digest_str = await fn(_chunks(parts), size, digest)
            return b"".join(chunks), got, digest_str
        except Exception as e:
            return int(e.code), e.message, failure_reason(e)

    assert run_async(one(assemble_piece)) == run_async(one(jassemble))


@pytest.mark.parametrize("case", {
    "piece 0": ("done", 0, 4096, ""),
    "short last piece": ("done", 10, 1234, ""),
    "with its digest": ("done", 3, 4096, "crc32c"),
    "sha256 streamed": ("done", 4, 4096, "sha256"),
    "too long": ("done", 5, 100, ""),
    "missing piece": ("partial", 5, 4096, ""),
    "no task": ("none", 0, 4096, ""),
    "over the limit": ("done", 1, 4096, ""),
}.items(), ids=lambda c: c[0])
def test_download_piece_is_the_jax_one(run_async, tmp_path, case):
    """One piece from a JAX upload server by each package's downloader:
    the same bytes, size and streamed digest, or the same code and
    reason."""
    from dragonfly2_tpu.daemon.peer.piece_downloader import (
        PieceDownloader as JDownloader,
    )
    from dragonfly2_tpu.daemon.peer.piece_downloader import (
        failure_reason as jreason,
    )
    from dragonfly2_tpu_torch.daemon.peer.piece_downloader import (
        PieceDownloader,
        failure_reason,
    )

    name, (task, num, size, alg) = case
    piece = _UPLOAD[num * 4096:num * 4096 + size]
    digest = (str(pkgdigest.hash_bytes(alg, piece)) if alg else "")

    async def one(dl, reason, port) -> tuple:
        try:
            chunks, got, _, digest_str = await dl.download_piece(
                "127.0.0.1", port, task, num, src_peer_id="c",
                expected_size=size, expected_digest=digest, tenant="t")
            return b"".join(chunks), got, digest_str
        except Exception as e:
            return int(e.code), reason(e)
        finally:
            await dl.close()

    async def body():
        server = JUpload(_fill_stores(lambda: JSM(JSMOption(
            data_dir=str(tmp_path / "j"))), JMetadata), rate_limit=1 << 40)
        port = await server.serve("127.0.0.1")
        if name == "over the limit":
            server.concurrent_limit = server.concurrent = 1
        try:
            return (await one(JDownloader(), jreason, port),
                    await one(PieceDownloader(), failure_reason, port))
        finally:
            await server.close()

    want, got = run_async(body(), timeout=30)
    assert got == want
    if name in ("piece 0", "short last piece", "with its digest"):
        assert got == (piece, size, "")
    if name == "sha256 streamed":
        assert got == (piece, size, digest)


def test_a_span_lands_each_piece_and_fails_only_the_corrupt_one(run_async,
                                                                tmp_path):
    """A run of five pieces as one ranged GET from the port's upload
    server into a port store: each piece lands through the fused crc32c
    write, checked against its advertised digest; a piece advertised with
    a wrong digest fails alone (``corrupt``), unrecorded; results arrive
    in piece order; a run with a non-crc32c digest is refused."""
    from dragonfly2_tpu_torch.daemon.peer.piece_dispatcher import (
        ParentInfo,
        PieceAssignment,
    )
    from dragonfly2_tpu_torch.daemon.peer.piece_downloader import (
        PieceDownloader,
        failure_reason,
    )

    parent_storage = _fill_stores(lambda: StorageManager(StorageOption(
        data_dir=str(tmp_path / "parent"))), TaskStoreMetadata)
    child = LocalTaskStore.create(str(tmp_path / "child"), TaskStoreMetadata(
        task_id="done", piece_size=4096, content_length=len(_UPLOAD),
        total_piece_count=11))
    server = UploadManager(parent_storage)
    port = server.serve("127.0.0.1")
    parent = ParentInfo("p", "127.0.0.1", port)

    def run_of(nums, bad=()):
        return [PieceAssignment(n, parent, 4096, digest=(
            "crc32c:%08x" % (pkgdigest.crc32c(
                _UPLOAD[n * 4096:(n + 1) * 4096]) ^ (n in bad))))
            for n in nums]

    async def body():
        dl = PieceDownloader()
        results = []

        async def on_result(a, rec, err):
            results.append((a.piece_num, rec is not None,
                            None if err is None else failure_reason(err)))

        try:
            ok = await dl.download_span_to_store(
                "127.0.0.1", port, "done", run_of(range(2, 7), bad={4}),
                child, src_peer_id="c", on_result=on_result)
            sha_run = run_of([7, 8])
            sha_run[1].digest = "sha256:" + "0" * 64
            refused = await dl.download_span_to_store(
                "127.0.0.1", port, "done", sha_run, child,
                on_result=on_result)
            return ok, refused, results, dict(dl.timings)
        finally:
            await dl.close()
            server.close()

    ok, refused, results, timings = run_async(body(), timeout=30)
    assert ok is True and refused is False
    assert results == [(2, True, None), (3, True, None), (4, False, "corrupt"),
                       (5, True, None), (6, True, None)]
    assert sorted(child.metadata.pieces) == [2, 3, 5, 6]
    for n in (2, 3, 5, 6):
        assert child.read_piece(n) == _UPLOAD[n * 4096:(n + 1) * 4096]
    assert child.pieces_verified_against_digests()
    assert timings["get_wait_s"] > 0 and timings["store_write_s"] > 0


def test_a_cancelled_call_closes_its_kept_alive_connection():
    """A call cancelled before its request goes out closes the kept-alive
    connection it took from the idle list: nothing keeps or leaks it."""
    from dragonfly2_tpu_torch.daemon.peer import piece_downloader as pdl
    from dragonfly2_tpu_torch.pkg.bufpool import CallAborted, WorkerCall

    closed = []

    class Conn:
        sock = None

        def close(self):
            closed.append(self)

    dl = pdl.PieceDownloader()
    key = ("127.0.0.1", 1)
    conn = Conn()
    dl._idle[key] = [conn]
    call = WorkerCall()
    call.abort()
    with pytest.raises(CallAborted):
        dl._exchange(call, key, "/", {})
    assert closed and set(closed) == {conn} and not dl._idle[key]


def test_pins_from_many_serving_threads_balance(tmp_path):
    """The upload server pins a store from each of its threads: pins and
    unpins from more threads than cores, with a short switch interval,
    leave no pin behind and never lose one (a store served is pinned)."""
    import sys
    import threading

    store = LocalTaskStore.create(str(tmp_path / "s"), TaskStoreMetadata(
        task_id="t", piece_size=4096, content_length=4096))
    store.pin()
    lost = []

    def churn():
        for _ in range(2000):
            store.pin()
            if not store.pinned:
                lost.append(1)
            store.unpin()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn, name=f"df-test-{i}")
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert lost == [] and store._pins == 1
    store.unpin()
    assert not store.pinned


def test_upload_rate_limit_and_metrics(run_async, tmp_path):
    """The port's upload server paces its threads by one shared token
    bucket (16 KiB/s: the second 16 KiB waits about a second) and
    serves its metric families on ``/metrics``."""
    import time

    async def body():
        up = UploadManager(_fill_stores(lambda: StorageManager(
            StorageOption(data_dir=str(tmp_path / "p"))), TaskStoreMetadata),
            rate_limit=16 << 10)
        port = up.serve("127.0.0.1")
        try:
            t0 = time.monotonic()
            got = await asyncio.gather(*[asyncio.to_thread(
                _get, port, "/download/don/done",
                {"Range": f"bytes={i * 8192}-{i * 8192 + 8191}"})
                for i in range(4)])
            elapsed = time.monotonic() - t0
            metrics = await asyncio.to_thread(_get, port, "/metrics", {})
            return got, elapsed, metrics
        finally:
            up.close()

    got, elapsed, (status, body, _) = run_async(body(), timeout=30)
    assert [g[0] for g in got] == [206] * 4
    assert b"".join(g[1] for g in got) == _UPLOAD[:4 * 8192]
    assert 0.8 < elapsed < 5.0, elapsed
    assert status == 200 and b"upload_bytes_total" in body
    assert b'upload_requests_total{result="ok"}' in body


def test_an_imported_task_is_announced_and_served(run_async, tmp_path):
    """A port daemon imports a local file (no origin); the import is
    announced to the JAX scheduler (``Scheduler.AnnounceTask``), which
    then hands the port daemon to a JAX child as its parent: the child
    gets the file's bytes from the port's upload server, and the origin
    is never asked."""
    src = tmp_path / "src.bin"
    src.write_bytes(CONTENT)

    async def body():
        origin, oport, stats = await start_origin()
        sched = await start_scheduler()
        sched.config.seed_peer_enabled = False
        url = f"http://127.0.0.1:{oport}/blob"
        parent = jchild = None
        try:
            parent = await PortPeer(tmp_path, "parent", sched.port()).start()
            req = FileTaskRequest(url=url, output="",
                                  meta=UrlMeta(digest=SHA))
            imported = await parent.task_manager.import_task(str(src), req)
            jcli = JClient(JNetAddr.tcp("127.0.0.1", sched.port()))
            stat = await jcli.call("Scheduler.StatTask",
                                   {"task_id": imported["task_id"]})
            await jcli.close()
            served = UPLOAD_BYTES.value()
            jchild = await start_daemon(tmp_path, "jchild", sched.port())
            jr = await dfget_via(jchild, url, str(tmp_path / "j.bin"))
            return stat, jr, dict(stats), UPLOAD_BYTES.value() - served
        finally:
            await _stop(jchild, parent)
            await sched.stop()
            await origin.cleanup()

    stat, jr, stats, served = run_async(body(), timeout=120)
    assert stat["content_length"] == len(CONTENT)
    assert jr["state"] == "done" and jr["from_p2p"], jr
    assert (tmp_path / "j.bin").read_bytes() == CONTENT
    assert stats["blob_streams"] == 0 and served == len(CONTENT)


# --------------------------------------------------------------------- #
# Packed reports and the pod rollup at the JAX scheduler; PEX pulls with
# no scheduler, both ways
# --------------------------------------------------------------------- #

def test_a_port_child_negotiates_packed_reports_with_the_jax_scheduler(
        run_async, tmp_path, monkeypatch):
    """A port child and a JAX child pull from a JAX seed. The JAX
    scheduler's stamped answers say ``packed_reports``, so the port
    child's report batches go packed (its flush window widened, so that a
    batch forms); the scheduler records the same finished pieces for both
    children and its pod rollup (``PodAggregator``) the same piece count
    and phase keys for each child's host; each child's terminal message
    carries its flight digest, which the scheduler's pod lens merges:
    ``Daemon.PodTimeline`` on the port daemon answers as on the JAX one."""
    sent = []
    real = PeerTaskConductor._safe_send

    async def spy(self, msg):
        sent.append(msg)
        return await real(self, msg)

    monkeypatch.setattr(PeerTaskConductor, "_safe_send", spy)
    monkeypatch.setattr(PeerTaskConductor, "_REPORT_FLUSH_S", 1.0)

    async def body():
        origin, oport, stats = await start_origin()
        sched = await start_scheduler()
        url = f"http://127.0.0.1:{oport}/blob"
        seed = jchild = child = None
        try:
            seed = await start_daemon(tmp_path, "seed", sched.port(),
                                      seed=True)
            r = await dfget_via(seed, url, str(tmp_path / "s.bin"))
            assert r["state"] == "done", r
            jchild = await start_daemon(tmp_path, "jchild", sched.port())
            jr = await dfget_via(jchild, url, str(tmp_path / "j.bin"))
            child = await PortPeer(tmp_path, "child", sched.port()).start()
            pr = await child.get(url, str(tmp_path / "p.bin"))
            svc = sched.service
            task = svc.tasks.load(pr.task_id)
            for _ in range(200):   # the terminal messages are read after
                if all(p.fsm.current in ("Succeeded", "succeeded")
                       for p in task.peers()
                       if p.host.hostname in ("child", "jchild")):
                    break
                await asyncio.sleep(0.02)
            pieces = {p.host.hostname: set(p.finished_pieces)
                      for p in task.peers()}
            hosts = {p.host.hostname: p.host.id for p in task.peers()}
            rollup = svc.pod_flight.report(pr.task_id)
            # Daemon.PodTimeline: each daemon proxies the scheduler's merged
            # timeline (the digests both children shipped). The clock
            # estimator ages its bounds with the scheduler's clock: one
            # instant for both reads, so the two answers are comparable.
            frozen = svc.pod_lens.clock._clock()
            svc.pod_lens.clock._clock = lambda: frozen
            body_ = {"task_id": pr.task_id}
            timelines = (await jchild.rpc._pod_timeline(body_, None),
                         await child.rpc._pod_timeline(body_, None))
            return jr, pr, pieces, hosts, rollup, timelines
        finally:
            await _stop(child, jchild, seed)
            await sched.stop()
            await origin.cleanup()

    jr, pr, pieces, hosts, rollup, timelines = run_async(body(), timeout=120)
    assert jr["state"] == pr.state == "done" and pr.from_p2p
    assert timelines[1] == timelines[0]
    assert hosts["child"] in str(timelines[1]["report"])
    n = compute_piece_count(len(CONTENT), 4 * MB)
    assert pieces["child"] == pieces["jchild"] == set(range(n))
    by_host = {h["host"]: h for h in rollup["hosts"]}
    port_row, jax_row = by_host[hosts["child"]], by_host[hosts["jchild"]]
    assert port_row["pieces"] == jax_row["pieces"] == n
    assert set(port_row["ms"]) == set(jax_row["ms"])
    assert port_row["failures"] == jax_row["failures"] == {}
    batches = [m for m in sent if m["type"] == "pieces_finished"]
    assert batches and all("packed" in m and "pieces" not in m
                           for m in batches)
    reported = [m["piece"] for m in sent if m["type"] == "piece_finished"]
    for m in batches:
        reported += pdecode(m["packed"]).to_dicts()
    assert sorted(r["piece_num"] for r in reported) == list(range(n))
    assert all("timings" in r for r in reported)
    (done,) = [m for m in sent if m["type"] == "download_finished"]
    assert done["flight"]["task_id"] == pr.task_id
    assert {row[0] for row in done["flight"]["pieces"]} == set(range(n))


async def _port_pex_daemon(root, name: str, seeds: list[str], *,
                           sinks=None):
    """A port daemon with no scheduler and PEX: storage, a piece manager,
    the task manager with a ``PeerExchange``, the upload server and the
    peer drpc server the holders' children sync against."""
    storage = StorageManager(StorageOption(data_dir=str(root / name)))
    tm = TaskManager(storage, PieceManager(PieceManagerOption(
        concurrency=1, concurrent_min_length=1 << 40)), device_sinks=sinks)
    upload = UploadManager(storage)
    upload_port = upload.serve("127.0.0.1")
    rpc = DaemonRpcServer(tm, device="cpu")
    await rpc.serve_peer(NetAddr.tcp("127.0.0.1", 0))
    tm.pex = PPeerExchange(ip="127.0.0.1", peer_port=rpc.peer_server.port(),
                           upload_port=upload_port, gossip_interval=0.1,
                           secret="pod")
    await tm.pex.start(0, seeds)

    async def stop():
        await tm.pex.stop()
        await rpc.close()
        upload.close()
        storage.close()
    return types.SimpleNamespace(tm=tm, storage=storage, stop=stop)


def _jax_pex_daemon(tmp_path, name: str, seeds: list[str]) -> Daemon:
    cfg = daemon_config(tmp_path, name, scheduler_port=0)
    cfg.scheduler.addrs = []          # no scheduler: PEX alone
    cfg.pex.enabled = True
    cfg.pex.seeds = seeds
    cfg.pex.secret = "pod"
    cfg.tpu_sink.enabled = False
    return Daemon(cfg)


async def _until(predicate, timeout: float = 10.0) -> bool:
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while loop.time() < end and not predicate():
        await asyncio.sleep(0.05)
    return predicate()


@pytest.mark.parametrize("holder", ["jax", "port"])
def test_a_pex_pull_with_no_scheduler_crosses_packages(run_async, tmp_path,
                                                       holder):
    """A holder of one package fetches the content from the origin and
    gossips it; a daemon of the other package, with no scheduler and
    ``disable_back_source``, finds it over PEX and pulls every piece from
    it, landed in the port's device sink on the CPU (``device="tpu"``
    requests, the sink of the JAX daemon the port's). The bytes, the
    store's piece records and the landed sink are the content's, the
    origin is fetched once, and the child then gossips the task itself."""
    async def body():
        origin, oport, stats = await start_origin()
        url = f"http://127.0.0.1:{oport}/blob"
        jd = pd = None
        sinks = DeviceSinkManager(device="cpu", batch_pieces=2)
        try:
            if holder == "jax":
                jd = _jax_pex_daemon(tmp_path, "jholder", [])
                await jd.start()
                jd.pex.gossip_interval = 0.1
                req = JRequest(url=url, output="", meta=JMeta(digest=SHA))
                async for _ in jd.task_manager.start_file_task(req):
                    pass
                pd = await _port_pex_daemon(
                    tmp_path, "pchild", [f"127.0.0.1:{jd.pex.port}"],
                    sinks=sinks)
                child_tm, child_pex, holder_pex = pd.tm, pd.tm.pex, jd.pex
                child_req = FileTaskRequest(
                    url=url, output=str(tmp_path / "out.bin"),
                    meta=UrlMeta(digest=SHA), disable_back_source=True,
                    device="tpu")
            else:
                pd = await _port_pex_daemon(tmp_path, "pholder", [])
                req = FileTaskRequest(url=url, output="",
                                      meta=UrlMeta(digest=SHA))
                async for _ in pd.tm.start_file_task(req):
                    pass
                jd = _jax_pex_daemon(tmp_path, "jchild",
                                     [f"127.0.0.1:{pd.tm.pex.port}"])
                jd.task_manager.device_sinks = sinks
                await jd.start()
                jd.pex.gossip_interval = 0.1
                child_tm, child_pex, holder_pex = jd.task_manager, jd.pex, \
                    pd.tm.pex
                child_req = JRequest(
                    url=url, output=str(tmp_path / "out.bin"),
                    meta=JMeta(digest=SHA), disable_back_source=True,
                    device="tpu")
            task_id = req.task_id()
            streams = dict(stats)
            assert await _until(lambda: child_pex.find_holders(task_id))
            last = [p async for p in child_tm.start_file_task(child_req)][-1]
            sink = sinks.get(task_id)
            landed = bytes(sink.as_bytes_array().numpy()) if sink else b""
            gossiped = await _until(lambda: any(
                m.node_id == child_pex.node_id
                for m in holder_pex.find_holders(task_id)))
            return (last, stats == streams, landed, gossiped,
                    _records(child_tm.storage.tasks()))
        finally:
            sinks.close()
            if pd is not None:
                await pd.stop()
            if jd is not None:
                await jd.stop()
            await origin.cleanup()

    last, no_origin, landed, gossiped, records = run_async(body(),
                                                           timeout=120)
    state = last["state"] if isinstance(last, dict) else last.state
    wire = last if isinstance(last, dict) else last.to_wire()
    assert state == "done" and wire["from_p2p"] and wire["device_verified"]
    assert (tmp_path / "out.bin").read_bytes() == CONTENT
    assert no_origin and gossiped
    assert landed == CONTENT
    assert records == _crc32c_records(CONTENT, 4 * MB)
