"""The port's task store against the JAX package's, on the same bytes.

- The host library's CRC-32C (``csrc/host/dfhost.cc``, both its SSE4.2
  and its table path) against the JAX package's ``digest.crc32c`` and the
  table-driven ``_crc32c_py``, at every length 0-4,097, at unaligned
  starts and chained through ``init``.
- ``LocalTaskStore`` piece writes with and without an expected digest and
  by chunks: the same records, digests and ``data`` bytes; the same
  mismatch errors, text and code.
- The reads (``read_piece``, ``read_into``, ``read_spans_into``,
  ``read_range``), ``validate_digest``, ``reverify_pieces`` after a
  flipped byte, ``store_to`` by hardlink and by copy.
- ``metadata.json`` key for key; ``StorageManager.reload`` over a
  directory the other package wrote, both ways; ``gc`` by TTL and by the
  disk threshold.
- The device sink landing through the port's store on the CPU keeps the
  bytes it was handed while pooled read buffers are recycled around it.
- A missing or failing host compiler raises; nothing falls back.

Inputs are made with numpy from a seed. Tolerance 0: bytes and integers.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest

from dragonfly2_tpu.pkg import digest as jdigest
from dragonfly2_tpu.pkg.errors import StorageError as JStorageError
from dragonfly2_tpu.storage import LocalTaskStore as JStore
from dragonfly2_tpu.storage import StorageManager as JManager
from dragonfly2_tpu.storage import StorageOption as JOption
from dragonfly2_tpu.storage import TaskStoreMetadata as JMeta
from dragonfly2_tpu_torch.daemon.peer.device_sink import DeviceSinkManager
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.pkg import dfhost
from dragonfly2_tpu_torch.pkg import digest as pdigest
from dragonfly2_tpu_torch.pkg.errors import Code, StorageError
from dragonfly2_tpu_torch.storage import LocalTaskStore as PStore
from dragonfly2_tpu_torch.storage import StorageManager as PManager
from dragonfly2_tpu_torch.storage import StorageOption as POption
from dragonfly2_tpu_torch.storage import TaskStoreMetadata as PMeta
from dragonfly2_tpu_torch.storage import io_ring, local_store

PIECE = 1 << 20


def _bytes(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


CORPUS = _bytes(8192 + 64, seed=1)


# -- CRC-32C ---------------------------------------------------------------

@pytest.mark.parametrize("lo", range(0, 4098, 683))
def test_host_crc32c_equals_jax_at_every_length(lo):
    """Lengths lo..lo+682 (together 0-4,097): the host library, both its
    paths, equal the JAX package's crc32c; every 31st length also equals
    the table-driven plain version."""
    for n in range(lo, min(lo + 683, 4098)):
        data = CORPUS[:n]
        want = jdigest.crc32c(data)
        assert dfhost.crc32c(data) == want, n
        assert dfhost.crc32c_table(data) == want, n
        if n % 31 == 0:
            assert pdigest._crc32c_py(data) == want, n


@pytest.mark.parametrize("start", range(16))
def test_host_crc32c_at_unaligned_starts(start):
    mv = memoryview(CORPUS)[start:start + 4097]
    want = jdigest._crc32c_py(bytes(mv))
    assert dfhost.crc32c(mv) == want
    assert dfhost.crc32c_table(mv) == want
    assert dfhost.crc32c(bytearray(mv)) == want


@pytest.mark.parametrize("cut", [0, 1, 7, 8, 9, 1000, 4096])
def test_host_crc32c_chains_through_init(cut):
    data = CORPUS[:5000]
    head = dfhost.crc32c(data[:cut])
    assert dfhost.crc32c(data[cut:], head) == jdigest.crc32c(data)
    assert dfhost.crc32c_table(data[cut:], head) == \
        jdigest._crc32c_py(data[cut:], jdigest._crc32c_py(data[:cut]))


def test_preferred_piece_algorithm_is_the_jax_daemons():
    assert pdigest.preferred_piece_algorithm() == \
        jdigest.preferred_piece_algorithm() == "crc32c"
    assert str(pdigest.hash_bytes("crc32c", CORPUS)) == \
        str(jdigest.hash_bytes("crc32c", CORPUS))


def test_fused_io_calls_equal_separate_ones(tmp_path):
    fd = os.open(tmp_path / "f", os.O_RDWR | os.O_CREAT)
    try:
        data = _bytes(3 * PIECE + 11, seed=2)
        assert dfhost.write_piece_crc(fd, 5, data) == jdigest.crc32c(data)
        crc = dfhost.write_chunk_crc(fd, 5 + len(data), data[:100])
        crc = dfhost.write_chunk_crc(fd, 105 + len(data), data[100:], crc)
        assert crc == jdigest.crc32c(data)
        buf = bytearray(len(data) + 10)
        n, c = dfhost.read_piece_crc_into(fd, 5, buf)
        assert n == len(data) + 10 and bytes(buf[:len(data)]) == data
        assert c == jdigest.crc32c(bytes(buf))
        crcs = dfhost.hash_pieces_crc(fd, [5, 5 + len(data), 5 + PIECE],
                                      [len(data), len(data), 17], threads=2)
        assert crcs == [jdigest.crc32c(data)] * 2 + [
            jdigest.crc32c(data[PIECE:PIECE + 17])]
        with pytest.raises(OSError):
            dfhost.hash_pieces_crc(fd, [10 * PIECE], [PIECE])
    finally:
        os.close(fd)


# -- stores ----------------------------------------------------------------

def _pair(tmp_path, content_length: int, piece_size: int = PIECE):
    """A JAX store and a port store of one task, each in its directory."""
    kw = dict(task_id="t" * 64, url="http://o/x", tag="tg",
              content_length=content_length, piece_size=piece_size,
              total_piece_count=-(-content_length // piece_size))
    j = JStore.create(str(tmp_path / "jax"), JMeta(**kw))
    p = PStore.create(str(tmp_path / "port"), PMeta(**kw))
    return j, p


def _records(store) -> list:
    return [(r.num, r.offset, r.size, r.digest)
            for r in store.get_pieces()]


def _data(store) -> bytes:
    with open(store.data_path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("expected", ["none", "crc32c", "md5", "sha256"])
def test_write_piece_equals_jax(tmp_path, expected):
    content = _bytes(3 * PIECE + 321, seed=3)
    j, p = _pair(tmp_path, len(content))
    for num in (2, 0, 3, 1, 2):        # out of order, one piece rewritten
        piece = content[num * PIECE:(num + 1) * PIECE]
        want = "" if expected == "none" else str(
            jdigest.hash_bytes(expected, piece))
        jr = j.write_piece(num, piece, expected_digest=want)
        pr = p.write_piece(num, memoryview(piece), expected_digest=want)
        assert (pr.num, pr.offset, pr.size, pr.digest) == \
            (jr.num, jr.offset, jr.size, jr.digest)
    assert _records(p) == _records(j)
    assert _data(p) == _data(j) == content
    assert p.is_complete() and j.is_complete()


@pytest.mark.parametrize("algorithm", ["md5", "sha1"])
def test_write_piece_with_another_algorithm_equals_jax(tmp_path, algorithm):
    content = _bytes(PIECE + 5, seed=4)
    j, p = _pair(tmp_path, len(content))
    for num in (0, 1):
        piece = content[num * PIECE:(num + 1) * PIECE]
        assert p.write_piece(num, piece, algorithm=algorithm).digest == \
            j.write_piece(num, piece, algorithm=algorithm).digest
    assert _data(p) == _data(j) == content


@pytest.mark.parametrize("splits", [[1], [7, 100, 4096], [PIECE // 2]])
@pytest.mark.parametrize("mode", ["none", "expected", "digest_str"])
def test_write_piece_chunks_equals_jax(tmp_path, splits, mode):
    content = _bytes(2 * PIECE, seed=5)
    j, p = _pair(tmp_path, len(content))
    for num in (1, 0):
        piece = content[num * PIECE:(num + 1) * PIECE]
        cuts = [0] + [c for c in splits if c < len(piece)] + [len(piece)]
        chunks = [memoryview(piece)[a:b] for a, b in zip(cuts, cuts[1:])]
        crc = str(jdigest.hash_bytes("crc32c", piece))
        kw = {"none": {}, "expected": {"expected_digest": crc},
              "digest_str": {"digest_str": crc}}[mode]
        jr = j.write_piece_chunks(num, chunks, **kw)
        pr = p.write_piece_chunks(num, chunks, **kw)
        assert pr.digest == jr.digest == crc
    assert _records(p) == _records(j)
    assert _data(p) == _data(j) == content


@pytest.mark.parametrize("how", ["piece-new", "piece-recorded", "chunks",
                                 "chunks-digest-str", "chunks-md5"])
def test_digest_mismatch_errors_equal_jax(tmp_path, how):
    content = _bytes(PIECE, seed=6)
    j, p = _pair(tmp_path, len(content))
    bad_crc = "crc32c:" + ("0" * 8 if jdigest.crc32c(content) else "1" * 8)
    errors = []
    for store, exc in ((j, JStorageError), (p, StorageError)):
        if how == "piece-recorded":
            store.write_piece(0, content)
        chunks = [content[:100], content[100:]]
        with pytest.raises(exc) as e:
            if how.startswith("piece"):
                store.write_piece(0, content, expected_digest=bad_crc)
            elif how == "chunks":
                store.write_piece_chunks(0, chunks, expected_digest=bad_crc)
            elif how == "chunks-digest-str":
                store.write_piece_chunks(0, chunks, digest_str="crc32c:" +
                                         "2" * 8, expected_digest=bad_crc)
            else:
                store.write_piece_chunks(0, chunks,
                                         expected_digest="md5:" + "0" * 32)
        errors.append((int(e.value.code), e.value.message))
    assert errors[0] == errors[1]
    assert errors[1][0] == Code.ClientPieceDownloadFail
    assert _records(p) == _records(j)


def _filled_pair(tmp_path, n: int = 3 * PIECE + 777, seed: int = 7):
    content = _bytes(n, seed=seed)
    j, p = _pair(tmp_path, len(content))
    for store in (j, p):
        for num in range(-(-n // PIECE)):
            store.write_piece(num, content[num * PIECE:(num + 1) * PIECE])
    return content, j, p


def test_reads_equal_jax(tmp_path):
    content, j, p = _filled_pair(tmp_path)
    for num in range(4):
        assert p.read_piece(num) == j.read_piece(num) == \
            content[num * PIECE:(num + 1) * PIECE]
        assert isinstance(p.read_piece(num), bytes)
    with pytest.raises(StorageError) as e:
        p.read_piece(9)
    assert e.value.code == Code.StoragePieceNotFound
    for off, n, at in ((0, 10, 0), (PIECE - 3, 9, 5), (100, 3 * PIECE, 1)):
        a, b = bytearray(n + at), bytearray(n + at)
        p.read_into(off, n, a, at=at)
        j.read_into(off, n, b, at=at)
        assert a == b and bytes(a[at:]) == content[off:off + n]
    spans = [(5, 17), (2 * PIECE - 1, PIECE + 2), (0, 0), (3 * PIECE, 700)]
    a, b = bytearray(2 * PIECE), bytearray(2 * PIECE)
    assert p.read_spans_into(spans, a) == j.read_spans_into(spans, b)
    assert a == b
    want = b"".join(content[o:o + n] for o, n in spans)
    assert bytes(a[:len(want)]) == want
    mv = p.read_range(PIECE - 10, PIECE + 20)
    assert bytes(mv) == bytes(j.read_range(PIECE - 10, PIECE + 20)) == \
        content[PIECE - 10:2 * PIECE + 10]
    local_store.release_read_buffer(mv)
    for store, exc in ((p, StorageError), (j, JStorageError)):
        with pytest.raises(exc, match="short read"):
            store.read_spans_into([(0, 4), (len(content) - 2, 8)],
                                  bytearray(12))
        with pytest.raises(exc, match="short read"):
            store.read_into(len(content) - 2, 8, bytearray(8))


def test_the_ring_reads_spans_on_df_threads(tmp_path):
    content, _, p = _filled_pair(tmp_path)
    assert io_ring.ring_backend() == "threads"
    before = io_ring.RING_SPANS.value("read")
    buf = bytearray(4 * 700)
    p.read_spans_into([(i * PIECE, 700) for i in range(4)], buf)
    assert bytes(buf) == b"".join(content[i * PIECE:i * PIECE + 700]
                                  for i in range(4))
    assert io_ring.RING_SPANS.value("read") == before + 4


def test_validate_and_reverify_equal_jax(tmp_path):
    content, j, p = _filled_pair(tmp_path)
    import hashlib

    want = "sha256:" + hashlib.sha256(content).hexdigest()
    assert p.validate_digest(want) == j.validate_digest(want) == want
    assert p.validate_digest() == j.validate_digest()
    wrong = "sha256:" + "0" * 64
    errors = []
    for store, exc in ((j, JStorageError), (p, StorageError)):
        with pytest.raises(exc) as e:
            store.validate_digest(wrong)
        errors.append((int(e.value.code), e.value.message))
    assert errors[0] == errors[1]
    assert p.reverify_pieces() == j.reverify_pieces() == []
    for store in (j, p):          # one flipped byte in piece 2
        with open(store.data_path, "r+b") as f:
            f.seek(2 * PIECE + 5)
            b = f.read(1)
            f.seek(2 * PIECE + 5)
            f.write(bytes([b[0] ^ 1]))
    assert p.reverify_pieces(threads=2) == j.reverify_pieces() == [2]
    for store in (j, p):          # truncated: the one-by-one path
        os.truncate(store.data_path, PIECE + 10)
    assert p.reverify_pieces() == j.reverify_pieces() == [1, 2, 3]


@pytest.mark.parametrize("hardlink", [True, False])
def test_store_to_equals_jax(tmp_path, hardlink):
    content, j, p = _filled_pair(tmp_path)
    for store, name in ((j, "j.out"), (p, "p.out")):
        store.store_to(str(tmp_path / "out" / name), hardlink=hardlink)
        out = tmp_path / "out" / name
        assert out.read_bytes() == content
        linked = os.stat(out).st_ino == os.stat(store.data_path).st_ino
        assert linked == hardlink
    j2, p2 = _pair(tmp_path / "incomplete", 2 * PIECE)
    with pytest.raises(StorageError, match="incomplete"):
        p2.store_to(str(tmp_path / "never"))


def _meta_json(store) -> dict:
    with open(os.path.join(store.dir, "metadata.json")) as f:
        return json.load(f)


def test_metadata_json_equals_jax_key_for_key(tmp_path):
    content, j, p = _filled_pair(tmp_path)
    for store in (j, p):
        store.update_task(digest="sha256:" + "a" * 64, header={"X-A": "1"})
        store.mark_done()
    jm, pm = _meta_json(j), _meta_json(p)
    assert list(pm) == list(jm)
    for key in ("created_at", "last_access"):
        assert isinstance(pm.pop(key), float)
        jm.pop(key)
    assert pm == jm
    assert sorted(os.listdir(p.dir)) == sorted(os.listdir(j.dir)) == \
        ["data", "metadata.json"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reload_reads_the_other_packages_directory(tmp_path, writer):
    content = _bytes(2 * PIECE + 3, seed=8)
    W, R = ((JManager, JOption, JMeta), (PManager, POption, PMeta))
    if writer == "port":
        W, R = R, W
    wm = W[0](W[1](data_dir=str(tmp_path)))
    ids = []
    for k, done in enumerate((True, False)):
        tid = f"{k:02d}" + "b" * 62
        s = wm.register_task(W[2](task_id=tid, url="http://o/x"))
        s.update_task(content_length=len(content), piece_size=PIECE,
                      total_piece_count=3)
        for num in range(3 if done else 1):
            s.write_piece(num, content[num * PIECE:(num + 1) * PIECE])
        if done:
            s.mark_done()
        else:
            s.save_metadata()
        ids.append(tid)
    bad = wm.register_task(W[2](task_id="ff" + "c" * 62))
    bad.mark_invalid()
    rm = R[0](R[1](data_dir=str(tmp_path)))
    assert rm.reload() == 2
    assert rm.try_get("ff" + "c" * 62) is None
    done_store = rm.find_completed_task(ids[0])
    assert done_store is not None and done_store.is_complete()
    assert done_store.read_piece(2) == content[2 * PIECE:]
    assert done_store.validate_digest() == wm.get(ids[0]).validate_digest()
    assert rm.find_completed_task(ids[1]) is None
    partial = rm.find_partial_completed_task(ids[1])
    assert sorted(partial.metadata.pieces) == [0]
    assert _records(partial) == _records(wm.get(ids[1]))


def _aged_manager(Manager, Option, Meta, root, **opt):
    m = Manager(Option(data_dir=str(root), **opt))
    for k in range(4):
        s = m.register_task(Meta(task_id=f"{k:02d}" + "d" * 62,
                                 piece_size=PIECE, content_length=PIECE))
        s.write_piece(0, _bytes(PIECE, seed=20 + k))
        s.metadata.last_access = time.time() - 100 * (4 - k)
    return m


@pytest.mark.parametrize("kind", ["ttl", "disk"])
def test_gc_reclaims_what_jax_reclaims(tmp_path, kind):
    opt = ({"task_ttl": 250.0} if kind == "ttl"
           else {"disk_gc_threshold": 2 * PIECE + 1})
    got = []
    for cls, root in (((JManager, JOption, JMeta), "jax"),
                      ((PManager, POption, PMeta), "port")):
        m = _aged_manager(*cls, tmp_path / root, **opt)
        m.get("03" + "d" * 62).pin()       # a pinned store is never taken
        m.get("00" + "d" * 62).pin()
        got.append((sorted(m.gc()), sorted(s.metadata.task_id
                                           for s in m.tasks())))
    assert got[0] == got[1]
    assert got[1][0]               # something was reclaimed


def test_landing_keeps_its_bytes_while_pooled_buffers_recycle(tmp_path):
    """The device sink keeps what ``read_piece`` returns until its batch
    flushes; pooled read buffers recycled and overwritten meanwhile must
    not reach it."""
    content, _, p = _filled_pair(tmp_path, n=5 * PIECE + 99, seed=9)
    mgr = DeviceSinkManager(device="cpu", batch_pieces=4)
    import asyncio

    async def land():
        for rec in p.get_pieces():
            await mgr.on_piece("t" * 64, p, rec)
            mv = p.read_range(0, PIECE)          # a pooled buffer...
            mv[:] = b"\xee" * PIECE              # ...scribbled on
            local_store.release_read_buffer(mv)  # ...and recycled
        return await mgr.finalize("t" * 64, p)

    try:
        sink = asyncio.run(land())
        assert sink is not None and sink.verified
        assert sink.as_bytes_array().numpy().tobytes() == content
    finally:
        mgr.close()


def test_the_sink_manager_counts_its_worker_busy_seconds(tmp_path):
    """``busy_s`` grows with every landing and finalize the worker runs,
    and with nothing else."""
    content, _, p = _filled_pair(tmp_path, n=3 * PIECE + 5, seed=11)
    mgr = DeviceSinkManager(device="cpu", batch_pieces=2)
    import asyncio

    async def land():
        seen = [mgr.busy_s]
        for rec in p.get_pieces():
            await mgr.on_piece("b" * 64, p, rec)
            seen.append(mgr.busy_s)
        await asyncio.sleep(0)
        seen.append(mgr.busy_s)
        sink = await mgr.finalize("b" * 64, p)
        seen.append(mgr.busy_s)
        return sink, seen

    try:
        sink, seen = asyncio.run(land())
        assert sink is not None and sink.verified
        assert seen[0] == 0.0
        steps = [b - a for a, b in zip(seen, seen[1:])]
        assert all(d > 0 for d in steps[:-2] + steps[-1:])
        assert steps[-2] == 0.0          # no worker call between them
    finally:
        mgr.close()


def test_missing_host_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "library_path",
                        lambda source: str(tmp_path / "absent.so"))
    monkeypatch.setattr(_build, "cxx_path", lambda: None)
    with pytest.raises(_build.HostBuildError, match="g\\+\\+ not found"):
        dfhost.crc32c(b"x")
    assert issubclass(_build.HostBuildError, _build.KernelError)


def test_failed_host_compile_raises_with_its_output(monkeypatch, tmp_path):
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'dfhost.cc:1: error: boom' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "library_path",
                        lambda source: str(tmp_path / "build" / "h.so"))
    monkeypatch.setattr(_build, "cxx_path", lambda: str(fake))
    with pytest.raises(_build.HostBuildError, match="boom") as e:
        dfhost.crc32c(b"x")
    assert "exit 3" in str(e.value)
    assert os.listdir(tmp_path / "build") == []


def test_host_library_name_follows_source_and_flags():
    path = _build.library_path(_build.HOST_SOURCE)
    assert os.path.basename(path).startswith("dfhost-")
    assert path != _build.library_path(_build.SOURCE)
    assert path == _build.library_path(_build.HOST_SOURCE)


# -- the support modules the path runs on ----------------------------------

@pytest.mark.parametrize("num,size,length", [
    (0, PIECE, -1), (0, PIECE, 5), (2, PIECE, 3 * PIECE - 1),
    (3, PIECE, 3 * PIECE), (7, 4 << 20, 30 << 20)])
def test_piece_math_and_records_equal_jax(num, size, length):
    from dragonfly2_tpu.pkg import piece as jpiece
    from dragonfly2_tpu_torch.pkg import piece as ppiece

    assert ppiece.piece_length(num, size, length) == \
        jpiece.piece_length(num, size, length)
    wire = {"piece_num": num, "range_start": num * size, "range_size": size,
            "digest": "crc32c:0000abcd", "download_cost_ms": 3,
            "dst_peer_id": "p"}
    assert ppiece.PieceInfo.from_wire(wire).to_wire() == \
        jpiece.PieceInfo.from_wire(wire).to_wire() == wire


def test_errors_and_ids_equal_jax():
    from dragonfly2_tpu.pkg import errors as jerr
    from dragonfly2_tpu.pkg import idgen as jid
    from dragonfly2_tpu_torch.pkg import errors as perr
    from dragonfly2_tpu_torch.pkg import idgen as pid

    for exc in (TimeoutError(), ValueError("boom")):
        assert perr.describe(exc) == jerr.describe(exc)
    for temporary in (False, True):
        j = jerr.SourceError("x", jerr.Code.SourceNotFound, temporary)
        p = perr.SourceError("x", perr.Code.SourceNotFound, temporary)
        assert p.to_wire() == j.to_wire() and p.temporary == temporary
    assert perr.StorageError("y").to_wire() == jerr.StorageError("y").to_wire()
    assert perr.StorageError("y", perr.Code.StoragePieceNotFound).code == \
        jerr.StorageError("y", jerr.Code.StoragePieceNotFound).code
    p, j = pid.peer_id_v1("10.0.0.1"), jid.peer_id_v1("10.0.0.1")
    assert p.split("-")[:2] == j.split("-")[:2] and len(p) == len(j)


def test_retry_policy_and_limiter_equal_jax(run_async):
    from dragonfly2_tpu.pkg import ratelimit as jrl
    from dragonfly2_tpu.pkg import retry as jretry
    from dragonfly2_tpu_torch.pkg import ratelimit as prl
    from dragonfly2_tpu_torch.pkg import retry as pretry

    for name in ("RECONNECT", "ANNOUNCE", "SOURCE"):
        jp, pp = getattr(jretry, name), getattr(pretry, name)
        assert [pp.raw_delay(a) for a in range(-1, 9)] == \
            [jp.raw_delay(a) for a in range(-1, 9)]
        assert pp.delay(3, lambda: 0.25) == jp.delay(3, lambda: 0.25)

    async def attempts(mod, retryable):
        calls = []

        async def fn():
            calls.append(1)
            raise ValueError("no")

        with pytest.raises(ValueError):
            await mod.run(fn, policy=mod.BackoffPolicy(base=0, cap=0),
                          max_attempts=4, retryable=retryable)
        return len(calls)

    async def body():
        for retryable in (None, lambda e: False):
            assert await attempts(pretry, retryable) == \
                await attempts(jretry, retryable)
        for mod in (prl, jrl):
            lim = mod.Limiter(1000.0, burst=100)
            assert lim.allow(100) and not lim.allow(50)
            lim.set_limit(mod.INF)
            assert await lim.wait(1 << 40) == 0.0

    run_async(body())


def test_traffic_shaper_and_broker_equal_jax(run_async):
    from dragonfly2_tpu.daemon.peer import broker as jb
    from dragonfly2_tpu.daemon.peer import traffic_shaper as jts
    from dragonfly2_tpu_torch.daemon.peer import broker as pb
    from dragonfly2_tpu_torch.daemon.peer import traffic_shaper as pts

    got = []
    for mod in (jts, pts):
        sh = mod.TrafficShaper(1000.0, algorithm="sampling")
        a, b = sh.start_task("a"), sh.start_task("b")
        a.window_bytes, b.window_bytes = 300, 100
        sh.reallocate()
        limits = [a.limit, b.limit]
        sh.finish_task("a")
        got.append(limits + [b.limit,
                             mod.TrafficShaper(5.0).start_task("x").limit])
    assert got[1] == got[0]

    async def body():
        seen = []
        for mod in (jb, pb):
            br = mod.PieceBroker()
            br.publish("t", mod.PieceEvent([0]))     # nobody listens yet
            q = br.subscribe("t")
            br.publish("t", mod.PieceEvent([1], digests={1: "d"}))
            br.publish("t", mod.PieceEvent([], done=True))
            seen.append(([q.get_nowait().piece_nums, q.get_nowait().done],
                         br.is_done("t")))
            br.unsubscribe("t", q)
            assert not br.is_done("t")
        assert seen[1] == seen[0]

    run_async(body())
