"""The port's content-defined chunking against the JAX package's.

The gear table, K3's plain version ``gear_candidates_torch`` against the
JAX scans ``_scan_python`` and ``_scan_numpy``, ``GearChunker`` /
``chunk_bytes`` against the JAX chunker (which picks its own scan backend
here; ``tests/test_chunker_oracle.py`` pins that every backend agrees)
under arbitrary ``feed`` splits, ``build_manifest`` and
``manifest_from_store`` against the JAX functions byte for byte, and
``publish_manifest_for`` / ``fetch_manifest`` on a reference task manager.
Inputs are bytes made from a seed; everything runs on the CPU
(``device="cpu"``), where a wrapper takes K3's plain version. Tolerance
0: positions, chunks, digests and JSON bytes are compared for equality.
"""

from __future__ import annotations

import os
import random
import re

import numpy as np
import pytest
import torch

from dragonfly2_tpu.delta import chunker as jchk
from dragonfly2_tpu.delta import manifest as jman
from dragonfly2_tpu.delta import resolver as jres
from dragonfly2_tpu.storage.local_store import LocalTaskStore, TaskStoreMetadata
from dragonfly2_tpu_torch import delta as pdelta
from dragonfly2_tpu_torch.delta import chunker as pchk
from dragonfly2_tpu_torch.delta import manifest as pman
from dragonfly2_tpu_torch.delta import resolver as pres
from dragonfly2_tpu_torch.ops import gear

MASK_BITS = (1, 4, 10, 20, 31)

# (name, JAX params): the oracle's small geometry, its forced-max-cut
# geometry, the delta tests' two, and the default.
PARAMS = {
    "oracle": jchk.CDCParams(mask_bits=10, min_size=2 << 10, max_size=16 << 10),
    "forced-max": jchk.CDCParams(mask_bits=20, min_size=1 << 10,
                                 max_size=8 << 10),
    "delta": jchk.CDCParams(mask_bits=14, min_size=4 << 10, max_size=64 << 10),
    "torch-delta": jchk.CDCParams(mask_bits=12, min_size=2 << 10,
                                  max_size=32 << 10),
    "default": jchk.CDCParams(),
}

CONTENT = {
    "random": lambda: random.Random(3).randbytes(256 << 10),
    "zeros": lambda: bytes(96 << 10),
    "periodic": lambda: random.Random(5).randbytes(1 << 10) * 100,
    "short-tail": lambda: random.Random(7).randbytes((64 << 10) + 300),
    "tiny": lambda: random.Random(9).randbytes(31),
    "empty": lambda: b"",
}


def _pparams(p: jchk.CDCParams) -> pchk.CDCParams:
    return pchk.CDCParams(p.mask_bits, p.min_size, p.max_size)


def _triples(chunks) -> list[tuple[int, int, str]]:
    return [(c.offset, c.length, c.sha256) for c in chunks]


def _region(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


# ------------------------------------------------------------------ #
# The gear table and the scan
# ------------------------------------------------------------------ #

def test_gear_table_is_the_jax_table():
    assert gear.GEAR_LIST == jchk._GEAR_LIST
    assert gear.WINDOW == jchk.WINDOW == pchk.WINDOW == 32
    assert [int(v) for v in gear._GEAR64] == jchk._GEAR_LIST
    assert np.array_equal(gear._table(torch.device("cpu")).numpy()
                          .view(np.uint32), jchk._GEAR)


@pytest.mark.parametrize("mask_bits", MASK_BITS)
def test_plain_scan_equals_the_jax_scans_at_every_ctx(mask_bits):
    """Every ctx in 0..31 against the per-byte Python scan over 8 KiB,
    and against the numpy scan over 256 KiB + 3 bytes."""
    small = random.Random(mask_bits).randbytes(8 << 10)
    big = random.Random(100 + mask_bits).randbytes((256 << 10) + 3)
    t_small, t_big = _region(small), _region(big)
    for ctx in range(32):
        want = jchk._scan_python(small, ctx, mask_bits)
        assert gear.gear_candidates_torch(t_small, ctx, mask_bits).tolist() \
            == want, ctx
        assert gear.gear_candidates(t_small, ctx, mask_bits).tolist() == want
        assert gear.gear_candidates_torch(t_big, ctx, mask_bits).tolist() \
            == jchk._scan_numpy(big, ctx, mask_bits), ctx


@pytest.mark.parametrize("length", [1, 2, 15, 16, 31, 32, 33, 100])
def test_plain_scan_short_regions(length):
    data = random.Random(length).randbytes(length)
    for ctx in range(min(31, length) + 1):
        for mask_bits in (1, 2, 4):
            assert gear.gear_candidates_torch(
                _region(data), ctx, mask_bits).tolist() == \
                jchk._scan_python(data, ctx, mask_bits)


def test_plain_scan_blocks_do_not_move_candidates(monkeypatch):
    """The plain version's own blocking (each block with 31 bytes of
    left context) gives the one-pass positions."""
    data = random.Random(21).randbytes(60_001)
    for block in (1, 31, 32, 33, 4096):
        part = data[:700] if block == 1 else data
        monkeypatch.setattr(gear, "_PLAIN_BLOCK", block)
        assert gear.gear_candidates_torch(_region(part), 7, 6).tolist() == \
            jchk._scan_numpy(part, 7, 6), block


def _kernel_geometries() -> list[tuple[int, int]]:
    """K3's (tile, run) in bytes for its long and its short run, from
    ``csrc/gear.cu``'s constants (a lane's run is that many 16-byte
    words, a warp's tile 32 runs; on the card ``gear.geometry(n)`` reports
    the one a region of n bytes takes)."""
    src = os.path.join(os.path.dirname(gear.__file__), os.pardir, "csrc",
                       "gear.cu")
    with open(src) as f:
        text = f.read()
    out = []
    for name in ("kLongRunWords", "kShortRunWords"):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        assert found, f"{name} not found in csrc/gear.cu"
        run = 16 * int(found.group(1))
        out.append((32 * run, run))
    return out


GEOMETRIES = _kernel_geometries()
# K3's edges for each run: a tile and a run less one byte, exact, and one
# byte over; a tile and its 31 bytes of window; three tiles and a few bytes.
EDGE_SIZES = sorted({x for tile, run in GEOMETRIES
                     for x in (tile - 1, tile, tile + 1, tile + 31,
                               3 * tile + 17, run - 1, run, run + 1)})
LONG_TILE, LONG_RUN = GEOMETRIES[0]


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_plain_scan_at_the_kernels_edges(n):
    """The plain version, which the card holds K3 to, against both JAX
    scans at the sizes around K3's tile and run, at ctx 0 and 31 and at
    sparse and dense masks."""
    data = random.Random(1000 + n).randbytes(n)
    t = _region(data)
    for ctx in (0, min(31, n)):
        for mask_bits in (1, 4, 6, 20):
            got = gear.gear_candidates_torch(t, ctx, mask_bits).tolist()
            assert got == jchk._scan_python(data, ctx, mask_bits), \
                (ctx, mask_bits)
            assert got == jchk._scan_numpy(data, ctx, mask_bits), \
                (ctx, mask_bits)


@pytest.mark.parametrize("start", range(1, 16))
def test_plain_scan_at_starts_inside_a_larger_tensor(start):
    """Regions that start 1-15 bytes into a larger tensor (a view with a
    storage offset, as the card's regions start off a 16-byte boundary),
    at the tile-edge sizes, against both JAX scans."""
    base = random.Random(start).randbytes(3 * LONG_TILE + 64)
    t = _region(base)
    for n in sorted({x for tile, run in GEOMETRIES
                     for x in (tile + 31, 3 * tile + 17, run + 1)}):
        region = t[start:start + n]
        data = base[start:start + n]
        for ctx, mask_bits in ((0, 6), (31, 4)):
            got = gear.gear_candidates_torch(region, ctx, mask_bits).tolist()
            assert got == jchk._scan_python(data, ctx, mask_bits), \
                (n, ctx, mask_bits)
            assert got == jchk._scan_numpy(data, ctx, mask_bits), \
                (n, ctx, mask_bits)


def test_scan_refuses_what_the_kernel_refuses():
    t = _region(b"x" * 40)
    with pytest.raises(ValueError, match="ctx"):
        gear.gear_candidates(t, 32, 10)
    with pytest.raises(ValueError, match="ctx"):
        gear.gear_candidates(t[:3], 4, 10)
    with pytest.raises(ValueError, match="mask_bits"):
        gear.gear_candidates(t, 0, 0)
    with pytest.raises(ValueError, match="mask_bits"):
        gear.gear_candidates(t, 0, 32)
    with pytest.raises(TypeError, match="uint8"):
        gear.gear_candidates(t.to(torch.int32), 0, 10)
    with pytest.raises(ValueError, match="contiguous"):
        gear.gear_candidates(t[::2], 0, 10)
    with pytest.raises(ValueError, match="no kernel"):
        gear.gear_scan(t, 0, 10, torch.empty(4, dtype=torch.int64),
                       torch.zeros(1, dtype=torch.int64))
    assert gear.gear_candidates(t[:0], 0, 10).tolist() == []
    assert gear.gear_candidates.launches == 0      # the CPU never launches


# ------------------------------------------------------------------ #
# The chunker
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("pname", sorted(PARAMS))
@pytest.mark.parametrize("case", sorted(CONTENT))
def test_chunk_bytes_equals_the_jax_chunker(case, pname):
    data = CONTENT[case]()
    p = PARAMS[pname]
    got = pdelta.chunk_bytes(data, _pparams(p), device="cpu")
    want = jchk.chunk_bytes(data, p)
    assert _triples(got) == _triples(want)
    assert sum(c.length for c in got) == len(data)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("pname", ["oracle", "forced-max", "delta"])
def test_chunker_under_arbitrary_feed_splits(seed, pname, monkeypatch):
    """Random splits (and, over a prefix, byte-at-a-time feeds) give the
    JAX package's one-shot chunks, with scan blocks smaller than a feed so
    blocks carry their left context too."""
    monkeypatch.setattr(pchk.GearChunker, "_SCAN_BLOCK", 5000 + seed)
    data = random.Random(100 + seed).randbytes(128 << 10)
    p = PARAMS[pname]
    want = _triples(jchk.chunk_bytes(data, p))
    rng = random.Random(200 + seed)
    cuts = [0, *sorted(rng.sample(range(1, len(data)), 40)), len(data)]
    ch = pchk.GearChunker(_pparams(p), device="cpu")
    emitted = []
    for a, b in zip(cuts, cuts[1:]):
        emitted += ch.feed(data[a:b])
        assert ch.consumed == b
    emitted += ch.finish()
    assert _triples(emitted) == _triples(ch.chunks) == want
    small = data[:3000]
    ch = pchk.GearChunker(_pparams(PARAMS["oracle"]), device="cpu")
    for i in range(len(small)):
        ch.feed(small[i:i + 1])
    ch.finish()
    assert _triples(ch.chunks) == _triples(
        jchk.chunk_bytes(small, PARAMS["oracle"]))


def test_chunker_contract():
    ch = pchk.GearChunker(device="cpu")
    assert ch.params == pchk.CDCParams() and ch.device == torch.device("cpu")
    assert ch.feed(b"") == [] and ch.finish() == [] and ch.chunks == []
    with pytest.raises(RuntimeError, match="finish"):
        ch.feed(b"x")
    with pytest.raises(ValueError, match="mask_bits"):
        pchk.CDCParams(mask_bits=32)
    assert pman.CDCParams is pchk.CDCParams and pman.Chunk is pchk.Chunk


# ------------------------------------------------------------------ #
# Manifests
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("pname", ["oracle", "delta", "default"])
def test_build_manifest_json_equals_the_jax_bytes(pname):
    data = random.Random(31).randbytes((3 << 20) + 17)
    p = PARAMS[pname]
    got = pman.build_manifest(data, "v1", _pparams(p), device="cpu")
    want = jman.build_manifest(data, "v1", p)
    assert got.to_json_bytes() == want.to_json_bytes()
    assert got.num_chunks > 1


def _landed(tmp_path, name: str, content: bytes, piece: int = 64 << 10):
    store = LocalTaskStore(str(tmp_path / name), TaskStoreMetadata(
        task_id=f"task-{name}", url=f"http://origin/{name}",
        content_length=len(content), piece_size=piece,
        total_piece_count=-(-len(content) // piece)))
    for i in range(store.metadata.total_piece_count):
        store.write_piece(i, content[i * piece:(i + 1) * piece])
    return store


@pytest.mark.parametrize("span", [8 << 20, 65536, 12345])
def test_manifest_from_store_equals_the_jax_bytes(tmp_path, span):
    content = random.Random(41).randbytes((1 << 20) + 999)
    store = _landed(tmp_path, "s", content)
    p = PARAMS["delta"]
    stats = {}
    got = pman.manifest_from_store(store, params=_pparams(p), span=span,
                                   device="cpu", stats=stats)
    want = jman.manifest_from_store(store, params=p, span=span)
    assert got.name == want.name == "http://origin/s"
    assert got.to_json_bytes() == want.to_json_bytes()
    assert stats["feeds"] == -(-len(content) // span)
    assert set(stats) == {"read_s", "feeds", "stage_s", "scan_s", "hash_s"}
    assert pman.manifest_object_key("a/b.bin") == jman.manifest_object_key(
        "a/b.bin") == ".dfdelta/a/b.bin.json"


# ------------------------------------------------------------------ #
# Fabric-published manifests on a reference task manager
# ------------------------------------------------------------------ #

def _task_manager(tmp_path, name: str):
    from dragonfly2_tpu.daemon.peer.piece_manager import PieceManager
    from dragonfly2_tpu.daemon.peer.task_manager import TaskManager
    from dragonfly2_tpu.storage.manager import StorageManager, StorageOption

    storage = StorageManager(StorageOption(data_dir=str(tmp_path / name)))
    return TaskManager(storage, PieceManager())


async def _import_content(tm, tmp_path, content: bytes) -> str:
    from dragonfly2_tpu.daemon.peer.task_manager import FileTaskRequest

    path = tmp_path / "content.bin"
    path.write_bytes(content)
    req = FileTaskRequest(url="http://origin/ckpt.safetensors", output="")
    return (await tm.import_task(str(path), req))["task_id"]


def _manifest_store_bytes(tm, content_task_id: str) -> tuple[str, bytes]:
    task_id = pres.manifest_request(content_task_id).task_id()
    store = tm.storage.find_completed_task(task_id)
    n = store.metadata.content_length
    buf = bytearray(n)
    with store:
        store.read_into(0, n, buf)
    return task_id, bytes(buf)


def test_publish_manifest_for_imports_the_jax_task(run_async, tmp_path):
    """The port's publish_manifest_for on a reference task manager imports
    the dfdelta:// task of the same id and bytes as the JAX function on
    another, both with built and with prebuilt manifests; a second call
    leaves the task as it is; the manifest fetches back from the fabric."""
    content = random.Random(51).randbytes((2 << 20) + 5)
    p = PARAMS["delta"]

    async def body():
        tm_j = _task_manager(tmp_path, "jax")
        tm_p = _task_manager(tmp_path, "port")
        cid = await _import_content(tm_j, tmp_path, content)
        assert await _import_content(tm_p, tmp_path, content) == cid
        want = await jres.publish_manifest_for(tm_j, cid, params=p)
        got = await pres.publish_manifest_for(tm_p, cid, params=_pparams(p),
                                              device="cpu")
        assert got.to_json_bytes() == want.to_json_bytes()
        assert _manifest_store_bytes(tm_p, cid) == _manifest_store_bytes(
            tm_j, cid)
        assert pres.manifest_request(cid).task_id() == \
            jres._manifest_request(cid).task_id()
        again = await pres.publish_manifest_for(tm_p, cid, manifest=got)
        assert again is got
        assert (await pres.fetch_manifest(tm_p, cid)).to_json_bytes() == \
            want.to_json_bytes()
        assert await pres.publish_manifest_for(tm_p, "0" * 64) is None
        # A prebuilt manifest on a fresh manager: the same task again.
        tm_q = _task_manager(tmp_path, "prebuilt")
        await _import_content(tm_q, tmp_path, content)
        await pres.publish_manifest_for(tm_q, cid, manifest=got)
        assert _manifest_store_bytes(tm_q, cid) == _manifest_store_bytes(
            tm_j, cid)

    run_async(body(), timeout=120)


def test_missing_manifest_is_none_in_both_packages(run_async, tmp_path):
    """No host published a manifest: the reference task manager (back to
    source disabled, no scheduler) fails the dfdelta:// task, and both
    packages' fetch_manifest give None."""
    content = random.Random(61).randbytes(100_000)

    async def body():
        tm = _task_manager(tmp_path, "miss")
        cid = await _import_content(tm, tmp_path, content)
        assert await pres.fetch_manifest(tm, cid, timeout=30) is None
        assert await jres.fetch_manifest(tm, cid, timeout=30) is None
        misses = pman.MANIFEST_FETCHES.value("miss")
        assert await pres.fetch_manifest(tm, "f" * 64, timeout=30) is None
        assert pman.MANIFEST_FETCHES.value("miss") == misses + 1

    run_async(body(), timeout=120)
