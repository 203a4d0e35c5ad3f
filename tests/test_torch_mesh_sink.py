"""The slice as a whole: landed sinks spread over a mesh, against JAX.

One 4-rank gloo world (``tests/test_torch_parallel.py``'s ``spawn_world``,
ranks importing no JAX) lands the same seeded safetensors content (8 KiB
+ 100 bytes in 1 KiB pieces, so the last piece is padded) into a CPU
``TaskDeviceSink`` on every rank, verifies it, and runs
``shard_to_mesh``, ``ring_replicate``, ``ici_broadcast`` (refused on an
unverified sink) and ``load_from_sink(shardings=...)`` on a ``("dp",
"tp")`` 2 x 2 mesh. Each rank's local data is held bit for bit against
the JAX sink's and ``load_from_sink``'s shard for the same device.

In the test process: ``download_global``'s planner (``plan_global``, a
pure function) against the JAX package's ``download_global`` on 4-device
and 2 x 2 meshes, and one world-of-one pull through a reference daemon
of ``download_global``, ``download_sharded(shardings=...)``,
``download_to_device(mesh=...)`` and ``load_safetensors(shardings=...)``
against the JAX client, plus ``swap_generation(shardings=...)``.
"""

from __future__ import annotations

import json
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SEED = 4
PIECE = 1024
CONTENT_BYTES = 8 * 1024 + 100

# name -> (safetensors dtype, numpy dtype, shape, PartitionSpec tuple on
# the ("dp", "tp") mesh)
TENSORS = {
    "model.embed": ("F32", np.float32, (16, 32), ("dp",)),
    "model.q_proj": ("F16", np.float16, (32, 48), (None, "tp")),
    "model.norm": ("F32", np.float32, (32,), ()),
    "model.w_flat": ("F32", np.float32, (64,), (("dp", "tp"),)),
    "model.bf16": ("BF16", np.uint16, (8, 16), ("tp", None)),
    "model.uneven": ("F32", np.float32, (10, 4), None),
}


def make_content() -> tuple[bytes, dict]:
    """A safetensors file of exactly ``CONTENT_BYTES`` bytes: the tensors
    above from ``SEED`` and a uint8 filler sized to fit."""
    rng = np.random.default_rng(SEED)
    arrays = {}
    for name, (_, dt, shape, _) in TENSORS.items():
        if dt == np.uint16:
            arrays[name] = rng.integers(0, 1 << 16, shape, dtype=np.uint16)
        else:
            arrays[name] = rng.standard_normal(shape).astype(dt)
    fill = 0
    for _ in range(8):
        header, off = {}, 0
        for name, (st_dt, _, shape, _) in TENSORS.items():
            n = arrays[name].nbytes
            header[name] = {"dtype": st_dt, "shape": list(shape),
                            "data_offsets": [off, off + n]}
            off += n
        header["model.pad"] = {"dtype": "U8", "shape": [fill],
                               "data_offsets": [off, off + fill]}
        hjson = json.dumps(header).encode()
        want = CONTENT_BYTES - 8 - len(hjson) - off
        if want == fill:
            break
        fill = want
    arrays["model.pad"] = rng.integers(0, 256, fill, dtype=np.uint8)
    blob = struct.pack("<Q", len(hjson)) + hjson + b"".join(
        a.tobytes() for a in arrays.values())
    assert len(blob) == CONTENT_BYTES
    return blob, arrays


def padded_content() -> bytes:
    """Three pieces of 1028 bytes: 771 words, not a multiple of 4."""
    return np.random.default_rng(SEED + 1).integers(
        0, 256, 3 * 1028, dtype=np.uint8).tobytes()


def _land(sink_cls, content: bytes, piece: int, **kw):
    sink = sink_cls("mesh-sink-test", len(content), piece, **kw)
    for n in range(-(-len(content) // piece)):
        sink.land(n, content[n * piece:(n + 1) * piece])
    return sink


def _rank_main(rank: int, world: int, port: int, outdir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from dragonfly2_tpu_torch.daemon.peer.device_sink import (
        DeviceSinkError,
        TaskDeviceSink,
    )
    from dragonfly2_tpu_torch.ops.convert import placements_from_spec
    from dragonfly2_tpu_torch.ops.safetensors import load_from_sink
    from dragonfly2_tpu_torch.parallel import ici, multihost
    from tests.test_torch_parallel import local_bits as local
    from tests.test_torch_parallel import save_rank

    multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     device="cpu", timeout_s=60)
    content, _ = make_content()
    mesh = ici.make_mesh(device="cpu")
    out: dict = {}
    counts: dict = {}

    def case(name, fn):
        ici.reset_collective_counts()
        out[name] = fn()
        counts[name] = ici.collective_counts()

    sink = _land(TaskDeviceSink, content, PIECE, device="cpu")
    try:
        sink.ici_broadcast(mesh)
        out["unverified"] = np.array("no error")
    except DeviceSinkError as e:
        out["unverified"] = np.array(f"DeviceSinkError: {e}")
    sink.verify()
    buf = sink.sink._buffer

    def held():
        sh = sink.shard_to_mesh(mesh)
        per = sink.sink.padded_words // world
        out["held/view"] = np.array(
            sh.to_local().data_ptr() == buf.data_ptr() + rank * per * 4)
        return local(sh)

    case("held", held)
    case("scattered", lambda: local(
        sink.shard_to_mesh(mesh, src=0) if rank == 0
        else ici.scatter_shards(mesh, None, src=0)))
    case("ring_replicate", lambda: local(
        sink.sink.ring_replicate(mesh, n_chunks=3)))
    case("ici_broadcast", lambda: local(
        sink.ici_broadcast(mesh, n_chunks=3, src=0) if rank == 0
        else ici.chunked_ring_all_gather(
            mesh, ici.scatter_shards(mesh, None, src=0), n_chunks=3)))
    padded = _land(TaskDeviceSink, padded_content(), 1028, device="cpu")
    padded.verify()
    case("padded", lambda: local(padded.shard_to_mesh(mesh)))
    case("padded_ring", lambda: local(padded.ici_broadcast(mesh,
                                                           n_chunks=3)))

    mesh22 = multihost.global_mesh({"dp": 2, "tp": 2}, device="cpu")
    shardings = {name: (mesh22, placements_from_spec(("dp", "tp"), spec))
                 for name, (_, _, _, spec) in TENSORS.items()
                 if spec is not None}
    ici.reset_collective_counts()
    loaded = load_from_sink(sink, shardings=shardings)
    counts["load_from_sink"] = ici.collective_counts()
    for name in shardings:
        out[f"load/{name}"] = local(loaded[name])
    uneven = load_from_sink(sink, names=["model.uneven"], shardings={
        "model.uneven": (mesh, [Shard(0)])})["model.uneven"]
    out["uneven"] = local(uneven)
    out["uneven_shape"] = np.array(tuple(uneven.shape))
    dist.barrier()
    save_rank(outdir, rank, out, counts)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------------- #
# The tests (run in pytest's process, which also imports JAX)
# ---------------------------------------------------------------------- #

import types  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from dragonfly2_tpu_torch.client import device as pdev  # noqa: E402
from dragonfly2_tpu_torch.daemon.peer import device_sink as pds  # noqa: E402
from dragonfly2_tpu_torch.ops import safetensors as pst  # noqa: E402
from dragonfly2_tpu_torch.ops.convert import placements_from_spec  # noqa: E402
from dragonfly2_tpu_torch.parallel import multihost as pmh  # noqa: E402
from tests.test_torch_parallel import (  # noqa: E402
    jax_blocks,
    spawn_world,
    world_of_one,
)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(os.path.abspath(__file__), WORLD,
                       str(tmp_path_factory.mktemp("mesh_sink")))


def _jax_sink(content: bytes, piece: int):
    from dragonfly2_tpu.daemon.peer.device_sink import TaskDeviceSink

    sink = _land(TaskDeviceSink, content, piece)
    sink.verify()
    return sink


def _jmesh():
    from dragonfly2_tpu.parallel.ici import make_mesh

    return make_mesh(WORLD)


def _jmesh22():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("dp", "tp"))


def _same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    return got.shape == want.shape and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", ["held", "scattered"])
def test_shard_to_mesh_equals_the_jax_sink(world, case):
    want = jax_blocks(_jax_sink(make_content()[0], PIECE).shard_to_mesh(
        _jmesh()), _jmesh())
    for r in range(WORLD):
        assert _same_bits(world[r][case], want[r]), r
    for r in range(WORLD):
        # Every rank landed the content: each keeps a view of its buffer.
        assert bool(world[r]["held/view"])
        assert json.loads(world[r]["counts"].item())["held"] == {}


def test_shard_to_mesh_pads_up_never_truncates(world):
    want = jax_blocks(_jax_sink(padded_content(), 1028).shard_to_mesh(
        _jmesh()), _jmesh())
    for r in range(WORLD):
        assert _same_bits(world[r]["padded"], want[r]), r
    assert world[WORLD - 1]["padded"][-1] == 0     # 771 words -> 4 x 193


@pytest.mark.parametrize("case", ["ring_replicate", "ici_broadcast"])
def test_ring_replicate_equals_the_jax_ring(world, case):
    content = make_content()[0]
    want = jax_blocks(_jax_sink(content, PIECE).ici_broadcast(
        _jmesh(), n_chunks=3), _jmesh())
    for r in range(WORLD):
        assert _same_bits(world[r][case], want[r]), r
        assert world[r][case].tobytes()[:len(content)] == content


def test_ring_replicate_of_a_padded_sink(world):
    want = jax_blocks(_jax_sink(padded_content(), 1028).ici_broadcast(
        _jmesh(), n_chunks=3), _jmesh())
    for r in range(WORLD):
        assert _same_bits(world[r]["padded_ring"], want[r]), r


def test_ici_broadcast_refuses_an_unverified_sink(world):
    from dragonfly2_tpu.daemon.peer.device_sink import (
        DeviceSinkError,
        TaskDeviceSink,
    )

    sink = _land(TaskDeviceSink, make_content()[0], PIECE)
    with pytest.raises(DeviceSinkError, match="unverified sink"):
        sink.ici_broadcast(_jmesh())
    for r in range(WORLD):
        assert world[r]["unverified"].item().startswith(
            "DeviceSinkError: ici_broadcast on unverified sink")


@pytest.mark.parametrize("name", [n for n, t in TENSORS.items()
                                  if t[3] is not None])
def test_load_from_sink_shardings_equal_the_jax_shards(world, name):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dragonfly2_tpu.ops import safetensors as jst

    mesh = _jmesh22()
    spec = TENSORS[name][3]
    got_jax = jst.load_from_sink(_jax_sink(make_content()[0], PIECE),
                                 shardings={name: NamedSharding(
                                     mesh, P(*spec))})
    want = jax_blocks(got_jax[name], mesh)
    for r in range(WORLD):
        assert _same_bits(world[r][f"load/{name}"], want[r]), r
    assert json.loads(world[0]["counts"].item())["load_from_sink"] == {}


def test_uneven_shards_follow_torch_chunk(world):
    """JAX refuses 10 rows over 4 devices; the port splits them as
    ``torch.chunk`` does: 3, 3, 3, 1 (ROADMAP queue C)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    full = make_content()[1]["model.uneven"]
    with pytest.raises(ValueError, match="evenly divide"):
        NamedSharding(_jmesh(), P("d")).devices_indices_map(full.shape)
    parts = torch.chunk(torch.from_numpy(full), WORLD)
    for r in range(WORLD):
        assert _same_bits(world[r]["uneven"], parts[r].numpy()), r
        assert tuple(world[r]["uneven_shape"]) == full.shape
    assert [len(p) for p in parts] == [3, 3, 3, 1]


# ---------------------------------------------------------------------- #
# download_global's planner against the JAX package's download_global
# ---------------------------------------------------------------------- #

GLOBAL_CASES = [                  # (mesh, tensor, PartitionSpec tuple)
    ("d", "model.embed", ("d",)),               # leading axis
    ("d", "model.q_proj", (None, "d")),         # second axis
    ("d", "model.norm", ()),                    # replicated
    ("dp_tp", "model.embed", ("dp",)),
    ("dp_tp", "model.q_proj", (None, "tp")),
    ("dp_tp", "model.w_flat", (("dp", "tp"),)),
    ("dp_tp", "model.bf16", ("tp", None)),
    ("dp_tp", "model.norm", ()),
]
PLEN_PAST_HEADER = 100          # the header pull also covers some data


def _jax_global(monkeypatch, content: bytes, shardings: dict):
    """The JAX package's download_global over ``content``, its header and
    range pulls served from memory; returns (arrays, ranges it pulled)."""
    import jax.numpy as jnp

    from dragonfly2_tpu.client import device as jdev
    from dragonfly2_tpu.ops import safetensors as jst

    n = int.from_bytes(content[:8], "little")
    header, data_start = jst.parse_header(content[:8 + n])
    plen = data_start + PLEN_PAST_HEADER
    pulled: list = []

    async def fetch(*a, **k):
        return header, data_start, jnp.asarray(
            np.frombuffer(content[:plen], np.uint8))

    async def pull(daemon, url, ranges, **k):
        pulled.extend(ranges)
        return {(s, e): jnp.asarray(np.frombuffer(content[s:e], np.uint8))
                for s, e in ranges}

    monkeypatch.setattr(jdev, "fetch_safetensors_header", fetch)
    monkeypatch.setattr(jdev, "_pull_ranges", pull)
    import asyncio

    out = asyncio.run(jdev.download_global(None, "http://o/x", shardings))
    return out, sorted(pulled), header, data_start, plen


def _carve(content: bytes, name: str, a: int, b: int, shard_shape,
           idx) -> np.ndarray:
    """The block a plan entry describes, cut from the content bytes."""
    _, dt, shape, _ = TENSORS[name]
    raw = np.frombuffer(content[a:b], np.dtype(dt))
    if idx is None:
        return raw.reshape(shard_shape)
    return raw.reshape(shape)[idx]


@pytest.mark.parametrize("mesh_kind,name,spec", GLOBAL_CASES,
                         ids=[f"{m}-{n}-{s}" for m, n, s in GLOBAL_CASES])
def test_plan_global_equals_the_jax_plan(monkeypatch, mesh_kind, name, spec):
    from jax.sharding import NamedSharding, PartitionSpec as P

    content = make_content()[0]
    jmesh = _jmesh() if mesh_kind == "d" else _jmesh22()
    arrays, jax_pulls, header, data_start, plen = _jax_global(
        monkeypatch, content, {name: NamedSharding(jmesh, P(*spec))})
    want = jax_blocks(arrays[name], jmesh)
    names = jmesh.axis_names
    placements = placements_from_spec(names, spec)
    mesh_shape = tuple(jmesh.devices.shape)
    spans = []
    for r, coord in enumerate(np.ndindex(*mesh_shape)):
        (entry,) = pdev.plan_global(header, data_start,
                                    {name: (placements, mesh_shape, coord)})
        _, a, b, shard_shape, idx = entry
        block = _carve(content, name, a, b, shard_shape, idx)
        assert _same_bits(block, want[r]), (r, coord)
        assert tuple(shard_shape) == want[r].shape
        # Leading-axis blocks pull exactly their rows; others the tensor.
        assert (idx is None) == all(s is None for s in spec[1:])
        spans.append((a, b))
    port_pulls = [m for m in pdev.coalesce_spans(s for s in spans
                                                 if s[1] > s[0])
                  if m[1] > plen]
    assert port_pulls == jax_pulls


# ---------------------------------------------------------------------- #
# A world of one in this process, through a reference daemon
# ---------------------------------------------------------------------- #

def _bits(t) -> bytes:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).reshape(-1).view(np.uint8).tobytes()


def test_client_placement_through_a_reference_daemon(world_of_one, run_async,
                                                     tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dragonfly2_tpu.client import device as jdev
    from dragonfly2_tpu.daemon.daemon import Daemon
    from dragonfly2_tpu.pkg.testing import start_range_origin
    from tests.test_p2p_e2e import daemon_config, start_scheduler

    import jax
    from jax.sharding import Mesh

    mesh = world_of_one
    jmesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    content, arrays = make_content()
    specs = {"model.embed": ("d",), "model.q_proj": (None, "d"),
             "model.norm": ()}

    async def body():
        runner, url, _ = await start_range_origin(content)
        sched = await start_scheduler()
        daemons = []
        try:
            cfg = daemon_config(tmp_path, "port", sched.port())
            cfg.tpu_sink.enabled = False
            port_d = Daemon(cfg)
            port_d.task_manager.device_sinks = pds.DeviceSinkManager(
                device="cpu")
            await port_d.start()
            daemons.append(port_d)
            cfg = daemon_config(tmp_path, "jax", sched.port())
            cfg.tpu_sink.enabled = True
            jax_d = Daemon(cfg)
            await jax_d.start()
            daemons.append(jax_d)
            port_sh = {n: (mesh, placements_from_spec(("d",), s))
                       for n, s in specs.items()}
            jax_sh = {n: NamedSharding(jmesh, P(*s)) for n, s in specs.items()}

            got = await pdev.download_global(port_d, url, port_sh,
                                             prefix_guess=64)
            want = await jdev.download_global(jax_d, url, jax_sh,
                                              prefix_guess=64)
            assert set(got) == set(want) == set(specs)
            for n in specs:
                assert isinstance(got[n], DTensor)
                assert _bits(got[n]) == _bits(want[n]) == arrays[n].tobytes()

            got = await pdev.download_sharded(port_d, url, names=list(specs),
                                              shardings=port_sh)
            want = await jdev.download_sharded(jax_d, url, names=list(specs),
                                               shardings=jax_sh)
            for n in specs:
                assert got[n].placements == tuple(port_sh[n][1])
                assert _bits(got[n]) == _bits(want[n])
            with pytest.raises(pst.SafetensorsError, match="not loaded"):
                await pdev.download_sharded(
                    port_d, url, names=["model.norm"],
                    shardings={"model.embed": port_sh["model.embed"]})

            words = await pdev.download_to_device(port_d, url, mesh=mesh)
            jwords = await jdev.download_to_device(jax_d, url, mesh=jmesh)
            assert words.placements == (Shard(0),)
            assert _bits(words) == _bits(jwords)

            res = await pdev.download_to_device(port_d, url)
            loaded = res.load_safetensors(shardings=port_sh)
            jres = await jdev.download_to_device(jax_d, url)
            jloaded = jres.load_safetensors(shardings=jax_sh)
            for n in specs:
                assert _bits(loaded[n]) == _bits(jloaded[n])
            # A block of a tensor every rank holds is a view of it.
            w = res.as_tensor("float32", [16, 32])
            blk = pmh.place(w, (mesh, [Shard(0)])).to_local()
            assert blk.data_ptr() == w.data_ptr()
        finally:
            for d in daemons:
                await d.stop()
            await sched.stop()
            await runner.cleanup()

    run_async(body(), timeout=120)


class _Store:
    """The completed-store surface ``swap_generation`` reads."""

    def __init__(self, content: bytes, piece: int):
        self.content = content
        n = -(-len(content) // piece)
        recs = {i: types.SimpleNamespace(num=i, digest="") for i in range(n)}
        self.metadata = types.SimpleNamespace(
            content_length=len(content), piece_size=piece,
            total_piece_count=n, pieces=recs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def read_into(self, offset, length, buf):
        memoryview(buf)[:length] = self.content[offset:offset + length]

    def read_piece(self, num):
        ps = self.metadata.piece_size
        return self.content[num * ps:(num + 1) * ps]

    def get_pieces(self):
        return list(self.metadata.pieces.values())


def test_swap_generation_places_the_new_generation(world_of_one):
    from dragonfly2_tpu_torch.ops.hbm_sink import DoubleBuffer

    mesh = world_of_one
    content, arrays = make_content()
    hot = DoubleBuffer()
    shardings = {"model.embed": (mesh, [Shard(0)]),
                 "model.norm": (mesh, [Replicate()])}
    res = pdev.swap_generation(_Store(content, PIECE), hot=hot,
                               device="cpu", shardings=shardings)
    assert res.flipped and hot.generation == 1
    for n in shardings:
        t = hot.tensors()[n]
        assert isinstance(t, DTensor) and _bits(t) == arrays[n].tobytes()
    assert not isinstance(hot.tensors()["model.q_proj"], DTensor)
    with pytest.raises(pst.SafetensorsError, match="not loaded"):
        pdev.swap_generation(_Store(content, PIECE), device="cpu",
                             names=["model.norm"], shardings=shardings)
    with pytest.raises(TypeError, match="DeviceMesh, placements"):
        pdev.swap_generation(_Store(content, PIECE), device="cpu",
                             shardings={"model.norm": "d"})


def test_download_global_refuses_a_sharding_off_this_rank(world_of_one,
                                                          monkeypatch):
    """A mesh this rank is not on has no block to pull here."""
    content, _ = make_content()
    n = int.from_bytes(content[:8], "little")
    header, data_start = pst.parse_header(content[:8 + n])

    async def fetch(*a, **k):
        return header, data_start, torch.frombuffer(
            bytearray(content[:data_start]), dtype=torch.uint8)

    monkeypatch.setattr(pdev, "fetch_safetensors_header", fetch)
    mesh = world_of_one
    off = types.SimpleNamespace(get_coordinate=lambda: None,
                                device_type="cpu", ndim=1)
    monkeypatch.setattr(pmh, "check_shardings", lambda s: None)
    monkeypatch.setattr(pdev, "check_shardings", lambda s: None)
    import asyncio

    with pytest.raises(pst.SafetensorsError, match="no device on this rank"):
        asyncio.run(pdev.download_global(None, "http://o/x", {
            "model.norm": (off, [Replicate()])}))
    with pytest.raises(pst.SafetensorsError, match="not in checkpoint"):
        asyncio.run(pdev.download_global(None, "http://o/x", {
            "typo": (mesh, [Replicate()])}))
