"""The port's multi-device layer against the JAX package's, rank by rank.

One 4-rank gloo world (``spawn_world``: four processes of this file, run
as a script, each importing neither JAX nor the JAX package) runs every
case once and saves each rank's local data; each pytest case below holds
rank r's data against the JAX package's shard for device r of a 4-device
CPU mesh (``addressable_shards``), from the same seeded numpy inputs. Bit
for bit: bytes are compared for equality. ``global_from_local_shards``
also runs on a 2-rank mesh of the world (ranks 0 and 1), mirroring
``tests/test_multihost_procs.py``, and on a 2 x 2 mesh. Cases that need
no world (argument checks, topology) run in the test process.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SEED = 20261016
RANK_TIMEOUT_S = 60          # process-group timeout inside the ranks
SPAWN_TIMEOUT_S = 120        # the whole world, then its ranks are killed


# ---------------------------------------------------------------------- #
# Inputs, shared by the ranks and the JAX side
# ---------------------------------------------------------------------- #

def inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(SEED)
    return {
        "u32": np.arange(WORLD * 16, dtype=np.uint32),
        "f16": rng.standard_normal((WORLD * 6, 3)).astype(np.float16),
        # bf16 travels as its bits; numpy has no bfloat16.
        "bf16": rng.integers(0, 1 << 16, (WORLD * 5, 2), dtype=np.uint16),
        "f32": np.arange(32, dtype=np.float32),
        "ring": np.arange(WORLD * 8, dtype=np.uint32),
        "chunked": np.arange(WORLD * 24 * 3, dtype=np.uint32).reshape(
            WORLD * 24, 3),
        "striped": np.arange(101, dtype=np.uint32),
        "bitcast": rng.standard_normal(16).astype(np.float32),
        "gfls": (np.arange(WORLD * 8, dtype=np.float32).reshape(WORLD, 8)),
    }


CHUNKS = (1, 3, 4, 24, 100)


# ---------------------------------------------------------------------- #
# The world: this file run as a script, one process per rank
# ---------------------------------------------------------------------- #

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_world(script: str, world: int, outdir: str) -> list[dict]:
    """Run ``script RANK WORLD PORT OUTDIR`` once per rank and return each
    rank's saved arrays. A world that outlives ``SPAWN_TIMEOUT_S`` is
    killed and the test fails with every rank's output."""
    import pytest

    from dragonfly2_tpu.pkg.hermetic import scrub_accelerator_env

    env = scrub_accelerator_env(dict(os.environ))
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(port), outdir],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        dumps = [p.communicate()[0] for p in procs]
        pytest.fail("world timed out:\n" + "\n=====\n".join(
            d[-3000:] for d in dumps))
    bad = [f"rank {r} rc={p.returncode}:\n{out[-4000:]}"
           for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        pytest.fail("\n=====\n".join(bad))
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
            for r in range(world)]


def local_bits(t) -> np.ndarray:
    """A ``DTensor``'s local block as numpy (bfloat16 as its uint16
    bits: numpy has no bfloat16)."""
    import torch

    lt = t.to_local().contiguous()
    if lt.dtype == torch.bfloat16:
        lt = lt.view(torch.uint16)
    return lt.numpy()


def save_rank(outdir: str, rank: int, results: dict, counts: dict) -> None:
    results["counts"] = np.array(json.dumps(counts))
    results["modules"] = np.array(json.dumps(sorted(
        m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "jaxlib", "dragonfly2_tpu.")) or m == "dragonfly2_tpu")))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **results)


def _rank_main(rank: int, world: int, port: int, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    from dragonfly2_tpu_torch.parallel import ici, multihost

    multihost.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     device="cpu", timeout_s=RANK_TIMEOUT_S)
    # A second call is a no-op, whatever it asks.
    multihost.initialize_distributed("127.0.0.1:1", 9, 8, device="cpu")
    data = inputs()
    out: dict = {"world": np.array(dist.get_world_size())}
    counts: dict = {}
    mesh = ici.make_mesh(device="cpu")

    def case(name, fn):
        ici.reset_collective_counts()
        out[name] = fn()
        counts[name] = ici.collective_counts()

    local = local_bits

    src = {k: (v if rank == 0 else None) for k, v in data.items()}
    bf16 = torch.from_numpy(data["bf16"]).view(torch.bfloat16)
    case("scatter/u32", lambda: local(ici.scatter_shards(mesh, src["u32"])))
    case("scatter/f16", lambda: local(ici.scatter_shards(mesh, src["f16"])))
    case("scatter/bf16", lambda: local(ici.scatter_shards(
        mesh, bf16 if rank == 0 else None)))
    case("scatter_held/u32", lambda: local(ici.scatter_shards(
        mesh, data["u32"], src=None)))
    sharded = ici.scatter_shards(mesh, src["u32"])
    case("all_gather/u32", lambda: local(ici.all_gather_shards(mesh,
                                                               sharded)))
    case("replicate/f32", lambda: local(ici.replicate_to_mesh(
        mesh, src["f32"])))
    ring_in = ici.scatter_shards(mesh, data["ring"], src=None)
    case("ring", lambda: local(ici.ring_all_gather(mesh, ring_in)))
    out["ring_shape"] = np.array(
        tuple(ici.ring_all_gather(mesh, ring_in).shape))
    chunked = ici.scatter_shards(mesh, data["chunked"], src=None)
    for n in CHUNKS:
        case(f"chunked/{n}", lambda n=n: local(ici.chunked_ring_all_gather(
            mesh, chunked, n_chunks=n)))

    def striped():
        sb = ici.StripedBroadcast(mesh, n_chunks=2)
        for lo in range(0, 101, 17):
            sb.feed(data["striped"][lo:lo + 17] if rank == 0 else None)
        return local(sb.result())

    case("striped", striped)
    try:
        ici.StripedBroadcast(mesh).result()
        out["striped_empty"] = np.array("no error")
    except ValueError as e:
        out["striped_empty"] = np.array(f"ValueError: {e}")

    # A ring per "tp" pair of a 2 x 2 mesh: each pair gathers its rows.
    mesh_tp = multihost.global_mesh({"dp": 2, "tp": 2}, device="cpu")
    case("chunked/tp", lambda: local(ici.chunked_ring_all_gather(
        mesh_tp, ici.scatter_shards(mesh_tp, data["chunked"], "tp",
                                    src=None), "tp", n_chunks=3)))

    # global_from_local_shards on two ranks: each holds its 2 rows.
    pair = ici.make_mesh(2, device="cpu")
    rows = data["gfls"]
    if rank < 2:
        case("gfls/pair", lambda: local(multihost.global_from_local_shards(
            pair, rows[rank * 2:(rank + 1) * 2])))
        out["gfls/pair_shape"] = np.array(tuple(
            multihost.global_from_local_shards(
                pair, rows[rank * 2:(rank + 1) * 2]).shape))
    else:
        try:
            multihost.global_from_local_shards(pair, rows[:2])
            out["gfls/off_mesh"] = np.array("no error")
        except ValueError as e:
            out["gfls/off_mesh"] = np.array(f"ValueError: {e}")
    # On a 2 x 2 mesh, sharded over "tp", replicated over "dp".
    mesh22 = multihost.global_mesh({"dp": 2, "tp": 2}, device="cpu")
    tp = mesh22.get_coordinate()[1]
    case("gfls/factored", lambda: local(multihost.global_from_local_shards(
        mesh22, rows[tp * 2:(tp + 1) * 2], axis_name="tp")))
    mine = torch.from_numpy(data["f32"].copy())
    rep = multihost.global_replicated(mesh, mine)
    out["replicated/same_storage"] = np.array(
        rep.to_local().data_ptr() == mine.data_ptr())
    case("replicated", lambda: local(multihost.global_replicated(mesh,
                                                                 mine)))
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

import pytest  # noqa: E402
import torch  # noqa: E402

from dragonfly2_tpu_torch.parallel import ici as pici  # noqa: E402
from dragonfly2_tpu_torch.parallel import multihost as pmh  # noqa: E402
from dragonfly2_tpu_torch.parallel import topology as ptopo  # noqa: E402


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(os.path.abspath(__file__), WORLD,
                       str(tmp_path_factory.mktemp("world")))


def jax_blocks(arr, mesh) -> list[np.ndarray]:
    """The array's shard on each device of ``mesh``, in mesh order (rank
    r of the port holds the block of mesh position r)."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in mesh.devices.flat]


def _jmesh(n=WORLD):
    from dragonfly2_tpu.parallel import ici as jici

    return jici.make_mesh(n)


@pytest.mark.parametrize("kind", ["u32", "f16", "bf16"])
def test_scatter_shards_equal_the_jax_shards(world, kind):
    from dragonfly2_tpu.parallel import ici as jici

    data = inputs()[kind]
    if kind == "bf16":
        import ml_dtypes

        data = data.view(ml_dtypes.bfloat16)
    want = jax_blocks(jici.scatter_shards(_jmesh(), data), _jmesh())
    for r in range(WORLD):
        got = world[r][f"scatter/{kind}"]
        assert got.tobytes() == want[r].tobytes(), r
        assert got.shape == want[r].shape


def test_scatter_when_every_rank_holds_the_array(world):
    from dragonfly2_tpu.parallel import ici as jici

    want = jax_blocks(jici.scatter_shards(_jmesh(), inputs()["u32"]),
                       _jmesh())
    for r in range(WORLD):
        assert world[r]["scatter_held/u32"].tobytes() == want[r].tobytes()
        assert json.loads(
            world[r]["counts"].item())["scatter_held/u32"] == {}


def test_all_gather_shards_equals_the_jax_gather(world):
    from dragonfly2_tpu.parallel import ici as jici

    mesh = _jmesh()
    full = jici.all_gather_shards(mesh, jici.scatter_shards(
        mesh, inputs()["u32"]))
    want = jax_blocks(full, mesh)
    for r in range(WORLD):
        assert world[r]["all_gather/u32"].tobytes() == want[r].tobytes()


def test_replicate_to_mesh_equals_the_jax_replica(world):
    from dragonfly2_tpu.parallel import ici as jici

    want = jax_blocks(jici.replicate_to_mesh(_jmesh(), inputs()["f32"]),
                       _jmesh())
    for r in range(WORLD):
        assert world[r]["replicate/f32"].tobytes() == want[r].tobytes()


def test_ring_all_gather_equals_the_jax_ring(world):
    from dragonfly2_tpu.parallel import ici as jici

    mesh = _jmesh()
    ringed = jici.ring_all_gather(mesh, jici.scatter_shards(
        mesh, inputs()["ring"]))
    want = jax_blocks(ringed, mesh)
    for r in range(WORLD):
        assert world[r]["ring"].tobytes() == want[r].tobytes()
        assert tuple(world[r]["ring_shape"]) == ringed.shape


@pytest.mark.parametrize("n_chunks", CHUNKS)
def test_chunked_ring_all_gather_equals_the_jax_ring(world, n_chunks):
    from dragonfly2_tpu.parallel import ici as jici

    mesh = _jmesh()
    out = jici.chunked_ring_all_gather(
        mesh, jici.scatter_shards(mesh, inputs()["chunked"]),
        n_chunks=n_chunks)
    want = jax_blocks(out, mesh)
    for r in range(WORLD):
        assert world[r][f"chunked/{n_chunks}"].tobytes() == want[r].tobytes()
    # Each non-empty row slice is its own ring of n-1 hops; slices past
    # the 24 rows are skipped.
    rings = min(n_chunks, 24)
    counts = json.loads(world[0]["counts"].item())[f"chunked/{n_chunks}"]
    assert counts == {
        "chunked_ring_all_gather.batch_isend_irecv": rings * (WORLD - 1)}


def test_chunked_ring_on_one_axis_of_a_factored_mesh(world):
    import jax
    from jax.sharding import Mesh

    from dragonfly2_tpu.parallel import ici as jici

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    data = inputs()["chunked"]
    out = jici.chunked_ring_all_gather(
        mesh, jici.scatter_shards(mesh, data, "tp"), "tp", n_chunks=3)
    want = jax_blocks(out, mesh)
    for r in range(WORLD):
        assert world[r]["chunked/tp"].tobytes() == want[r].tobytes()
        assert world[r]["chunked/tp"].tobytes() == data.tobytes()
    # Each rank: 3 row slices, each a ring of one hop within its pair.
    assert json.loads(world[0]["counts"].item())["chunked/tp"] == {
        "chunked_ring_all_gather.batch_isend_irecv": 3}


def test_striped_broadcast_equals_the_jax_driver(world):
    from dragonfly2_tpu.parallel import ici as jici

    mesh = _jmesh()
    sb = jici.StripedBroadcast(mesh, n_chunks=2)
    content = inputs()["striped"]
    for lo in range(0, 101, 17):
        sb.feed(content[lo:lo + 17])
    want = jax_blocks(sb.result(), mesh)
    for r in range(WORLD):
        assert world[r]["striped"].tobytes() == want[r].tobytes()
        assert world[r]["striped"].tobytes() == content.tobytes()


def test_striped_broadcast_result_before_feed_raises(world):
    from dragonfly2_tpu.parallel import ici as jici

    with pytest.raises(ValueError, match="before any feed"):
        jici.StripedBroadcast(_jmesh()).result()
    for r in range(WORLD):
        assert world[r]["striped_empty"].item().startswith(
            "ValueError: StripedBroadcast.result() before any feed()")


def test_bitcast_landed_bytes_is_a_view_equal_to_jax():
    import jax.numpy as jnp

    from dragonfly2_tpu.parallel import ici as jici

    vals = inputs()["bitcast"]
    raw = np.frombuffer(vals.tobytes(), np.uint8)
    want = np.asarray(jici.bitcast_landed_bytes(jnp.asarray(raw), "float32",
                                                (4, 4)))
    buf = torch.from_numpy(raw.copy())
    got = pici.bitcast_landed_bytes(buf, "float32", (4, 4))
    assert got.numpy().tobytes() == want.tobytes()
    assert got.data_ptr() == buf.data_ptr()
    with pytest.raises(ValueError, match="cannot view"):
        pici.bitcast_landed_bytes(buf[1:], "float32", (3,))


def _jax_gfls(mesh, local, axis_name):
    from dragonfly2_tpu.parallel import multihost as jmh

    return jax_blocks(jmh.global_from_local_shards(
        mesh, local, axis_name=axis_name), mesh)


def test_global_from_local_shards_on_two_ranks(world):
    rows = inputs()["gfls"]
    mesh = _jmesh(2)
    want = _jax_gfls(mesh, rows, "d")
    for r in range(2):
        assert world[r]["gfls/pair"].tobytes() == want[r].tobytes()
        assert tuple(world[r]["gfls/pair_shape"]) == rows.shape
    for r in range(2, WORLD):
        assert world[r]["gfls/off_mesh"].item() == (
            "ValueError: this rank is not on the mesh")


def test_global_from_local_shards_on_a_factored_mesh(world):
    import jax
    from jax.sharding import Mesh

    rows = inputs()["gfls"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    want = _jax_gfls(mesh, rows, "tp")
    for r in range(WORLD):
        assert world[r]["gfls/factored"].tobytes() == want[r].tobytes()


def test_global_replicated_wraps_without_a_copy(world):
    from dragonfly2_tpu.parallel import multihost as jmh

    want = jax_blocks(jmh.global_replicated(_jmesh(), inputs()["f32"]),
                       _jmesh())
    for r in range(WORLD):
        assert world[r]["replicated"].tobytes() == want[r].tobytes()
        assert bool(world[r]["replicated/same_storage"])
        assert json.loads(world[r]["counts"].item())["replicated"] == {}


def test_collectives_are_counted_per_function(world):
    counts = json.loads(world[0]["counts"].item())
    assert counts["scatter/u32"] == {"scatter_shards.broadcast": 1,
                                     "scatter_shards.scatter": 1}
    assert counts["all_gather/u32"] == {
        "all_gather_shards.all_gather_into_tensor": 1}
    assert counts["replicate/f32"] == {"replicate_to_mesh.broadcast": 2}
    assert counts["ring"] == {"ring_all_gather.batch_isend_irecv": WORLD - 1}
    # Six feeds: a scatter and its metadata each, and two rings of n-1.
    assert counts["striped"] == {
        "StripedBroadcast.feed.broadcast": 6,
        "StripedBroadcast.feed.scatter": 6,
        "StripedBroadcast.feed.batch_isend_irecv": 6 * 2 * (WORLD - 1)}


def test_ranks_import_no_jax_and_init_is_idempotent(world):
    for r in range(WORLD):
        assert json.loads(world[r]["modules"].item()) == []
        assert int(world[r]["world"]) == WORLD


# ---------------------------------------------------------------------- #
# In the test process
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("args", [
    ("127.0.0.1:1", None, None), (None, 2, None), (None, None, 0),
    ("127.0.0.1:1", 2, 2), ("127.0.0.1:1", 0, 0), ("127.0.0.1:1", 2, -1)])
def test_initialize_distributed_rejects_bad_explicit_arguments(args):
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        pmh.initialize_distributed(*args, device="cpu")
    assert not dist.is_initialized()


@pytest.fixture
def world_of_one(monkeypatch):
    """A world of one in this process (no launcher variables) and its
    1-D ``cpu`` mesh, torn down after the test."""
    import torch.distributed as dist

    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    pmh.initialize_distributed(device="cpu")
    try:
        yield pici.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_world_of_one_without_a_launcher(world_of_one):
    import torch.distributed as dist

    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    pmh.initialize_distributed(device="cpu")          # no-op
    mesh = pici.make_mesh(device="cpu")
    assert tuple(mesh.mesh.shape) == (1,) and mesh.mesh_dim_names == ("d",)
    with pytest.raises(ValueError, match="needs 2 devices, job has 1"):
        pici.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="needs 4 devices, job has 1"):
        pmh.global_mesh({"dp": 2, "tp": 2}, device="cpu")
    # A ring of one rank posts no hop and sends nothing to itself.
    pici.reset_collective_counts()
    t = torch.arange(12, dtype=torch.int32)
    sharded = pici.scatter_shards(mesh, t)
    assert sharded.to_local().data_ptr() == t.data_ptr()
    out = pici.chunked_ring_all_gather(mesh, sharded, n_chunks=3)
    assert torch.equal(out.to_local(), t)
    assert pici.collective_counts() == {}


def test_torchrun_variables_form_the_group(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert not dist.is_initialized()
    pmh.initialize_distributed(device="cpu", timeout_s=30)
    try:
        assert dist.get_world_size() == 1
        assert "cpu:gloo" in dist.get_backend_config()
    finally:
        dist.destroy_process_group()


def test_a_cuda_mesh_needs_nccl(world_of_one, monkeypatch):
    """Over a gloo-only group, a CUDA mesh raises instead of moving card
    bytes through gloo."""
    monkeypatch.setattr(pmh, "default_device",
                        lambda device=None: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="needs NCCL"):
        pmh.mesh_for("cuda", (1,), ("d",))


def test_local_mesh_spans_this_hosts_ranks(world_of_one, monkeypatch):
    mesh = pmh.local_mesh(device="cpu")
    assert mesh.mesh.tolist() == [0] and mesh.mesh_dim_names == ("d",)
    mesh = pmh.local_mesh([1, 1], device="cpu")
    assert mesh.mesh_dim_names == ("d0", "d1")
    with pytest.raises(ValueError, match="needs 2 ranks, this host has 1"):
        pmh.local_mesh([2], device="cpu")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="do not divide a world of 1"):
        pmh.local_mesh(device="cpu")


@pytest.mark.parametrize("shape,mesh_shape,placements", [
    ((8, 4), (4,), "S0"), ((10, 4), (4,), "S0"), ((3, 6), (2, 2), "R,S1"),
    ((8,), (2, 2), "S0,S0"), ((5, 2), (2, 2), "S0,S0"), ((4,), (3,), "R")])
def test_block_index_follows_torch_chunk(shape, mesh_shape, placements):
    from torch.distributed.tensor import Replicate, Shard

    places = [Replicate() if p == "R" else Shard(int(p[1]))
              for p in placements.split(",")]
    t = torch.arange(int(np.prod(shape))).reshape(shape)
    coords = list(np.ndindex(*mesh_shape))
    for coord in coords:
        want = t
        for mesh_dim, p in enumerate(places):
            if isinstance(p, Shard):
                parts = torch.chunk(want, mesh_shape[mesh_dim], p.dim)
                i = coord[mesh_dim]
                want = parts[i] if i < len(parts) else want.narrow(
                    p.dim, want.shape[p.dim], 0)
        idx = pmh.block_index(shape, mesh_shape, coord, places)
        assert torch.equal(t[idx], want), coord


def test_topology_env_detection_equals_jax(monkeypatch):
    from dragonfly2_tpu.parallel import topology as jtopo

    monkeypatch.setenv("DF_TPU_SLICE", "v5p-slice-3")
    monkeypatch.setenv("DF_TPU_WORKER", "7")
    monkeypatch.setenv("DF_TPU_POD", "pod-a")
    monkeypatch.setenv("DF_ZONE", "us-east5-a")
    topo = ptopo.detect_topology()
    assert topo.present and topo.worker_index == 7
    assert topo.location_path() == "us-east5-a|pod-a|v5p-slice-3|w7"
    assert vars(topo) == vars(jtopo.detect_topology())


def test_topology_applies_to_the_host_config_as_jax(monkeypatch):
    from dragonfly2_tpu.daemon.config import HostOption
    from dragonfly2_tpu.parallel import topology as jtopo

    monkeypatch.setenv("DF_TPU_SLICE", "s1")
    monkeypatch.setenv("DF_TPU_WORKER", "2")
    port, ref = HostOption(), HostOption()
    ptopo.apply_to_host_config(port)
    jtopo.apply_to_host_config(ref)
    assert port.tpu_slice == "s1" and port.tpu_worker_index == 2
    assert port.idc == "s1"
    assert vars(port) == vars(ref)


def test_topology_torchrun_probe_is_opt_in(monkeypatch):
    for key in ("DF_TPU_SLICE", "TPU_NAME", "DF_TPU_WORKER",
                "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GROUP_RANK", "3")
    monkeypatch.setenv("GROUP_WORLD_SIZE", "16")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.delenv("DF_DETECT_TORCH", raising=False)
    assert not ptopo.detect_topology().present
    monkeypatch.setenv("DF_DETECT_TORCH", "1")
    topo = ptopo.detect_topology()
    assert (topo.slice_name, topo.worker_index, topo.num_workers,
            topo.chips_per_host) == ("torch-node-3-of-16", 0, 1, 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert not ptopo.detect_topology().present
