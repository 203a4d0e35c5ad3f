"""The port's drpc against the JAX package's.

- ``rpc/codec.py``: ``packb`` gives ``msgpack.packb(v, use_bin_type=True)``
  byte for byte, and ``unpackb`` what ``msgpack.unpackb(b, raw=False,
  strict_map_key=False)`` gives, for seeded random nested values and at
  every format boundary (ints at the edges of each width, str and bin of
  31/32, 255/256 and 65535/65536 bytes, arrays and maps of 15/16 and
  65535/65536 entries); unsupported types and out-of-range ints raise as
  ``msgpack`` does.
- Frames pack to the JAX framing's bytes and decode in both.
- A port client against a JAX ``rpc.Server`` and a JAX client against a
  port server: unary calls, bidi streams, ``DfError`` codes over ERR,
  unknown methods, the schema check of ``Peer.GetPieceTasks`` and
  ``Peer.SyncPieceTasks``, and PING.
- The hash ring picks what the JAX ring picks; the scheduler client opens
  its announce stream on the ring owner and fails over clockwise, with the
  ``peer_scheduler_failover_total`` outcomes.

Inputs come from numpy seeds. Tolerance 0: bytes and values exact.
"""

from __future__ import annotations

import socket

import msgpack
import numpy as np
import pytest

from dragonfly2_tpu.pkg.errors import Code as JCode
from dragonfly2_tpu.pkg.errors import DfError as JDfError
from dragonfly2_tpu.pkg.types import NetAddr as JNetAddr
from dragonfly2_tpu.rpc import Client as JClient
from dragonfly2_tpu.rpc import Server as JServer
from dragonfly2_tpu.rpc.balancer import HashRing as JRing
from dragonfly2_tpu.rpc.framing import Frame as JFrame
from dragonfly2_tpu_torch.daemon.schedulerclient import (
    FAILOVER_COUNT,
    SchedulerClient,
)
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.types import NetAddr
from dragonfly2_tpu_torch.rpc import Client, Server, codec
from dragonfly2_tpu_torch.rpc.balancer import HashRing
from dragonfly2_tpu_torch.rpc.framing import Frame


def _ref_pack(v) -> bytes:
    return msgpack.packb(v, use_bin_type=True)


def _ref_unpack(b: bytes):
    return msgpack.unpackb(b, raw=False, strict_map_key=False)


def _random_value(rng: np.random.Generator, depth: int = 0):
    kind = rng.integers(0, 10 if depth < 4 else 7)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        bits = int(rng.integers(1, 64))
        v = int(rng.integers(0, 1 << bits, dtype=np.uint64))
        return -v if rng.integers(0, 2) else v
    if kind == 3:
        return float(rng.standard_normal() * 10.0 ** rng.integers(-5, 6))
    if kind == 4:
        n = int(rng.choice([0, 5, 31, 32, 200, 300]))
        return "".join(chr(c) for c in rng.integers(32, 0x3000, n))
    if kind == 5:
        n = int(rng.choice([0, 7, 255, 256, 1000]))
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 6:
        return int(rng.integers(-40, 200))
    n = int(rng.integers(0, 20))
    if kind == 7:
        return [_random_value(rng, depth + 1) for _ in range(n)]
    if kind == 8:
        return tuple(_random_value(rng, depth + 1) for _ in range(n))
    return {(f"k{i}" if rng.integers(0, 3) else i):
            _random_value(rng, depth + 1) for i in range(n)}


@pytest.mark.parametrize("seed", range(24))
def test_random_values_pack_and_unpack_as_msgpack(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        v = _random_value(rng)
        want = _ref_pack(v)
        assert codec.packb(v) == want
        assert codec.unpackb(want) == _ref_unpack(want)


def _int_edges() -> list[int]:
    out = {0}
    for k in (4, 5, 7, 8, 15, 16, 31, 32, 63, 64):
        for v in (1 << k, -(1 << k)):
            out.update({v - 1, v, v + 1})
    return sorted(v for v in out if -(1 << 63) <= v < (1 << 64))


@pytest.mark.parametrize("v", _int_edges())
def test_int_edges_match_msgpack(v):
    want = _ref_pack(v)
    assert codec.packb(v) == want
    assert codec.unpackb(want) == v


@pytest.mark.parametrize("n", [0, 1, 31, 32, 255, 256, 65535, 65536])
@pytest.mark.parametrize("kind", ["str", "bin", "bytearray", "memoryview"])
def test_str_and_bin_lengths_match_msgpack(kind, n):
    rng = np.random.default_rng(n)
    raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    v = {"str": "".join(chr(97 + b % 26) for b in raw), "bin": raw,
         "bytearray": bytearray(raw), "memoryview": memoryview(raw)}[kind]
    want = _ref_pack(v)
    assert codec.packb(v) == want
    assert codec.unpackb(want) == _ref_unpack(want)


@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
@pytest.mark.parametrize("kind", ["list", "tuple", "dict"])
def test_array_and_map_sizes_match_msgpack(kind, n):
    v = {"list": list(range(n)), "tuple": tuple(range(n)),
         "dict": {i: -i for i in range(n)}}[kind]
    want = _ref_pack(v)
    assert codec.packb(v) == want
    assert codec.unpackb(want) == _ref_unpack(want)


@pytest.mark.parametrize("v", [0.0, -0.0, 1.5, -2.25e300, 5e-324,
                               float("inf"), float("-inf")])
def test_floats_match_msgpack(v):
    want = _ref_pack(v)
    assert codec.packb(v) == want
    assert codec.unpackb(want) == v


def test_float32_decodes_as_msgpack():
    b = msgpack.packb(1.25, use_single_float=True)
    assert b[0] == 0xCA and codec.unpackb(b) == _ref_unpack(b)


@pytest.mark.parametrize("v", [object(), {1, 2}, 1 + 2j])
def test_unsupported_types_raise_type_error(v):
    with pytest.raises(TypeError):
        _ref_pack(v)
    with pytest.raises(TypeError):
        codec.packb(v)


@pytest.mark.parametrize("v", [1 << 64, -(1 << 63) - 1])
def test_out_of_range_ints_raise_overflow(v):
    with pytest.raises(OverflowError):
        _ref_pack(v)
    with pytest.raises(OverflowError):
        codec.packb(v)


@pytest.mark.parametrize("data", [b"\x01\x02",          # trailing data
                                  b"\xda\x00\x05ab",    # truncated str
                                  b"\x92\x01"])          # truncated array
def test_bad_input_raises_value_error(data):
    with pytest.raises(ValueError):
        _ref_unpack(data)
    with pytest.raises(ValueError):
        codec.unpackb(data)


def test_an_ext_type_is_refused():
    """No drpc frame carries an ext type: ``msgpack`` decodes one to an
    ``ExtType``, the port's codec refuses it (an intended divergence)."""
    data = b"\xc7\x01\x05x"
    assert _ref_unpack(data) == msgpack.ExtType(5, b"x")
    with pytest.raises(ValueError):
        codec.unpackb(data)


FRAMES = [
    dict(type=1, call_id=1, method="Peer.GetPieceTasks",
         body={"task_id": "t" * 64}),
    dict(type=2, call_id=7, body={"pieces": list(range(149)),
                                  "digests": {i: f"crc32c:{i:08x}"
                                              for i in range(149)}}),
    dict(type=3, call_id=(1 << 32) + 5, method="Scheduler.AnnouncePeer",
         body={"host": {"id": "h", "port": 65535}, "is_seed": False},
         md={"traceparent": "00-abc"}),
    dict(type=6, call_id=3,
         error={"code": 4005, "message": "m", "metadata": {"reason": "x"}}),
    dict(type=7, call_id=9),
]


@pytest.mark.parametrize("fields", FRAMES, ids=lambda f: str(f["type"]))
def test_frames_are_the_jax_framings_bytes(fields):
    mine, theirs = Frame(**fields), JFrame(**fields)
    assert mine.pack() == theirs.pack()
    payload = theirs.pack()[4:]
    assert Frame.unpack(payload) == Frame(**{
        k: (list(v) if isinstance(v, tuple) else v)
        for k, v in fields.items()})
    assert JFrame.unpack(mine.pack()[4:]) == JFrame.unpack(payload)


# --------------------------------------------------------------------- #
# Clients and servers across the two packages
# --------------------------------------------------------------------- #

def _register(server, df_error) -> None:
    async def echo(body, ctx):
        return {"echo": body}

    async def fail(body, ctx):
        raise df_error(body["code"], body["message"], {"reason": "r"})

    async def crash(body, ctx):
        raise RuntimeError("boom")

    async def get_pieces(body, ctx):
        return {"task": body["task_id"]}

    async def stream_echo(stream, ctx):
        await stream.send({"open": stream.open_body})
        while (msg := await stream.recv()) is not None:
            if msg.get("fail"):
                raise df_error(msg["fail"], "stream failed")
            await stream.send({"got": msg})

    async def sync(stream, ctx):
        await stream.send({"task": stream.open_body["task_id"]})

    server.register_unary("T.Echo", echo)
    server.register_unary("T.Fail", fail)
    server.register_unary("T.Crash", crash)
    server.register_unary("Peer.GetPieceTasks", get_pieces)
    server.register_stream("T.Stream", stream_echo)
    server.register_stream("Peer.SyncPieceTasks", sync)


async def _exercise(client) -> dict:
    """One client's view of a server: answers, error codes, a stream."""
    out = {"echo": await client.call("T.Echo", {"a": [1, b"x", None]})}
    for method, body in (("T.Fail", {"code": 4404, "message": "gone"}),
                         ("T.Crash", {}), ("T.Nope", {}),
                         ("Peer.GetPieceTasks", {}),
                         ("Peer.GetPieceTasks", {"task_id": 5})):
        try:
            await client.call(method, body)
            out[method] = "no error"
        except Exception as e:
            out.setdefault("errors", []).append(
                (method, int(e.code), e.metadata.get("reason")))
    out["pieces"] = await client.call("Peer.GetPieceTasks",
                                      {"task_id": "t1"})
    s = await client.open_stream("T.Stream", {"k": 1})
    msgs = [await s.recv()]
    for i in range(3):
        await s.send({"i": i})
        msgs.append(await s.recv())
    await s.send({"fail": 4005})
    try:
        await s.recv()
    except Exception as e:
        msgs.append(("error", int(e.code)))
    out["stream"] = msgs
    bad = await client.open_stream("Peer.SyncPieceTasks", {"peer_id": "p"})
    try:
        await bad.recv()
    except Exception as e:
        out["sync_schema"] = int(e.code)
    ok = await client.open_stream("Peer.SyncPieceTasks", {"task_id": "t2"})
    out["sync"] = [await ok.recv(), await ok.recv()]
    out["ping"] = await client.ping()
    return out


_SIDES = {"port": (Server, Client, NetAddr, DfError),
          "jax": (JServer, JClient, JNetAddr, JDfError)}


async def _answers(server_pkg: str, client_pkg: str) -> dict:
    server_cls, _, addr_cls, df_error = _SIDES[server_pkg]
    _, client_cls, client_addr, _ = _SIDES[client_pkg]
    server = server_cls("t")
    _register(server, df_error)
    await server.serve(addr_cls.tcp("127.0.0.1", 0))
    client = client_cls(client_addr.tcp("127.0.0.1", server.port()))
    try:
        return await _exercise(client)
    finally:
        await client.close()
        await server.close()


@pytest.mark.parametrize("pair", ["port-client/jax-server",
                                  "jax-client/port-server",
                                  "port-client/port-server"])
def test_clients_and_servers_interoperate(run_async, pair):
    """Each pair's answers equal the JAX client's with the JAX server."""
    client_pkg, server_pkg = (p.split("-")[0] for p in pair.split("/"))

    async def body():
        return (await _answers("jax", "jax"),
                await _answers(server_pkg, client_pkg))

    ref, got = run_async(body(), timeout=30)
    assert got == ref
    assert ref["errors"] == [
        ("T.Fail", 4404, "r"), ("T.Crash", int(Code.UnknownError), None),
        ("T.Nope", int(Code.BadRequest), None),
        ("Peer.GetPieceTasks", int(Code.BadRequest), None),
        ("Peer.GetPieceTasks", int(Code.BadRequest), None)]
    assert ref["stream"][-1] == ("error", 4005)
    assert ref["sync_schema"] == int(Code.BadRequest)
    assert ref["ping"] is True


def test_a_dead_server_is_a_connection_error(run_async):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()

    async def body():
        out = []
        for cls, addr in ((Client, NetAddr), (JClient, JNetAddr)):
            c = cls(addr.tcp("127.0.0.1", port), connect_timeout=1.0)
            try:
                await c.call("T.Echo", {})
            except (DfError, JDfError) as e:
                out.append(int(e.code))
            out.append(await c.ping(timeout=0.5))
            await c.close()
        return out

    assert run_async(body(), timeout=30) == [
        int(Code.ClientConnectionError), False] * 2


@pytest.mark.parametrize("members", [1, 3, 8])
def test_hash_ring_picks_what_the_jax_ring_picks(members):
    addrs = [f"10.0.0.{i}:8002" for i in range(members)]
    mine, theirs = HashRing(addrs), JRing(addrs)
    rng = np.random.default_rng(members)
    for key in (rng.bytes(16).hex() for _ in range(200)):
        assert mine.pick(key) == theirs.pick(key)
        assert mine.pick_n(key, members) == theirs.pick_n(key, members)
    mine.remove(addrs[0])
    theirs.remove(addrs[0])
    assert mine.members() == theirs.members()
    assert mine.pick("k") == theirs.pick("k")


def test_scheduler_client_fails_over_clockwise(run_async):
    """The announce stream opens on the task's ring owner; with the owner
    dead, on the next member clockwise (counted ``failover``); with every
    member dead it raises the owner's connection error (``exhausted``)."""

    async def body():
        live = Server("sched")
        opened = []

        async def announce(stream, ctx):
            opened.append(stream.open_body["task_id"])
            await stream.send({"type": "ok"})

        live.register_stream("Scheduler.AnnouncePeer", announce)
        await live.serve(NetAddr.tcp("127.0.0.1", 0))
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead_addr = f"127.0.0.1:{dead.getsockname()[1]}"
        dead.close()
        live_addr = f"127.0.0.1:{live.port()}"
        ring = JRing([live_addr, dead_addr])
        owned = {m: next(k for k in (f"task-{i}" for i in range(1000))
                         if ring.pick(k) == m)
                 for m in (live_addr, dead_addr)}
        sc = SchedulerClient([live_addr, dead_addr])
        before = {r: FAILOVER_COUNT.value(r)
                  for r in ("owner", "failover", "exhausted")}
        out = []
        for member in (live_addr, dead_addr):
            # The open body the AnnouncePeer schema asks for.
            s = await sc.open_announce_stream({
                "task_id": owned[member], "peer_id": "p",
                "host": {"id": "h"}})
            out.append((await s.recv(), sc.stream_addr(owned[member])))
        await sc.close()
        only_dead = SchedulerClient([dead_addr])
        try:
            await only_dead.open_announce_stream({"task_id": "t"})
        except DfError as e:
            out.append(int(e.code))
        await only_dead.close()
        await live.close()
        after = {r: FAILOVER_COUNT.value(r) - before[r] for r in before}
        return out, after, opened, owned

    out, after, opened, owned = run_async(body(), timeout=30)
    live_addr = out[0][1]
    assert out[0] == ({"type": "ok"}, live_addr)
    assert out[1] == ({"type": "ok"}, live_addr)     # failed over
    assert out[2] == int(Code.ClientConnectionError)
    assert after == {"owner": 1, "failover": 1, "exhausted": 1}
    assert opened == list(owned.values())


def test_the_rpc_table_is_the_jax_table():
    from dragonfly2_tpu.daemon.schedulerclient import RPC_TABLE as JTABLE
    from dragonfly2_tpu_torch.daemon.schedulerclient import RPC_TABLE

    assert RPC_TABLE == JTABLE


def test_error_codes_cross_as_the_jax_codes():
    for code in (Code.SchedNeedBackSource, Code.ClientPieceNotFound,
                 Code.StorageTaskNotFound):
        wire = JDfError(JCode(int(code)), "m", {"x": 1}).to_wire()
        e = DfError.from_wire(codec.unpackb(codec.packb(wire)))
        assert (int(e.code), e.message, e.metadata) == (int(code), "m",
                                                       {"x": 1})


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_ring_rebuild_calls_the_watcher_of_a_moved_task(run_async, pkg):
    """``update_addrs`` rebuilds the ring; a task whose announce stream
    sits on a member that no longer owns it gets its watcher called with
    the new owner (the conductor re-homes); a task that stays put does
    not; ``unwatch_ring`` forgets it."""
    from dragonfly2_tpu.daemon.schedulerclient import (
        SchedulerClient as JSchedulerClient,
    )

    cls = SchedulerClient if pkg == "port" else JSchedulerClient

    async def body():
        live = Server("sched")

        async def announce(stream, ctx):
            await stream.send({"type": "ok"})

        live.register_stream("Scheduler.AnnouncePeer", announce)
        await live.serve(NetAddr.tcp("127.0.0.1", 0))
        a = f"127.0.0.1:{live.port()}"
        b = "127.0.0.1:1"
        ring = JRing([a, b])
        moved = next(f"t{i}" for i in range(1000) if ring.pick(f"t{i}") == b)
        sc = cls([a])
        calls = []
        for task in (moved, "kept"):
            await sc.open_announce_stream({"task_id": task})
            sc.watch_ring(task, lambda owner, t=task: calls.append((t, owner)))
        sc.update_addrs([a, b])
        first = list(calls)
        sc.unwatch_ring(moved)
        sc.update_addrs([a])
        sc.update_addrs([a, b])
        await sc.close()
        await live.close()
        return first, calls, JRing([a, b]).pick("kept") == a, moved, b

    first, calls, kept_stays, moved, b = run_async(body(), timeout=30)
    assert (moved, b) in first
    assert (("kept", b) in first) is (not kept_stays)
    assert [c for c in calls[len(first):] if c[0] == moved] == []
