"""The port's PEX gossip against the JAX package's, in one group.

``dragonfly2_tpu_torch/daemon/pex.py`` is a copy of
``dragonfly2_tpu/daemon/pex.py`` whose frames go through the port's own
MessagePack codec, so a port node and a JAX node gossip in one group on
loopback:

- a port seed and a JAX joiner, and a JAX seed and a port joiner (with a
  third node of either package learned transitively), converge on the
  members and on each other's task holders, and a removal gossips too;
- the datagrams each package sends are the other's bytes (the same
  envelope, packed by ``msgpack`` and by the port's codec);
- with a shared secret the group converges; a node with a wrong secret,
  or none, is refused by both (its datagrams dropped, it learns nothing).
"""

from __future__ import annotations

import asyncio

import msgpack
import pytest

from dragonfly2_tpu.daemon import pex as jpex
from dragonfly2_tpu_torch.daemon import pex as ppex
from dragonfly2_tpu_torch.rpc import codec as pcodec

PKGS = {"jax": jpex, "port": ppex}


async def _wait(predicate, timeout: float = 10.0) -> bool:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if predicate():
            return True
        await asyncio.sleep(0.05)
    return predicate()


def _node(pkg: str, n: int, secret: str = ""):
    return PKGS[pkg].PeerExchange(ip="127.0.0.1", peer_port=1000 + n,
                                  upload_port=2000 + n, gossip_interval=0.1,
                                  secret=secret)


@pytest.mark.parametrize("seed_pkg,joiner_pkg,third_pkg", [
    ("port", "jax", "port"), ("jax", "port", "jax"),
    ("port", "jax", "jax"), ("jax", "port", "port")])
def test_mixed_groups_converge_on_members_and_holders(run_async, seed_pkg,
                                                      joiner_pkg, third_pkg):
    async def body():
        a, b, c = (_node(seed_pkg, 1), _node(joiner_pkg, 2),
                   _node(third_pkg, 3))
        try:
            port_a = await a.start(0)
            await b.start(0, seeds=[f"127.0.0.1:{port_a}"])
            await c.start(0, seeds=[f"127.0.0.1:{port_a}"])
            # b and c learn of each other through a.
            assert await _wait(lambda: all(len(x.members) == 2
                                           for x in (a, b, c)))
            a.add_task("task-a")
            b.add_task("task-b")
            c.add_task("task-b")
            assert await _wait(
                lambda: [m.node_id for m in b.find_holders("task-a")]
                == [a.node_id]
                and sorted(m.node_id for m in a.find_holders("task-b"))
                == sorted([b.node_id, c.node_id])
                and [m.node_id for m in c.find_holders("task-b")]
                == [b.node_id])
            m = a.find_holders("task-b")
            assert {(x.ip, x.peer_port, x.upload_port) for x in m} == {
                ("127.0.0.1", 1002, 2002), ("127.0.0.1", 1003, 2003)}
            a.remove_task("task-a")
            assert await _wait(lambda: b.find_holders("task-a") == []
                               and c.find_holders("task-a") == [])
        finally:
            for x in (c, b, a):
                await x.stop()

    run_async(body(), timeout=60)


def test_the_envelope_is_the_jax_bytes():
    j = _node("jax", 1)
    p = ppex.PeerExchange(ip="127.0.0.1", peer_port=1001, upload_port=2001,
                          node_id=j.node_id)
    p.incarnation = j.incarnation
    for x in (j, p):
        x.add_task("t-1")
        x.add_task("t-2")
    je, pe = j._envelope(), p._envelope()
    je["tasks"][j.node_id]["ids"].sort()
    pe["tasks"][p.node_id]["ids"].sort()
    assert pe == je
    assert pcodec.packb({"t": "ping", **pe}) == msgpack.packb(
        {"t": "ping", **je}, use_bin_type=True)
    # A sealed datagram of either package authenticates at the other.
    for x, y in ((j, p), (p, j)):
        x.secret = y.secret = b"s3cret"
        data = pcodec.packb({"t": "ping", **pe})
        assert y._authenticate(x._seal(data)) == data
        y.secret = b"other"
        assert y._authenticate(x._seal(data)) is None


@pytest.mark.parametrize("good_pkg,bad_pkg", [("port", "jax"),
                                              ("jax", "port"),
                                              ("port", "port"),
                                              ("jax", "jax")])
@pytest.mark.parametrize("bad_secret", ["wrong", ""], ids=["wrong", "none"])
def test_a_wrong_secret_is_refused_by_both(run_async, good_pkg, bad_pkg,
                                           bad_secret):
    async def body():
        other = "jax" if good_pkg == "port" else "port"
        a = _node(good_pkg, 1, secret="pod-secret")
        b = _node(other, 2, secret="pod-secret")
        bad = _node(bad_pkg, 3, secret=bad_secret)
        try:
            port_a = await a.start(0)
            await b.start(0, seeds=[f"127.0.0.1:{port_a}"])
            await bad.start(0, seeds=[f"127.0.0.1:{port_a}"])
            a.add_task("t")
            bad.add_task("t")
            assert await _wait(lambda: len(a.members) == 1
                               and len(b.members) == 1
                               and [m.node_id for m in b.find_holders("t")]
                               == [a.node_id])
            await asyncio.sleep(0.6)   # several gossip rounds
            assert bad.node_id not in a.members
            assert bad.node_id not in b.members
            assert bad.members == {}
            assert bad.find_holders("t") == []
        finally:
            for x in (bad, b, a):
                await x.stop()

    run_async(body(), timeout=60)
