"""The port's ``daemon/transport.py`` against the JAX one.

``sendfile_window`` over the same store states (complete or running,
covered or not, every range shape); and ``fetch`` through each package's
task manager over one ``file://`` origin: the same attrs (task id, length,
geometry, resolved range, reuse) and the same bytes, with the identity
headers in any case. Tolerance 0.
"""

from __future__ import annotations

import asyncio
import types

import numpy as np
import pytest

from dragonfly2_tpu.daemon import transport as jtransport
from dragonfly2_tpu.daemon.peer.piece_manager import PieceManager as JPM
from dragonfly2_tpu.daemon.peer.task_manager import TaskManager as JTM
from dragonfly2_tpu.pkg.piece import Range as JRange
from dragonfly2_tpu.storage import StorageManager as JSM
from dragonfly2_tpu.storage import StorageOption as JSMOption
from dragonfly2_tpu_torch.daemon import transport as ptransport
from dragonfly2_tpu_torch.daemon.peer.piece_manager import PieceManager
from dragonfly2_tpu_torch.daemon.peer.task_manager import TaskManager
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.storage import StorageManager, StorageOption


class _Store:
    """What ``sendfile_window`` reads of a store."""

    def __init__(self, path, *, done: bool, landed: tuple[int, int]):
        self.data_path = str(path)
        self.metadata = types.SimpleNamespace(done=done)
        self._landed = landed

    def is_complete(self) -> bool:
        return self.metadata.done

    def covers_range(self, start: int, length: int) -> bool:
        lo, hi = self._landed
        return lo <= start and start + length <= hi


@pytest.mark.parametrize("state", ["done", "running", "truncated"])
@pytest.mark.parametrize("rng", [None, (0, 100), (10, 20), (990, 50),
                                 (1000, 5), (2000, 1), (50, 0), (400, -1)])
@pytest.mark.parametrize("total", [1000, -1, 0])
def test_sendfile_window_matches_jax(tmp_path, state, rng, total):
    path = tmp_path / "data"
    path.write_bytes(bytes(1000 if state != "truncated" else 600))
    store = _Store(path, done=state != "running", landed=(0, 500))
    got = ptransport.P2PTransport.sendfile_window(
        {"local_store": store}, None if rng is None else Range(*rng), total)
    want = jtransport.P2PTransport.sendfile_window(
        {"local_store": store}, None if rng is None else JRange(*rng), total)
    assert got == want
    assert ptransport.P2PTransport.sendfile_window({}, None, total) is None


def _ids(attrs: dict) -> dict:
    out = {k: v for k, v in attrs.items()
           if k not in ("peer_id", "local_store")}
    rng = out.get("range")
    out["range"] = None if rng is None else (rng.start, rng.length)
    return out


async def _drain(body) -> bytes:
    parts = []
    async for chunk in body:
        parts.append(bytes(chunk))
    return b"".join(parts)


def test_fetch_gives_the_jax_task_ids_and_bytes(run_async, tmp_path):
    content = np.random.default_rng(13).integers(
        0, 256, (5 << 20) + 777, dtype=np.uint8).tobytes()
    origin = tmp_path / "obj.bin"
    origin.write_bytes(content)
    url = "file://" + str(origin)
    cases = [
        {"X-Dragonfly-Tag": "b"},
        {"x-dragonfly-tag": "b", "RANGE": "bytes=10-4000"},
        {"X-Dragonfly-Tag": "b", "Range": "bytes=4194300-"},
        {"X-Dragonfly-Application": "app", "X-Dragonfly-Filter": "sig&exp",
         "Range": "bytes=0-0"},
        {"Range": "bytes=5-9", "Authorization": "x"},
        {},
    ]

    async def run():
        port_tm = TaskManager(
            StorageManager(StorageOption(data_dir=str(tmp_path / "p"))),
            PieceManager())
        jax_tm = JTM(JSM(JSMOption(data_dir=str(tmp_path / "j"))), JPM())
        port = ptransport.P2PTransport(port_tm)
        jax = jtransport.P2PTransport(jax_tm)
        for headers in cases:
            for _ in range(2):   # cold, then off the completed store
                pa, pbody = await port.fetch(url, dict(headers))
                ja, jbody = await jax.fetch(url, dict(headers))
                pb, jb = await _drain(pbody), await _drain(jbody)
                assert _ids(pa) == _ids(ja), headers
                assert pb == jb
                r = pa["range"]
                assert pb == (content if r is None
                              else content[r.start:r.start + r.length])
                # Each task has finished before the next fetch.
                await asyncio.sleep(0.05)
        with pytest.raises(Exception) as pe:
            await port.fetch(url, {"Range": "bytes=x"})
        with pytest.raises(Exception) as je:
            await jax.fetch(url, {"Range": "bytes=x"})
        assert type(pe.value).__name__ == type(je.value).__name__ == "DfError"
        assert (pe.value.code, str(pe.value)) == (je.value.code,
                                                  str(je.value))
        port_tm.storage.close()
        jax_tm.storage.close()

    run_async(run())
