"""The port's ``DeviceFeed`` against the JAX package's.

The same sample streams go through the port's feed (``device="cpu"``,
landing through the port's ``HBMSink``) and the JAX package's feed on its
sink path (``force_hbm=True``); the batches must be equal bit for bit,
with the same pad and ``drop_last`` rules and the same errors. The
counter keeps the JAX family and labels. Tolerance 0: bytes are compared
for equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dragonfly2_tpu.dataset import device_feed as jfeed
from dragonfly2_tpu_torch.dataset import device_feed as pfeed
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops import hbm_sink as phbm


async def _aiter(items):
    for it in items:
        yield it


def _samples(lengths, ext="bin", seed=0):
    rng = np.random.default_rng(seed)
    return [{"__key__": f"k{i:05d}",
             ext: rng.integers(0, 256, n, np.uint8).tobytes()}
            for i, n in enumerate(lengths)]


async def _collect(feed, samples):
    return [b async for b in feed.batches(_aiter(samples))]


def _bytes(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        return arr.contiguous().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(arr)).tobytes()


CASES = [
    # record_bytes, batch_size, pad, drop_last, record lengths
    (13, 3, False, False, [13] * 4),
    (10, 2, False, True, [10] * 5),
    (10, 1, True, False, [3]),
    (7, 4, True, True, [7, 5, 7, 1, 7, 7, 7, 2, 7]),
    (32768, 64, True, False, [32768] * 100 + [4000, 32768, 17]),
    (4096, 70, False, False, [4096] * 140),
]


@pytest.mark.parametrize("record_bytes,batch_size,pad,drop_last,lengths",
                         CASES, ids=["odd-width", "drop-last", "pad-one",
                                     "pad-and-drop", "token-records",
                                     "over-64-per-batch"])
def test_batches_equal_the_reference(run_async, record_bytes, batch_size,
                                     pad, drop_last, lengths):
    samples = _samples(lengths)
    kw = {"pad": pad, "drop_last": drop_last}
    before = pfeed.DEVICE_BATCHES.value("hbm")
    got = run_async(_collect(pfeed.DeviceFeed(
        "bin", record_bytes, batch_size, device="cpu", **kw), samples))
    want = run_async(_collect(jfeed.DeviceFeed(
        "bin", record_bytes, batch_size, force_hbm=True, **kw), samples))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys == w.keys
        assert g.on_device and w.on_device
        assert tuple(g.array.shape) == tuple(np.asarray(w.array).shape)
        assert g.array.dtype == torch.uint8
        assert _bytes(g.array) == _bytes(w.array)
    assert pfeed.DEVICE_BATCHES.value("hbm") == before + len(got)
    rows = b"".join(_bytes(b.array) for b in got)
    kept = samples[:sum(len(b.keys) for b in got)]
    assert rows == b"".join(
        s["bin"] + b"\0" * (record_bytes - len(s["bin"])) for s in kept)


BAD = [
    ("too-long", [{"__key__": "a", "bin": b"x" * 11}], {}),
    ("short-unpadded", [{"__key__": "s", "bin": b"x" * 3}], {}),
    ("missing-member", [{"__key__": "m", "jpg": b"x" * 10}], {"pad": True}),
    ("too-long-padded", [{"__key__": "b", "bin": b"x" * 12}], {"pad": True}),
]


@pytest.mark.parametrize("samples,kw", [b[1:] for b in BAD],
                         ids=[b[0] for b in BAD])
def test_bad_records_raise_as_in_the_reference(run_async, samples, kw):
    with pytest.raises(pfeed.DeviceFeedError) as got:
        run_async(_collect(pfeed.DeviceFeed("bin", 10, 1, device="cpu", **kw),
                           samples))
    with pytest.raises(jfeed.DeviceFeedError) as want:
        run_async(_collect(jfeed.DeviceFeed("bin", 10, 1, force_hbm=True,
                                            **kw), samples))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("record_bytes,batch_size", [(0, 1), (4, 0), (-1, 2)])
def test_bad_geometry_raises_as_in_the_reference(record_bytes, batch_size):
    with pytest.raises(pfeed.DeviceFeedError):
        pfeed.DeviceFeed("bin", record_bytes, batch_size, device="cpu")
    with pytest.raises(jfeed.DeviceFeedError):
        jfeed.DeviceFeed("bin", record_bytes, batch_size)


def test_counter_keeps_the_reference_family():
    assert pfeed.DEVICE_BATCHES.name == "dataset_device_batches_total"
    assert pfeed.DEVICE_BATCHES.labelnames == ("path",)
    assert jfeed.DEVICE_BATCHES._labelnames == ("path",)


def test_out_of_memory_degrades_to_numpy_batches(run_async, monkeypatch):
    """While every landing runs out of device memory, every batch comes
    as a numpy batch, counted under path="numpy", equal to the reference's
    numpy path."""
    samples = _samples([12] * 7)

    def out_of_memory(*args, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory: injected")

    monkeypatch.setattr(pfeed, "HBMSink", out_of_memory)
    hbm, numpy_ = (pfeed.DEVICE_BATCHES.value("hbm"),
                   pfeed.DEVICE_BATCHES.value("numpy"))
    feed = pfeed.DeviceFeed("bin", 12, 3, device="cpu")
    got = run_async(_collect(feed, samples))
    want = run_async(_collect(jfeed.DeviceFeed("bin", 12, 3), samples))
    assert [len(b.keys) for b in got] == [3, 3, 1]
    assert all(not b.on_device and isinstance(b.array, np.ndarray)
               for b in got)
    assert [_bytes(b.array) for b in got] == [_bytes(b.array) for b in want]
    assert pfeed.DEVICE_BATCHES.value("numpy") == numpy_ + 3
    assert pfeed.DEVICE_BATCHES.value("hbm") == hbm


def test_kernel_fault_propagates_instead_of_degrading(run_async, monkeypatch):
    def failed_launch(*args):
        raise _build.KernelLaunchError("land_and_checksum: injected")

    monkeypatch.setattr(phbm, "land_and_checksum", failed_launch)
    numpy_ = pfeed.DEVICE_BATCHES.value("numpy")
    feed = pfeed.DeviceFeed("bin", 8, 2, device="cpu")
    with pytest.raises(_build.KernelLaunchError, match="injected"):
        run_async(_collect(feed, _samples([8] * 4)))
    assert pfeed.DEVICE_BATCHES.value("numpy") == numpy_


def test_one_out_of_memory_degrades_only_its_batch(run_async, monkeypatch):
    """An out-of-memory on one batch makes that batch a numpy batch; the
    next batch lands on the sink again. The bytes equal the reference's
    either way."""
    samples = _samples([12] * 7, seed=4)
    real = pfeed.HBMSink
    calls = []

    def out_of_memory_once(*args, **kw):
        calls.append(args)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory: injected")
        return real(*args, **kw)

    monkeypatch.setattr(pfeed, "HBMSink", out_of_memory_once)
    hbm, numpy_ = (pfeed.DEVICE_BATCHES.value("hbm"),
                   pfeed.DEVICE_BATCHES.value("numpy"))
    got = run_async(_collect(pfeed.DeviceFeed("bin", 12, 3, device="cpu"),
                             samples))
    want = run_async(_collect(jfeed.DeviceFeed("bin", 12, 3, force_hbm=True),
                              samples))
    assert len(calls) == 3
    assert [isinstance(b.array, np.ndarray) for b in got] == [True, False,
                                                               False]
    assert [b.on_device for b in got] == [False, True, True]
    assert [_bytes(b.array) for b in got] == [_bytes(b.array) for b in want]
    assert pfeed.DEVICE_BATCHES.value("numpy") == numpy_ + 1
    assert pfeed.DEVICE_BATCHES.value("hbm") == hbm + 2
