"""Batch landing: loader samples -> fixed-size record batches on the card.

The port of ``dragonfly2_tpu/dataset/device_feed.py``. The last hop of
the dataset plane: fixed-size records land through the port's ``HBMSink``
piece-per-record (one record per slot, zero-padded to a 4-byte multiple),
each batch is verified on the card against the host checksums, the same
verify-on-land contract as the daemon's device sink, and comes out as a
``(batch, record_bytes)`` uint8 view of the sink's buffer. Each batch is
one sink and one ``land_and_checksum`` launch (up to 64 records).

The feed lands on the card unless the caller passes ``device="cpu"``;
with no CUDA it raises. A batch whose landing runs the card out of
memory comes as a NumPy batch instead (logged, and counted under
``path="numpy"``), and the next batch tries the card again; a fault of
the port's kernels (``KernelError``) raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dragonfly2_tpu_torch import default_device
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops.hbm_sink import HBMSink
from dragonfly2_tpu_torch.pkg import dflog, metrics

log = dflog.get("dataset.device_feed")

DEVICE_BATCHES = metrics.counter(
    "dataset_device_batches_total",
    "Record batches produced by the device feed", ("path",))

# Records per sink batch (one K2 launch lands up to this many).
MAX_BATCH_PIECES = 64


class DeviceFeedError(Exception):
    pass


@dataclass
class DeviceBatch:
    """One landed batch: ``array`` is (n, record_bytes) uint8, a tensor
    on the sink's device, or an np.ndarray when this batch's landing ran
    out of device memory."""

    keys: list[str]
    array: object
    on_device: bool


class DeviceFeed:
    """Consumes a sample iterator (``PodShardedLoader.epoch()``) and
    yields fixed-size record batches of one member extension.

    ``record_bytes``: every record must be exactly this long, unless
    ``pad=True`` (shorter records are zero-padded; longer ones always
    raise: silent truncation would corrupt training data). The final
    short batch is yielded unless ``drop_last``.
    """

    def __init__(self, ext: str, record_bytes: int, batch_size: int, *,
                 pad: bool = False, drop_last: bool = False, device=None):
        if record_bytes <= 0 or batch_size <= 0:
            raise DeviceFeedError("record_bytes and batch_size must be > 0")
        self.ext = ext
        self.record_bytes = record_bytes
        self.batch_size = batch_size
        self.pad = pad
        self.drop_last = drop_last
        self.device = default_device(device)
        if self.device.type == "cuda":
            _build.library()   # a kernel that cannot build fails here

    def _record(self, sample: dict) -> bytes:
        data = sample.get(self.ext)
        if data is None:
            raise DeviceFeedError(
                f"sample {sample.get('__key__')!r} has no {self.ext!r} member")
        if len(data) > self.record_bytes:
            raise DeviceFeedError(
                f"sample {sample.get('__key__')!r}: {self.ext} is "
                f"{len(data)}B > record_bytes={self.record_bytes}")
        if len(data) < self.record_bytes:
            if not self.pad:
                raise DeviceFeedError(
                    f"sample {sample.get('__key__')!r}: {self.ext} is "
                    f"{len(data)}B != record_bytes={self.record_bytes} "
                    "(pass pad=True to zero-pad)")
            data = data + b"\0" * (self.record_bytes - len(data))
        return data

    def _land_hbm(self, keys: list[str], records: list[bytes]) -> DeviceBatch:
        padded = self.record_bytes + ((-self.record_bytes) % 4)
        sink = HBMSink(padded * len(records), padded, device=self.device,
                       batch_pieces=min(len(records), MAX_BATCH_PIECES))
        for i, rec in enumerate(records):
            sink.land_piece(i, rec)
        sink.verify()   # on-device checksums vs host values
        arr = sink.as_record_batch(len(records), self.record_bytes)
        DEVICE_BATCHES.labels("hbm").inc()
        return DeviceBatch(keys=keys, array=arr, on_device=True)

    def _land_numpy(self, keys: list[str], records: list[bytes]) -> DeviceBatch:
        arr = np.frombuffer(b"".join(records), dtype=np.uint8).reshape(
            len(records), self.record_bytes)
        DEVICE_BATCHES.labels("numpy").inc()
        return DeviceBatch(keys=keys, array=arr, on_device=False)

    def _land(self, keys: list[str], records: list[bytes]) -> DeviceBatch:
        try:
            return self._land_hbm(keys, records)
        except torch.cuda.OutOfMemoryError as e:
            # The input pipeline must outlive a full card: this batch comes
            # as host bytes, and the next one tries the card again.
            log.warning("device batch landing out of memory; this batch "
                        "as numpy", key=keys[0] if keys else "",
                        error=str(e)[:200])
        return self._land_numpy(keys, records)

    async def batches(self, samples):
        """Async generator: sample dicts in -> DeviceBatch out."""
        keys: list[str] = []
        records: list[bytes] = []
        async for sample in samples:
            keys.append(sample.get("__key__", ""))
            records.append(self._record(sample))
            if len(records) == self.batch_size:
                yield self._land(keys, records)
                keys, records = [], []
        if records and not self.drop_last:
            yield self._land(keys, records)
