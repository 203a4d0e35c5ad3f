"""Local piece stores with persistent metadata: the port's copy of
``dragonfly2_tpu/storage`` (a ``data`` file and a ``metadata.json`` a
task, piece writes with CRC-32C fused in, digest validation, output by
hardlink or copy, reload across restarts, TTL and disk-quota GC).
"""

from dragonfly2_tpu_torch.storage.local_store import (
    LocalTaskStore,
    PieceRecord,
    TaskStoreMetadata,
)
from dragonfly2_tpu_torch.storage.manager import StorageManager, StorageOption

__all__ = [
    "LocalTaskStore",
    "PieceRecord",
    "TaskStoreMetadata",
    "StorageManager",
    "StorageOption",
]
