"""``FileTaskRequest``: the port's own copy of the daemon's file-task
request (``dragonfly2_tpu/daemon/peer/task_manager.py``).

The port's client hands this request to the reference daemon's
``TaskManager.start_file_task``, which reads it by duck type: the same
fields, and task ids byte-identical to the JAX package's. The wire value
that asks the daemon to land pieces in device memory stays
``device="tpu"``: that is the literal the reference daemon tests for.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from dragonfly2_tpu_torch.pkg import idgen
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.proto.common import UrlMeta

# The daemon's wire value for "also land the pieces in device memory".
DEVICE_SINK = "tpu"


@dataclass
class FileTaskRequest:
    url: str
    output: str
    meta: UrlMeta = field(default_factory=UrlMeta)
    peer_id: str = ""
    disable_back_source: bool = False
    range: Range | None = None
    # "" = disk only; DEVICE_SINK additionally lands verified pieces into
    # the daemon's device sinks as they arrive.
    device: str = ""
    # Register as a pod broadcast (the scheduler stripes the pull across
    # same-slice hosts).
    pod_broadcast: bool = False

    def task_id(self) -> str:
        return idgen.task_id_v1(
            self.url, digest=self.meta.digest, tag=self.meta.tag,
            application=self.meta.application, filters=self.meta.filter,
            range_header=self.meta.range)

    def parent_task_id(self) -> str:
        """The whole-content task id of a ranged request."""
        return idgen.parent_task_id_v1(
            self.url, digest=self.meta.digest, tag=self.meta.tag,
            application=self.meta.application, filters=self.meta.filter)
