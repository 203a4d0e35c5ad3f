"""The scheduler's resource model: the port's copy of
``dragonfly2_tpu/scheduler/resource/``."""

from dragonfly2_tpu_torch.scheduler.resource.host import Host, HostManager
from dragonfly2_tpu_torch.scheduler.resource.task import Task, TaskManager, TaskState
from dragonfly2_tpu_torch.scheduler.resource.peer import Peer, PeerManager, PeerState

__all__ = [
    "Host",
    "HostManager",
    "Task",
    "TaskManager",
    "TaskState",
    "Peer",
    "PeerManager",
    "PeerState",
]
