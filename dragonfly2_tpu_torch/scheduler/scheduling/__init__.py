"""The scheduling core: candidate filtering, scoring and the retry loop.
The port's copy of ``dragonfly2_tpu/scheduler/scheduling/``."""

from dragonfly2_tpu_torch.scheduler.scheduling.evaluator import Evaluator
from dragonfly2_tpu_torch.scheduler.scheduling.scheduling import Scheduling

__all__ = ["Evaluator", "Scheduling"]
