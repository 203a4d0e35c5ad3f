"""The scheduler, the per-cluster control plane: the port's copy of
``dragonfly2_tpu/scheduler/`` on the port's drpc.

It picks every peer's parents, triggers the seed peer and decides
back-to-source. It does no device work and takes no ``device``
argument. ``server.SchedulerServer`` serves it, with the pod lens, the
SLO engine and the runtime observatory on by default, as in JAX.
"""
