"""The scheduler, the per-cluster control plane: the port's copy of
``dragonfly2_tpu/scheduler/`` on the port's drpc.

It picks every peer's parents, triggers the seed peer and decides
back-to-source. It does no device work and takes no ``device``
argument. ``server.SchedulerServer`` serves it; ``service`` refuses, at
construction, an option that would change a handout or needs a service
the port lacks (``service.refuse_unported``).
"""
