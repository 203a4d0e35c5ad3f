"""The manager, the global control plane: the port's copy of
``dragonfly2_tpu/manager/``, on the standard library.

Cluster relationships, users and RBAC, the scheduler and seed-peer
registry that dynconfig clients pull from, and the job queue that
schedulers long-poll (a preheat job lands a shard on a seed's card).
``rest.py`` serves the REST API on ``http.server`` threads,
``rpcserver.py`` the ``Manager.*`` drpc methods, ``client.py`` is the
schedulers' drpc client; ``database.py`` is ``sqlite3``.
"""

from dragonfly2_tpu_torch.manager.config import ManagerConfig
from dragonfly2_tpu_torch.manager.server import ManagerServer

__all__ = ["ManagerConfig", "ManagerServer"]
