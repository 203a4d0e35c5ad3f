"""Origin clients keyed by URL scheme: the port's copy of
``dragonfly2_tpu/source`` with the ``file`` and ``http(s)`` clients, on
the standard library only."""

from dragonfly2_tpu_torch.source.client import (
    ListEntry,
    Registry,
    Request,
    ResourceClient,
    Response,
    default_registry,
    get_client,
    register_client,
)

__all__ = [
    "ListEntry",
    "Registry",
    "Request",
    "ResourceClient",
    "Response",
    "default_registry",
    "get_client",
    "register_client",
]
