"""``UrlMeta``: the port's own copy of the request metadata
(``dragonfly2_tpu/proto/common.py``).

The reference daemon reads a request's metadata field by field (and
copies it with ``dataclasses.replace``), so the port's class has the same
fields and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Priority LEVEL3, "normal": the JAX package's default task priority.
DEFAULT_PRIORITY = 3


@dataclass
class UrlMeta:
    """Metadata distinguishing task identity and fetch behavior."""

    digest: str = ""                   # expected content digest "sha256:..."
    tag: str = ""                      # task isolation tag
    range: str = ""                    # HTTP range within the URL content
    filter: str = ""                   # '&'-separated query params to ignore
    header: dict[str, str] = field(default_factory=dict)
    application: str = ""
    priority: int = DEFAULT_PRIORITY
    tenant: str = ""                   # QoS attribution; not task identity
