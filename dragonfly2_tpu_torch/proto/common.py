"""``UrlMeta``: the port's own copy of the request metadata
(``dragonfly2_tpu/proto/common.py``).

The reference daemon reads a request's metadata field by field (and
copies it with ``dataclasses.replace``), so the port's class has the same
fields and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

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

    def to_wire(self) -> dict[str, Any]:
        return {
            "digest": self.digest,
            "tag": self.tag,
            "range": self.range,
            "filter": self.filter,
            "header": self.header,
            "application": self.application,
            "priority": self.priority,
            "tenant": self.tenant,
        }

    @classmethod
    def from_wire(cls, d: dict[str, Any] | None) -> "UrlMeta":
        """The metadata of a request's wire body (``Daemon.Download``'s
        ``meta``); missing fields take their defaults."""
        d = d or {}
        return cls(
            digest=d.get("digest", ""),
            tag=d.get("tag", ""),
            range=d.get("range", ""),
            filter=d.get("filter", ""),
            header=d.get("header", {}) or {},
            application=d.get("application", ""),
            priority=d.get("priority", DEFAULT_PRIORITY),
            tenant=d.get("tenant", ""),
        )
