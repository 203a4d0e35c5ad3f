"""Task and peer ids: the port's own copy of ``task_id_v1``,
``peer_id_v1`` and their helpers (``dragonfly2_tpu/pkg/idgen.py``).

A task id is a content address: sha256 over the filtered URL plus the
metadata that distinguishes one task from another. The daemon keys its
stores, its dedup and its device sinks by it, so the port's ids must be
byte-identical to the JAX package's: a client that protects a sink under
a different id protects nothing.
"""

from __future__ import annotations

import hashlib
import os
import uuid
from urllib.parse import parse_qsl, urlencode, urlsplit, urlunsplit

FILTERED_QUERY_PARAMS_SEPARATOR = "&"


def filter_query_params(url: str, filtered: list[str] | None) -> str:
    """The URL without the named query params, the rest sorted, so that
    param order never changes the task id."""
    if not filtered:
        filtered = []
    try:
        parts = urlsplit(url)
        pairs = parse_qsl(parts.query, keep_blank_values=True)
        kept = [(k, v) for k, v in pairs if k not in set(filtered)]
        kept.sort()
        return urlunsplit((parts.scheme, parts.netloc, parts.path,
                           urlencode(kept), ""))
    except ValueError:
        return ""


def parse_filtered_query_params(raw: str | None) -> list[str]:
    """Split an '&'-separated filter string."""
    if not raw or not raw.strip():
        return []
    return raw.split(FILTERED_QUERY_PARAMS_SEPARATOR)


def task_id_v1(url: str, *, digest: str = "", tag: str = "",
               application: str = "", filters: str = "",
               range_header: str = "", ignore_range: bool = False) -> str:
    """sha256 over the filtered URL, then digest, range, tag and
    application, each only when present."""
    data = [filter_query_params(url, parse_filtered_query_params(filters))]
    if digest:
        data.append(digest)
    if not ignore_range and range_header:
        data.append(range_header)
    if tag:
        data.append(tag)
    if application:
        data.append(application)
    h = hashlib.sha256()
    for v in data:
        h.update(v.encode("utf-8"))
    return h.hexdigest()


def parent_task_id_v1(url: str, **kwargs) -> str:
    """The task id without the range: the whole-content task a ranged
    request's slice belongs to."""
    kwargs["ignore_range"] = True
    return task_id_v1(url, **kwargs)


def peer_id_v1(ip: str) -> str:
    """``ip-pid-uuid``: one download attempt of one daemon."""
    return f"{ip}-{os.getpid()}-{uuid.uuid4()}"


def seed_peer_id_v1(ip: str) -> str:
    """A seed peer's id: ``peer_id_v1`` with the ``_Seed`` suffix the
    scheduler reads as the mark of a seed."""
    return f"{peer_id_v1(ip)}_Seed"


def host_id(hostname: str, port: int | None = None) -> str:
    """A host's id: the hostname, or hostname-port when several daemons
    share a host."""
    if port is None:
        return hostname
    return f"{hostname}-{port}"
