"""The scheduler-cluster searcher: the port's copy of
``dragonfly2_tpu/manager/searcher.py``.

A cluster scores by affinity to the requesting daemon: CIDR 0.3,
hostname regex 0.3, IDC (or TPU ``pod``) 0.3, location 0.08 (``|``
elements matched from the front, at most 5), and 0.01 for the default
cluster. Clusters with any scope match come first; with none, the
default clusters.
"""

from __future__ import annotations

import ipaddress
import re
from dataclasses import dataclass, field
from typing import Any

from dragonfly2_tpu_torch.pkg.types import AFFINITY_SEPARATOR

CONDITION_IDC = "idc"
CONDITION_LOCATION = "location"

_CIDR_AFFINITY_WEIGHT = 0.3
_HOSTNAME_AFFINITY_WEIGHT = 0.3
_IDC_AFFINITY_WEIGHT = 0.3
_LOCATION_AFFINITY_WEIGHT = 0.08
_CLUSTER_TYPE_WEIGHT = 0.01
_MAX_ELEMENT_LEN = 5


@dataclass
class SearchRequest:
    """Facts announced by the requesting daemon."""

    hostname: str = ""
    ip: str = ""
    idc: str = ""
    location: str = ""
    pod: str = ""          # TPU pod/slice name (extension)
    extra: dict[str, Any] = field(default_factory=dict)


def _idc_affinity(a: str, b: str) -> float:
    if not a or not b:
        return 0.0
    if a == b:
        return 1.0
    return 0.0


def _location_affinity(a: str, b: str) -> float:
    if not a or not b:
        return 0.0
    ea = a.split(AFFINITY_SEPARATOR)[:_MAX_ELEMENT_LEN]
    eb = b.split(AFFINITY_SEPARATOR)[:_MAX_ELEMENT_LEN]
    n = 0
    for x, y in zip(ea, eb):
        if x.lower() != y.lower():
            break
        n += 1
    return n / _MAX_ELEMENT_LEN


def _cidr_affinity(ip: str, cidrs: list[str]) -> float:
    if not ip or not cidrs:
        return 0.0
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return 0.0
    for cidr in cidrs:
        try:
            if addr in ipaddress.ip_network(cidr, strict=False):
                return 1.0
        except ValueError:
            continue
    return 0.0


def _hostname_affinity(hostname: str, regexes: list[str]) -> float:
    if not hostname or not regexes:
        return 0.0
    for pattern in regexes:
        try:
            if re.search(pattern, hostname):
                return 1.0
        except re.error:
            continue
    return 0.0


class Searcher:
    """The default cluster matcher."""

    def evaluate(self, req: SearchRequest, cluster: dict[str, Any]) -> float:
        scopes = cluster.get("scopes") or {}
        score = (
            _CIDR_AFFINITY_WEIGHT * _cidr_affinity(req.ip, scopes.get("cidrs") or [])
            + _HOSTNAME_AFFINITY_WEIGHT * _hostname_affinity(
                req.hostname, scopes.get("hostnames") or [])
            + _IDC_AFFINITY_WEIGHT * max(
                _idc_affinity(req.idc, scopes.get("idc", "")),
                _idc_affinity(req.pod, scopes.get("pod", "")))
            + _LOCATION_AFFINITY_WEIGHT * _location_affinity(
                req.location, scopes.get("location", ""))
        )
        if cluster.get("is_default"):
            score += _CLUSTER_TYPE_WEIGHT
        return score

    def find_scheduler_clusters(self, clusters: list[dict[str, Any]],
                                req: SearchRequest) -> list[dict[str, Any]]:
        """Rank candidate clusters by affinity, best first. Clusters with any
        scope match (score above the bare default bonus) come before the
        default cluster; with no match at all, fall back to defaults."""
        if not clusters:
            return []
        scored = sorted(clusters, key=lambda c: self.evaluate(req, c), reverse=True)
        matched = [c for c in scored if self.evaluate(req, c) > _CLUSTER_TYPE_WEIGHT]
        if matched:
            return matched
        return [c for c in scored if c.get("is_default")] or scored
