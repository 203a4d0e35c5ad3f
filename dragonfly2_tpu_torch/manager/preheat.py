"""Preheat argument expansion, image manifests to layer URLs: the port's
copy of ``dragonfly2_tpu/manager/preheat.py``.

A ``file`` preheat keeps its URL; an ``image`` preheat fetches the
registry manifest (a list or index picks the platform's manifest, or the
first) and preheats one blob URL a layer. The scope is the scheduler's
business (``scheduler/job.py``). The JAX package fetches with
``aiohttp``; here the fetch is ``http.client`` on a worker thread
(``_http_get_json``), off the manager's loop, following up to 10
redirects as ``aiohttp`` does.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import re
import ssl
import urllib.parse
from typing import Any

from dragonfly2_tpu_torch.pkg import dflog

log = dflog.get("manager.preheat")

# docker image URL: https://registry/v2/<name>/manifests/<tag>
_IMAGE_MANIFEST_RE = re.compile(r"^(?P<base>https?://[^/]+)/v2/(?P<name>.+)/manifests/(?P<tag>.+)$")

_MANIFEST_ACCEPT = ", ".join([
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.index.v1+json",
])

_MAX_REDIRECTS = 10
_TIMEOUT = 300.0


class ManifestFetchError(Exception):
    """A manifest GET answered with an error status."""


def _http_get_json(url: str, headers: dict[str, str]) -> Any:
    """GET ``url`` and decode its body as JSON (any content type)."""
    for _ in range(_MAX_REDIRECTS + 1):
        parts = urllib.parse.urlsplit(url)
        if parts.scheme == "https":
            conn = http.client.HTTPSConnection(
                parts.hostname, parts.port, timeout=_TIMEOUT,
                context=ssl.create_default_context())
        else:
            conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                              timeout=_TIMEOUT)
        try:
            path = parts.path or "/"
            if parts.query:
                path += "?" + parts.query
            conn.request("GET", path, headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status in (301, 302, 303, 307, 308) and \
                    resp.getheader("Location"):
                url = urllib.parse.urljoin(url, resp.getheader("Location"))
                continue
            if resp.status >= 400:
                raise ManifestFetchError(
                    f"{resp.status}, message={resp.reason!r}, url={url!r}")
            return json.loads(body.decode("utf-8"))
        finally:
            conn.close()
    raise ManifestFetchError(f"too many redirects: {url}")


async def get_image_layers(url: str, headers: dict[str, str] | None = None,
                           platform: str = "") -> list[str]:
    """Resolve a manifest URL into its layers' blob URLs."""
    m = _IMAGE_MANIFEST_RE.match(url)
    if not m:
        raise ValueError(f"not an image manifest URL: {url}")
    base, name = m.group("base"), m.group("name")
    req_headers = dict(headers or {})
    req_headers["Accept"] = _MANIFEST_ACCEPT
    manifest = await asyncio.to_thread(_http_get_json, url, req_headers)
    # A manifest list or index: the platform's manifest, or the first.
    if "manifests" in manifest:
        entry = manifest["manifests"][0]
        if platform:
            want_os, _, want_arch = platform.partition("/")
            for cand in manifest["manifests"]:
                p = cand.get("platform", {})
                if p.get("os") == want_os and p.get("architecture") == want_arch:
                    entry = cand
                    break
        digest = entry["digest"]
        manifest = await asyncio.to_thread(
            _http_get_json, f"{base}/v2/{name}/manifests/{digest}",
            req_headers)
    layers = manifest.get("layers", [])
    return [f"{base}/v2/{name}/blobs/{layer['digest']}" for layer in layers]


async def expand_preheat_args(args: dict[str, Any]) -> dict[str, Any]:
    """Normalise REST preheat args into {urls, tag, application, headers,
    filtered_query_params, scope, piece_length}."""
    out = dict(args)
    ptype = args.get("type", "file")
    if ptype == "image":
        layers = await get_image_layers(args["url"], args.get("headers"),
                                        args.get("platform", ""))
        out["urls"] = layers
        log.info("image preheat expanded", url=args["url"], layers=len(layers))
    else:
        out.setdefault("urls", [args["url"]] if args.get("url") else [])
    out.setdefault("scope", "single_seed_peer")
    return out
