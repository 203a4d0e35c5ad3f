"""The port's manager REST API (``http.server`` threads) against the JAX
one (``aiohttp``), through one scripted session each.

Both ``RestServer`` objects serve on one event loop over loopback; a raw
``http.client`` client (on a worker thread) sends each the same requests:
signin and signup, personal access tokens, roles and grants, cluster
CRUD, a linked seed-peer cluster, job create, list and get (a file
preheat and an image preheat expanded from a stand-in registry), one
tenant-admission 429, one job-rate 429, the OAuth flow against a
stand-in provider (as ``tests/test_manager_auth_console.py`` runs it),
the console, 401, 403, 404 and 405, malformed bodies, ``HEAD``. Each
answer's status, its ``Content-Type``, ``Retry-After`` and ``Allow``
headers and its body must be equal, and after the session every table's
rows, with only these fields masked by name: row times, the job's group
uuid, tokens and their expiry, password hashes, ``/healthy``'s ``ts``
and the OAuth ``state`` (all random or clock-made by design), and
``/metrics``'s body (each package serves its own registry).
"""

from __future__ import annotations

import asyncio
import http.client
import json
import re

from aiohttp import web

from dragonfly2_tpu.manager import auth as jauth
from dragonfly2_tpu.manager.rest import RestServer as JRestServer
from dragonfly2_tpu.manager.service import ManagerService as JService
from dragonfly2_tpu_torch.manager import auth as pauth
from dragonfly2_tpu_torch.manager.rest import RestServer as PRestServer
from dragonfly2_tpu_torch.manager.service import ManagerService as PService

from tests.test_torch_manager import mask

SECRET = b"manager-rest-parity-secret-32-by"
TABLES = ("scheduler_clusters", "schedulers", "seed_peer_clusters",
          "scheduler_cluster_seed_peer_cluster", "seed_peers", "peers",
          "users", "user_roles", "applications", "configs",
          "personal_access_tokens", "oauth", "jobs", "buckets",
          "rbac_policies")


def _request(port: int, method: str, path: str, body=None, token="",
             raw: bytes | None = None) -> dict:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    headers = {}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    if data is not None:
        headers["Content-Type"] = "application/json"
    try:
        c.request(method, path, body=data, headers=headers)
        r = c.getresponse()
        payload = r.read()
        out = {"status": r.status,
               "type": r.getheader("Content-Type"),
               "retry_after": r.getheader("Retry-After"),
               "allow": r.getheader("Allow")}
        try:
            out["body"] = json.loads(payload) if payload else None
        except ValueError:
            out["body"] = payload.decode()
        return out
    finally:
        c.close()


async def _start_provider():
    """The stand-in OAuth provider of test_manager_auth_console."""
    codes = {"good-code": {"id": 4242, "email": "a@b.c"}}

    async def token_ep(request: web.Request) -> web.Response:
        form = await request.post()
        if form["code"] in codes and form["client_secret"] == "s3cr3t":
            return web.json_response({"access_token": "at-xyz"})
        return web.json_response({}, status=400)

    async def userinfo_ep(request: web.Request) -> web.Response:
        if request.headers.get("Authorization") == "Bearer at-xyz":
            return web.json_response(codes["good-code"])
        return web.json_response({}, status=401)

    app = web.Application()
    app.router.add_post("/token", token_ep)
    app.router.add_get("/userinfo", userinfo_ep)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, site._server.sockets[0].getsockname()[1]


async def _start_registry():
    """A registry with a manifest list (two platforms) and its manifests."""
    index = {"manifests": [
        {"digest": "sha256:amd", "platform": {"os": "linux",
                                              "architecture": "amd64"}},
        {"digest": "sha256:arm", "platform": {"os": "linux",
                                              "architecture": "arm64"}}]}
    manifests = {d: {"layers": [{"digest": f"{d}-l{i}"} for i in range(n)]}
                 for d, n in (("sha256:amd", 2), ("sha256:arm", 3))}

    async def manifest(request: web.Request) -> web.Response:
        ref = request.match_info["ref"]
        if ref == "latest":
            return web.json_response(index)
        if ref in manifests:
            return web.json_response(manifests[ref])
        return web.json_response({}, status=404)

    app = web.Application()
    app.router.add_get("/v2/lib/app/manifests/{ref}", manifest)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, site._server.sockets[0].getsockname()[1]


async def _session(port: int, svc, provider: int, registry: int) -> list:
    """One scripted session; each answer as ``_request`` gives it."""
    out = []

    async def call(method, path, body=None, token="", raw=None):
        r = await asyncio.to_thread(_request, port, method, path, body,
                                    token, raw)
        out.append({"req": f"{method} {path}", **r})
        return r

    # Public routes, and the 401s around them.
    await call("GET", "/healthy")
    await call("HEAD", "/healthy")
    r = await call("GET", "/metrics")
    r["body"] = "<metrics>"
    out[-1]["body"] = "<metrics>"
    await call("GET", "/")
    await call("GET", "/api/v1/schedulers")
    await call("GET", "/api/v1/schedulers", token="bogus")
    await call("GET", "/nowhere")
    # Sign in, sign up, bad bodies.
    root = (await call("POST", "/api/v1/users/signin",
                       {"name": "root", "password": "dragonfly"}))["body"][
        "token"]
    await call("POST", "/api/v1/users/signin",
               {"name": "root", "password": "nope"})
    await call("POST", "/api/v1/users/signin", {"name": "root"})
    await call("POST", "/api/v1/users/signin", raw=b"{not json")
    await call("POST", "/api/v1/users/signin", raw=b"")
    guest = await call("POST", "/api/v1/users/signup",
                       {"name": "gus", "password": "pw", "email": "g@x"})
    gid = guest["body"]["id"]
    await call("POST", "/api/v1/users/signup", {"name": "gus",
                                                 "password": "pw"})
    gtok = (await call("POST", "/api/v1/users/signin",
                       {"name": "gus", "password": "pw"}))["body"]["token"]
    # Routing after the middleware: 404, 405 with Allow, HEAD.
    await call("GET", "/nowhere", token=root)
    await call("PUT", "/healthy", token=root)
    await call("PUT", "/api/v1/jobs", token=root)
    await call("HEAD", "/api/v1/jobs", token=root)
    await call("GET", f"/api/v1/users/{gid}", token=root)
    await call("GET", "/api/v1/users/99", token=root)
    await call("GET", "/api/v1/users/abc", token=root)
    await call("GET", f"/api/v1/users/{gid}/roles", token=gtok)
    # The guest reads but does not write; resets its own password only.
    await call("GET", "/api/v1/scheduler-clusters", token=gtok)
    await call("POST", "/api/v1/scheduler-clusters", {"name": "g"},
               token=gtok)
    await call("POST", f"/api/v1/users/{gid}/reset_password",
               {"new_password": "pw2"}, token=gtok)
    await call("POST", "/api/v1/users/1/reset_password",
               {"new_password": "x"}, token=gtok)
    gtok = (await call("POST", "/api/v1/users/signin",
                       {"name": "gus", "password": "pw2"}))["body"]["token"]
    # Roles and policies.
    await call("GET", "/api/v1/roles", token=root)
    await call("POST", "/api/v1/roles", {"role": "job-op", "object": "jobs",
                                         "action": "*"}, token=root)
    await call("POST", "/api/v1/roles", {"role": "bad", "object": "jobs",
                                         "action": "write"}, token=root)
    await call("POST", "/api/v1/roles", {"role": "x", "object": "jobs"},
               token=gtok)
    await call("GET", "/api/v1/roles/job-op", token=root)
    await call("PUT", f"/api/v1/users/{gid}/roles/job-op", token=root)
    await call("GET", "/api/v1/permissions", token=root)
    gtok = (await call("POST", "/api/v1/users/signin",
                       {"name": "gus", "password": "pw2"}))["body"]["token"]
    await call("POST", "/api/v1/jobs", {"type": "sync_peers"}, token=gtok)
    await call("DELETE", f"/api/v1/users/{gid}/roles/job-op", token=root)
    await call("DELETE", "/api/v1/roles/job-op",
               {"object": "jobs", "action": "*"}, token=root)
    # Personal access tokens: shown once, then redacted.
    pat = await call("POST", "/api/v1/personal-access-tokens",
                     {"name": "ci", "bio": "b", "scopes": ["jobs"]},
                     token=root)
    pat_token = pat["body"]["token"]
    await call("GET", "/api/v1/personal-access-tokens", token=root)
    await call("GET", "/api/v1/personal-access-tokens", token=gtok)
    await call("GET", "/api/v1/scheduler-clusters/1", token=pat_token)
    await call("DELETE", f"/api/v1/personal-access-tokens/"
               f"{pat['body']['id']}", token=root)
    await call("GET", "/api/v1/scheduler-clusters/1", token=pat_token)
    # Cluster CRUD and the seed-peer link.
    await call("POST", "/api/v1/scheduler-clusters",
               {"name": "c2", "bio": "b", "config": {"k": 1},
                "scopes": {"idc": "i"}, "ignored": 1}, token=root)
    await call("POST", "/api/v1/scheduler-clusters", {"name": "c2"},
               token=root)
    await call("PATCH", "/api/v1/scheduler-clusters/2",
               {"bio": "b2", "config": {"k": 2}}, token=root)
    await call("PATCH", "/api/v1/scheduler-clusters/9", {"bio": "x"},
               token=root)
    await call("POST", "/api/v1/seed-peer-clusters", {"name": "sp2"},
               token=root)
    await call("PUT", "/api/v1/scheduler-clusters/2/seed-peer-clusters/2",
               token=root)
    await call("POST", "/api/v1/seed-peers",
               {"hostname": "sp", "ip": "1.2.3.4", "port": 65000,
                "seed_peer_cluster_id": 2}, token=root)
    await call("GET", "/api/v1/seed-peers?hostname=sp", token=root)
    await call("GET", "/api/v1/scheduler-clusters?page=2&per_page=1",
               token=root)
    await call("POST", "/api/v1/peers", {"hostname": "p"}, token=root)
    await call("GET", "/api/v1/peers", token=root)
    await call("DELETE", "/api/v1/seed-peers/1", token=root)
    await call("DELETE", "/api/v1/seed-peers/1", token=root)
    await call("POST", "/api/v1/oauth",
               {"name": "fakehub", "client_id": "cid",
                "client_secret": "s3cr3t", "redirect_url":
                "http://localhost/cb",
                "auth_url": f"http://127.0.0.1:{provider}/authorize",
                "token_url": f"http://127.0.0.1:{provider}/token",
                "user_info_url": f"http://127.0.0.1:{provider}/userinfo"},
               token=root)
    await call("GET", "/api/v1/oauth", token=root)
    # Jobs.
    await call("POST", "/api/v1/jobs", {"type": "nope"}, token=root)
    await call("POST", "/api/v1/jobs", {"type": "preheat",
                                        "scheduler_cluster_ids": ["x"]},
               token=root)
    await call("POST", "/api/v1/jobs", {"type": "preheat",
                                        "scheduler_cluster_ids": [98]},
               token=root)
    await call("POST", "/api/v1/jobs",
               {"type": "preheat", "bio": "f",
                "args": {"type": "file", "url": "http://o/blob",
                         "device": "tpu", "ranges": ["0-9"]}}, token=root)
    await call("POST", "/api/v1/jobs",
               {"type": "preheat", "scheduler_cluster_ids": [1],
                "args": {"type": "image", "platform": "linux/arm64",
                         "url": f"http://127.0.0.1:{registry}/v2/lib/app/"
                                f"manifests/latest"}}, token=root)
    await call("POST", "/api/v1/jobs",
               {"type": "preheat", "scheduler_cluster_ids": [1],
                "args": {"type": "image",
                         "url": "http://127.0.0.1:1/not-a-manifest"}},
               token=root)
    await call("GET", "/api/v1/jobs", token=root)
    await call("GET", "/api/v1/jobs?state=PENDING", token=root)
    await call("GET", "/api/v1/jobs/1", token=root)
    await call("GET", "/api/v1/jobs/99", token=root)
    # One admission 429: a tenant whose burn is in breach.
    svc.ingest_tenant_burn({"hot": {"burn": 4.0, "state": "breach"}})
    await call("POST", "/api/v1/jobs",
               {"type": "sync_peers", "tenant": "hot"}, token=root)
    # One job-rate 429: the cluster's bucket retuned to 1/s.
    await call("PATCH", "/api/v1/scheduler-clusters/1",
               {"config": {"job_rate_limit": 1}}, token=root)
    await call("POST", "/api/v1/jobs",
               {"type": "sync_peers", "scheduler_cluster_ids": [1]},
               token=root)
    await call("POST", "/api/v1/jobs",
               {"type": "sync_peers", "scheduler_cluster_ids": [1]},
               token=root)
    # OAuth: the redirect, a bad state, the code exchange, unknown names.
    r = await call("GET", "/api/v1/users/signin/oauth/fakehub")
    state = re.search(r"state=([^&]+)", r["body"]["redirect_url"]).group(1)
    out[-1]["body"]["redirect_url"] = r["body"]["redirect_url"].replace(
        state, "<state>")
    await call("GET", "/api/v1/users/signin/oauth/nohub")
    await call("GET", "/api/v1/oauth/fakehub/callback?code=good-code"
               "&state=wrong")
    otok = (await call("GET", f"/api/v1/oauth/fakehub/callback?"
                       f"code=good-code&state={state}"))["body"]["token"]
    out[-1]["req"] = out[-1]["req"].replace(state, "<state>")
    await call("GET", "/api/v1/scheduler-clusters", token=otok)
    await call("POST", "/api/v1/scheduler-clusters", {"name": "o"},
               token=otok)
    await call("GET", "/api/v1/oauth/1", token=root)
    return out


async def _run_one(kind: str, provider: int, registry: int):
    if kind == "jax":
        svc = JService()
        svc.signer = jauth.TokenSigner(SECRET)
        rest = JRestServer(svc)
    else:
        svc = PService()
        svc.signer = pauth.TokenSigner(SECRET)
        rest = PRestServer(svc)
    port = await rest.serve("127.0.0.1", 0)
    try:
        answers = await _session(port, svc, provider, registry)
        rows = {t: [dict(r) for r in svc.db.execute(f"SELECT * FROM {t}")]
                for t in TABLES}
        return answers, rows
    finally:
        await rest.close()


def test_one_scripted_session_answers_as_the_jax_manager(run_async):
    async def body():
        prov, pport = await _start_provider()
        reg, rport = await _start_registry()
        try:
            return (await _run_one("jax", pport, rport),
                    await _run_one("port", pport, rport))
        finally:
            await prov.cleanup()
            await reg.cleanup()

    (ja, jrows), (pa, prows) = run_async(body(), timeout=120)
    assert len(ja) == len(pa)
    for j, p in zip(ja, pa):
        assert mask(j) == mask(p), j["req"]
    for table in TABLES:
        assert mask(jrows[table]) == mask(prows[table]), table
    # The session reached what it set out to: two 429s with Retry-After,
    # an image preheat expanded to the arm64 layers, an OAuth user.
    codes = [a["status"] for a in pa]
    assert codes.count(429) == 2 and {405, 404, 403, 401, 500} <= set(codes)
    assert all(a["retry_after"] for a in pa if a["status"] == 429)
    image = [a for a in pa if a["req"] == "POST /api/v1/jobs"
             and a["status"] == 200 and a["body"]["args"].get("type")
             == "image"]
    assert image[0]["body"]["args"]["urls"] == [
        f"http://127.0.0.1:{image[0]['body']['args']['url'].split(':')[2].split('/')[0]}"
        f"/v2/lib/app/blobs/sha256:arm-l{i}" for i in range(3)]
    assert any(r["name"] == "oauth-fakehub-4242" for r in prows["users"])


def test_the_port_routes_are_the_jax_routes():
    """Every route of the JAX application, by method and path, and no
    other (``aiohttp`` adds HEAD to each GET; so does the port)."""
    japp = JRestServer(JService()).build_app()
    jroutes = {(r.method, r.resource.canonical)
               for r in japp.router.routes() if r.method != "HEAD"}
    proutes = set()
    for method, pattern in PRestServer(PService()).routes():
        path = re.sub(r"\(\?P<(\w+)>\[\^\{\}/\]\+\)", r"{\1}",
                      pattern[1:-1]).replace("\\", "")
        proutes.add((method, path))
    assert proutes == jroutes
    assert len(jroutes) == 67
