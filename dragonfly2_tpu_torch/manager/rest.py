"""The manager's REST API: the port's copy of
``dragonfly2_tpu/manager/rest.py`` on ``http.server``
(``pkg/httpserver.ThreadedServer``; the JAX API is an ``aiohttp``
application, and the card machine has no ``aiohttp``).

Routes, status codes, JSON bodies, the bearer-token middleware (session
tokens or personal access tokens, then the RBAC check), the tenant
admission 429 and the job-rate 429 with ``Retry-After`` are the JAX
API's, and so are the answers ``aiohttp`` gives around them: 404 and
405 (with ``Allow``) after the middleware, a 500 for an unexpected
error, and ``GET`` routes that answer ``HEAD``. ``/metrics`` serves the
port's own registry (``pkg/metrics.render``).

Threads: one ``df-manager-rest`` thread a connection reads the request
and writes the answer; the handler itself runs on the manager's event
loop (``asyncio.run_coroutine_threadsafe``), since the job queue's
``asyncio.Queue`` objects and the service belong to that loop
(``manager/jobqueue.py``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any
from urllib.parse import parse_qsl, unquote, urlsplit

from dragonfly2_tpu_torch.manager import auth, jobqueue
from dragonfly2_tpu_torch.manager.console import INDEX_HTML
from dragonfly2_tpu_torch.manager.oauth import OAuthFlow
from dragonfly2_tpu_torch.manager.preheat import expand_preheat_args
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.pkg import dflog, metrics
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.httpserver import ThreadedServer

log = dflog.get("manager.rest")

_PUBLIC = {("POST", "/api/v1/users/signin"), ("POST", "/api/v1/users/signup"),
           ("GET", "/healthy"), ("GET", "/metrics"), ("GET", "/")}


def _is_public_oauth_path(path: str) -> bool:
    """Only the two oauth redirect legs are tokenless: the signin-redirect
    builder and the provider callback."""
    return (path.startswith("/api/v1/users/signin/oauth/")
            or (path.startswith("/api/v1/oauth/")
                and path.endswith("/callback")))


# table -> mutable columns accepted from the API
_RESOURCES: dict[str, set[str]] = {
    "scheduler-clusters": {"name", "bio", "config", "client_config", "scopes",
                           "is_default"},
    "seed-peer-clusters": {"name", "bio", "config"},
    "schedulers": {"hostname", "idc", "location", "ip", "port", "state",
                   "features", "scheduler_cluster_id"},
    "seed-peers": {"hostname", "type", "idc", "location", "ip", "port",
                   "download_port", "object_storage_port", "state",
                   "seed_peer_cluster_id"},
    "peers": set(),  # read/delete only; rows come from sync-peers jobs
    "applications": {"name", "url", "bio", "priority", "user_id"},
    "configs": {"name", "value", "bio", "user_id"},
    "oauth": {"name", "bio", "client_id", "client_secret", "redirect_url",
              "auth_url", "token_url", "user_info_url", "scopes"},
    "buckets": {"name"},
}
_TABLE_OF = {r: r.replace("-", "_") for r in _RESOURCES}

_JSON_TYPE = "application/json; charset=utf-8"
_TEXT_TYPE = "text/plain; charset=utf-8"


class Response:
    """An answer: status, body bytes, content type and extra headers."""

    def __init__(self, status: int, body: bytes, content_type: str,
                 headers: dict[str, str] | None = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


def json_response(data: Any, status: int = 200,
                  headers: dict[str, str] | None = None) -> Response:
    """``aiohttp.web.json_response``'s bytes: ``json.dumps`` defaults."""
    return Response(status, json.dumps(data).encode(), _JSON_TYPE, headers)


def _text_response(status: int, text: str,
                   headers: dict[str, str] | None = None) -> Response:
    return Response(status, text.encode(), _TEXT_TYPE, headers)


class _HTTPError(Exception):
    """A 404 or 405 from the router, raised through the middleware."""

    def __init__(self, response: Response):
        self.response = response


class Request:
    """What a handler reads: method, decoded path, query (the first value
    of each key), headers, body, the route's parameters and, once the
    middleware has passed it, the caller's ``identity``."""

    def __init__(self, method: str, path: str, query: dict[str, str],
                 headers, body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.match_info: dict[str, str] = {}
        self.identity: dict | None = None

    async def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))


def json_error(e: Exception) -> Response:
    if isinstance(e, DfError):
        status = {Code.NotFound: 404, Code.Unauthorized: 401,
                  Code.InvalidArgument: 400}.get(e.code, 500)
        return json_response({"message": e.message}, status=status)
    return json_response({"message": str(e)}, status=500)


def _redact(table: str, row: dict[str, Any]) -> dict[str, Any]:
    """Secrets never leave through reads (tokens show once, at creation;
    oauth client secrets are write-only)."""
    if table == "oauth" and row.get("client_secret"):
        row = dict(row)
        row["client_secret"] = "***"
    if table == "personal_access_tokens" and row.get("token"):
        row = dict(row)
        row["token"] = "***"
    return row


def _pattern(path: str) -> re.Pattern:
    """A route path with ``{name}`` parameters, as ``aiohttp`` matches
    them (one segment each)."""
    out, pos = "", 0
    for m in re.finditer(r"\{(\w+)\}", path):
        out += re.escape(path[pos:m.start()]) + f"(?P<{m.group(1)}>[^{{}}/]+)"
        pos = m.end()
    return re.compile("^" + out + re.escape(path[pos:]) + "$")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, *args):
        pass

    def _body(self) -> bytes:
        if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            out = bytearray()
            while True:
                size = int(self.rfile.readline().split(b";")[0], 16)
                if size == 0:
                    while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                        pass
                    return bytes(out)
                out += self.rfile.read(size)
                self.rfile.readline()
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _dispatch(self):
        rest = self.server.rest
        parts = urlsplit(self.path)
        query: dict[str, str] = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            query.setdefault(k, v)
        request = Request(self.command, unquote(parts.path), query,
                          self.headers, self._body())
        try:
            resp = rest._call(rest.handle(request))
        except concurrent.futures.CancelledError:
            self.close_connection = True   # the server is closing
            return
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        for k, v in resp.headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(resp.body)))
        self.end_headers()
        if self.command != "HEAD" and resp.body:
            self.wfile.write(resp.body)

    do_GET = do_HEAD = do_POST = do_PUT = do_PATCH = do_DELETE = _dispatch
    do_OPTIONS = _dispatch


class RestServer:
    def __init__(self, service: ManagerService):
        self.service = service
        self._oauth_flow = OAuthFlow(service)
        self._routes: list[tuple[str, re.Pattern, Any]] = []
        self._build_routes()
        self._server: ThreadedServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._port = 0
        self._mu = threading.Lock()
        self._closing = False
        self._pending: set[concurrent.futures.Future] = set()

    def _add(self, method: str, path: str, handler) -> None:
        pattern = _pattern(path)
        self._routes.append((method, pattern, handler))
        if method == "GET":
            self._routes.append(("HEAD", pattern, handler))

    def _build_routes(self) -> None:
        add = self._add
        add("GET", "/healthy", self._healthy)
        add("GET", "/metrics", self._metrics)
        add("GET", "/", self._console)
        add("POST", "/api/v1/users/signin", self._signin)
        add("POST", "/api/v1/users/signup", self._signup)
        add("GET", "/api/v1/users/signin/oauth/{name}", self._oauth_signin)
        add("GET", "/api/v1/oauth/{name}/callback", self._oauth_callback)
        add("GET", "/api/v1/users/{id}", self._get_user)
        add("POST", "/api/v1/users/{id}/reset_password", self._reset_password)
        add("GET", "/api/v1/users/{id}/roles", self._get_roles)
        add("POST", "/api/v1/personal-access-tokens", self._create_pat)
        add("GET", "/api/v1/personal-access-tokens", self._list_pats)
        add("DELETE", "/api/v1/personal-access-tokens/{id}", self._delete_pat)
        # RBAC management: roles, per-role policies, user grants.
        add("GET", "/api/v1/roles", self._list_roles)
        add("GET", "/api/v1/roles/{role}", self._get_role_policies)
        add("POST", "/api/v1/roles", self._create_role_policy)
        add("DELETE", "/api/v1/roles/{role}", self._delete_role_policy)
        add("PUT", "/api/v1/users/{id}/roles/{role}", self._grant_role)
        add("DELETE", "/api/v1/users/{id}/roles/{role}", self._revoke_role)
        add("GET", "/api/v1/permissions", self._list_permissions)
        add("POST", "/api/v1/jobs", self._create_job)
        add("GET", "/api/v1/jobs", self._list_jobs)
        add("GET", "/api/v1/jobs/{id}", self._get_job)
        for res in _RESOURCES:
            if _RESOURCES[res]:  # no mutable columns -> read/delete only
                add("POST", f"/api/v1/{res}", self._create(res))
                add("PATCH", f"/api/v1/{res}/{{id}}", self._patch(res))
            add("GET", f"/api/v1/{res}", self._list(res))
            add("GET", f"/api/v1/{res}/{{id}}", self._get(res))
            add("DELETE", f"/api/v1/{res}/{{id}}", self._delete(res))
        add("PUT", "/api/v1/scheduler-clusters/{id}/seed-peer-clusters/{spc_id}",
            self._link_clusters)

    def routes(self) -> list[tuple[str, str]]:
        """(method, path pattern) of every route but the implied HEADs."""
        return [(m, p.pattern) for m, p, _ in self._routes if m != "HEAD"]

    async def serve(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._loop = asyncio.get_running_loop()
        self._server = ThreadedServer((host, port), _Handler, "manager-rest")
        self._server.rest = self
        self._port = self._server.start()
        log.info("manager REST up", port=self._port)
        return self._port

    @property
    def port(self) -> int:
        return self._port

    async def close(self) -> None:
        server, self._server = self._server, None
        if server is None:
            return
        with self._mu:
            self._closing = True
            pending = list(self._pending)
        for fut in pending:
            fut.cancel()
        await asyncio.to_thread(server.close)

    def _call(self, coro):
        """Run ``coro`` on the manager's loop and wait for its result (from
        a handler thread). Raises ``CancelledError`` once closing."""
        with self._mu:
            if self._closing:
                coro.close()
                raise concurrent.futures.CancelledError()
            fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
            self._pending.add(fut)
        try:
            return fut.result()
        finally:
            with self._mu:
                self._pending.discard(fut)

    # -- routing and the middleware ----------------------------------------

    async def _route(self, request: Request) -> Response:
        allowed = set()
        for method, pattern, handler in self._routes:
            m = pattern.match(request.path)
            if m is None:
                continue
            if method == request.method:
                request.match_info = m.groupdict()
                return await handler(request)
            allowed.add(method)
        if allowed:
            raise _HTTPError(_text_response(
                405, "405: Method Not Allowed",
                {"Allow": ",".join(sorted(allowed))}))
        raise _HTTPError(_text_response(404, "404: Not Found"))

    async def handle(self, request: Request) -> Response:
        try:
            return await self._auth_middleware(request)
        except _HTTPError as e:
            return e.response
        except Exception:
            log.error("manager REST handler failed", path=request.path,
                      exc_info=True)
            return _text_response(
                500, "500 Internal Server Error\n\nServer got itself in "
                     "trouble")

    async def _auth_middleware(self, request: Request) -> Response:
        try:
            if ((request.method, request.path) in _PUBLIC
                    or (request.method == "GET"
                        and _is_public_oauth_path(request.path))):
                return await self._route(request)
            token = request.headers.get("Authorization", "")
            if token.startswith("Bearer "):
                token = token[7:]
            identity = self.service.verify_token(token) if token else None
            if identity is None:
                return json_response({"message": "unauthorized"}, status=401)
            if not self.service.rbac.enforce_request(
                    identity.get("roles", []), request.method, request.path):
                # A user may always change their own password (the
                # handler checks root-or-self again).
                if not (request.method == "POST"
                        and request.path ==
                        f"/api/v1/users/{identity.get('uid')}/reset_password"):
                    return json_response({"message": "forbidden"}, status=403)
            request.identity = identity
            return await self._route(request)
        except _HTTPError:
            raise
        except (DfError, KeyError, ValueError, TypeError) as e:
            # Malformed bodies and missing fields are client errors.
            if isinstance(e, DfError):
                return json_error(e)
            return json_response({"message": str(e)}, status=400)

    # -- console -----------------------------------------------------------

    async def _console(self, request: Request) -> Response:
        return Response(200, INDEX_HTML.encode(), "text/html; charset=utf-8")

    # -- auth endpoints ----------------------------------------------------

    async def _oauth_signin(self, request: Request) -> Response:
        try:
            url = self._oauth_flow.authorize_url(request.match_info["name"])
        except DfError as e:
            return json_error(e)
        return json_response({"redirect_url": url})

    async def _oauth_callback(self, request: Request) -> Response:
        try:
            token = await self._oauth_flow.exchange(
                request.match_info["name"],
                request.query.get("code", ""),
                request.query.get("state", ""))
        except DfError as e:
            return json_error(e)
        return json_response({"token": token})

    async def _signin(self, request: Request) -> Response:
        body = await request.json()
        try:
            token = self.service.signin(body["name"], body["password"])
        except DfError as e:
            return json_error(e)
        return json_response({"token": token})

    async def _signup(self, request: Request) -> Response:
        body = await request.json()
        try:
            user = self.service.signup(body["name"], body["password"],
                                       body.get("email", ""))
        except DfError as e:
            return json_error(e)
        return json_response(user)

    async def _get_user(self, request: Request) -> Response:
        user = self.service.db.get("users", int(request.match_info["id"]))
        if not user:
            return json_response({"message": "not found"}, status=404)
        return json_response(self.service._public_user(user))

    async def _get_roles(self, request: Request) -> Response:
        return json_response(
            {"roles": self.service.roles_of(int(request.match_info["id"]))})

    async def _reset_password(self, request: Request) -> Response:
        # Root or self only: a scoped grant on "users" must not reset
        # root's password.
        target = int(request.match_info["id"])
        identity = request.identity
        if (auth.ROLE_ROOT not in identity.get("roles", [])
                and identity.get("uid") != target):
            return json_response(
                {"message": "root or self required"}, status=403)
        body = await request.json()
        self.service.reset_password(target, body["new_password"])
        return json_response({})

    # -- RBAC endpoints ----------------------------------------------------

    @staticmethod
    def _require_root(request: Request) -> Response | None:
        """Role and policy changes are root's alone: a role with write
        access to "users" or "roles" must not grant itself root."""
        if auth.ROLE_ROOT not in request.identity.get("roles", []):
            return json_response({"message": "root required"}, status=403)
        return None

    async def _list_roles(self, request: Request) -> Response:
        return json_response({"roles": self.service.rbac.roles()})

    async def _get_role_policies(self, request: Request) -> Response:
        role = request.match_info["role"]
        return json_response(
            {"role": role, "policies": self.service.rbac.policies(role)})

    async def _create_role_policy(self, request: Request) -> Response:
        if (deny := self._require_root(request)) is not None:
            return deny
        body = await request.json()
        self.service.rbac.add_policy(body["role"], body["object"],
                                     body.get("action", "read"))
        return json_response({"ok": True})

    async def _delete_role_policy(self, request: Request) -> Response:
        if (deny := self._require_root(request)) is not None:
            return deny
        role = request.match_info["role"]
        body = await request.json()
        self.service.rbac.remove_policy(role, body["object"],
                                        body.get("action", "read"))
        return json_response({"ok": True})

    async def _grant_role(self, request: Request) -> Response:
        if (deny := self._require_root(request)) is not None:
            return deny
        self.service.grant_role(int(request.match_info["id"]),
                                request.match_info["role"])
        return json_response({"ok": True})

    async def _revoke_role(self, request: Request) -> Response:
        if (deny := self._require_root(request)) is not None:
            return deny
        self.service.revoke_role(int(request.match_info["id"]),
                                 request.match_info["role"])
        return json_response({"ok": True})

    async def _list_permissions(self, request: Request) -> Response:
        """The resource groups a policy can name."""
        objects = sorted(_RESOURCES) + ["jobs", "users", "roles",
                                        "personal-access-tokens", "*"]
        return json_response({"objects": objects, "actions": ["read", "*"]})

    async def _create_pat(self, request: Request) -> Response:
        body = await request.json()
        token = auth.new_personal_access_token()
        row = self.service.db.insert("personal_access_tokens", {
            "name": body["name"], "token": token,
            "bio": body.get("bio", ""), "scopes": body.get("scopes", []),
            "expired_at": body.get("expired_at", 0),
            "user_id": request.identity["uid"],
        })
        return json_response(row)

    async def _list_pats(self, request: Request) -> Response:
        ident = request.identity
        rows = self.service.db.list("personal_access_tokens")
        if auth.ROLE_ROOT not in ident.get("roles", []):
            rows = [r for r in rows if r["user_id"] == ident["uid"]]
        # The secret is shown once, at creation.
        for r in rows:
            r["token"] = "***"
        return json_response(rows)

    async def _delete_pat(self, request: Request) -> Response:
        self.service.db.delete("personal_access_tokens",
                               int(request.match_info["id"]))
        return json_response({})

    # -- jobs --------------------------------------------------------------

    async def _create_job(self, request: Request) -> Response:
        """POST /api/v1/jobs {type: preheat|sync_peers|get_task|delete_task,
        args: {...}, scheduler_cluster_ids: [...]}."""
        body = await request.json()
        job_type = body.get("type")
        if job_type not in (jobqueue.PREHEAT_JOB, jobqueue.SYNC_PEERS_JOB,
                            jobqueue.GET_TASK_JOB, jobqueue.DELETE_TASK_JOB):
            return json_response({"message": f"unknown job type {job_type}"},
                                 status=400)
        args = body.get("args", {})
        cluster_ids = body.get("scheduler_cluster_ids") or [
            c["id"] for c in self.service.db.list("scheduler_clusters")]
        try:
            # "3" and 3 alike; a malformed entry is the client's error.
            cluster_ids = [int(cid) for cid in cluster_ids]
        except (TypeError, ValueError):
            return json_response(
                {"message": f"malformed scheduler_cluster_ids: "
                            f"{body.get('scheduler_cluster_ids')!r}"},
                status=400)
        # Tenant burn-rate admission, before the job buckets are debited:
        # a breaching tenant's surge queues at the client. No or stale
        # burn data admits.
        tenant = str(body.get("tenant") or args.get("tenant") or "")
        admitted, qos_retry_after, detail = self.service.check_admission(tenant)
        if not admitted:
            self.service.note_admission_429(detail.get("tenant", tenant))
            return json_response(
                {"message": "tenant over burn-rate budget",
                 "tenant": detail.get("tenant", tenant),
                 "burn": detail.get("burn", 0.0),
                 "retry_after_s": round(qos_retry_after, 3)},
                status=429,
                headers={"Retry-After":
                         str(max(1, math.ceil(qos_retry_after)))})
        # The per-cluster job rate, before the preheat expansion (an image
        # preheat fetches manifests; a limited client must not amplify
        # into outbound fetches). Retry-After in whole seconds; the
        # precise wait rides the body.
        granted, retry_after = self.service.take_job_tokens(cluster_ids)
        if not granted:
            self.service.note_admission_429(tenant)
            return json_response(
                {"message": "rate limit exceeded",
                 "retry_after_s": round(retry_after, 3)},
                status=429,
                headers={"Retry-After": str(max(1, math.ceil(retry_after)))})
        if job_type == jobqueue.PREHEAT_JOB:
            args = await expand_preheat_args(args)
        job = self.service.jobs.enqueue_job(
            job_type, args, cluster_ids,
            user_id=request.identity["uid"], bio=body.get("bio", ""))
        return json_response(job)

    async def _list_jobs(self, request: Request) -> Response:
        where: dict[str, Any] = {}
        if "state" in request.query:
            where["state"] = request.query["state"]
        return json_response(self.service.db.list("jobs", **where))

    async def _get_job(self, request: Request) -> Response:
        job = self.service.db.get("jobs", int(request.match_info["id"]))
        if not job:
            return json_response({"message": "not found"}, status=404)
        return json_response(job)

    # -- generic resource CRUD --------------------------------------------

    def _create(self, res: str):
        table, cols = _TABLE_OF[res], _RESOURCES[res]

        async def handler(request: Request) -> Response:
            body = await request.json()
            values = {k: v for k, v in body.items() if k in cols}
            return json_response(self.service.db.insert(table, values))
        return handler

    def _list(self, res: str):
        table = _TABLE_OF[res]

        async def handler(request: Request) -> Response:
            q = request.query
            where = {k: q[k] for k in ("state", "name", "hostname", "ip")
                     if k in q}
            page = int(q.get("page", 0))
            per_page = int(q.get("per_page", 0))
            rows = self.service.db.list(
                table, limit=per_page, offset=max(page - 1, 0) * per_page,
                **where)
            return json_response([_redact(table, r) for r in rows])
        return handler

    def _get(self, res: str):
        table = _TABLE_OF[res]

        async def handler(request: Request) -> Response:
            row = self.service.db.get(table, int(request.match_info["id"]))
            if not row:
                return json_response({"message": "not found"}, status=404)
            return json_response(_redact(table, row))
        return handler

    def _patch(self, res: str):
        table, cols = _TABLE_OF[res], _RESOURCES[res]

        async def handler(request: Request) -> Response:
            body = await request.json()
            values = {k: v for k, v in body.items() if k in cols}
            row = self.service.db.update(table, int(request.match_info["id"]),
                                         values)
            if not row:
                return json_response({"message": "not found"}, status=404)
            return json_response(row)
        return handler

    def _delete(self, res: str):
        table = _TABLE_OF[res]

        async def handler(request: Request) -> Response:
            ok = self.service.db.delete(table, int(request.match_info["id"]))
            return json_response({}, status=200 if ok else 404)
        return handler

    async def _link_clusters(self, request: Request) -> Response:
        self.service.db.link_seed_peer_cluster(
            int(request.match_info["id"]), int(request.match_info["spc_id"]))
        return json_response({})

    async def _healthy(self, request: Request) -> Response:
        return json_response({"status": "ok", "ts": time.time()})

    async def _metrics(self, request: Request) -> Response:
        body, ctype = metrics.render()
        return Response(200, body, ctype.split(";")[0])
