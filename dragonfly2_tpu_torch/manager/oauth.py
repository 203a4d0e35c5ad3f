"""OAuth2 sign-in through provider rows of the ``oauth`` table: the
port's copy of ``dragonfly2_tpu/manager/oauth.py``, its token exchange and
user-info fetch on ``http.client`` (on a worker thread, off the
manager's loop) where the JAX package uses ``aiohttp``.

Flow:
  GET /api/v1/users/signin/oauth/{name}
      → {"redirect_url": "<auth_url>?client_id=...&state=..."}
  the provider redirects to <redirect_url>?code=C&state=S
  GET /api/v1/oauth/{name}/callback?code=C&state=S
      → the code exchanged (a form POST to token_url), the user info
        fetched, the user upserted as oauth-{provider}-{remote id} with
        the guest role, and a signed session token returned.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import secrets
import ssl
import time
import urllib.parse
from urllib.parse import urlencode

from dragonfly2_tpu_torch.manager import auth
from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.errors import Code, DfError

log = dflog.get("manager.oauth")

_STATE_TTL = 600.0
_TIMEOUT = 300.0


def _http(method: str, url: str, headers: dict[str, str],
          body: bytes | None = None) -> tuple[int, bytes]:
    """One request on a connection of its own: (status, body)."""
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
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class OAuthFlow:
    def __init__(self, service):
        self.service = service
        self._states: dict[str, float] = {}  # state -> issue time

    def _provider(self, name: str) -> dict:
        row = self.service.db.find("oauth", name=name)
        if not row:
            raise DfError(Code.NotFound, f"oauth provider {name!r} not found")
        return row

    def _check_state(self, state: str) -> bool:
        now = time.time()
        self._states = {s: t for s, t in self._states.items()
                        if now - t < _STATE_TTL}
        return self._states.pop(state, None) is not None

    _MAX_STATES = 10_000

    def authorize_url(self, name: str) -> str:
        p = self._provider(name)
        # This endpoint is reachable unauthenticated; prune expired states
        # here too (not only at exchange) and cap the dict so hammering the
        # signin URL cannot grow memory without bound.
        now = time.time()
        self._states = {s: t for s, t in self._states.items()
                        if now - t < _STATE_TTL}
        if len(self._states) >= self._MAX_STATES:
            for s in sorted(self._states, key=self._states.get)[
                    : len(self._states) - self._MAX_STATES + 1]:
                del self._states[s]
        state = secrets.token_urlsafe(16)
        self._states[state] = time.time()
        query = urlencode({
            "response_type": "code",
            "client_id": p["client_id"],
            "redirect_uri": p["redirect_url"],
            "scope": p.get("scopes") or "",
            "state": state,
        })
        return f"{p['auth_url']}?{query}"

    async def exchange(self, name: str, code: str, state: str) -> str:
        """Code → provider token → user info → local user → session token."""
        p = self._provider(name)
        if not self._check_state(state):
            raise DfError(Code.Unauthorized, "bad oauth state")
        form = urlencode({
            "grant_type": "authorization_code",
            "code": code,
            "client_id": p["client_id"],
            "client_secret": p["client_secret"],
            "redirect_uri": p["redirect_url"],
        }).encode()
        status, raw = await asyncio.to_thread(
            _http, "POST", p["token_url"],
            {"Accept": "application/json",
             "Content-Type": "application/x-www-form-urlencoded"}, form)
        if status != 200:
            raise DfError(Code.Unauthorized,
                          f"token exchange failed ({status})")
        token_doc = json.loads(raw.decode("utf-8"))
        access = token_doc.get("access_token", "")
        if not access:
            raise DfError(Code.Unauthorized, "provider returned no token")
        status, raw = await asyncio.to_thread(
            _http, "GET", p["user_info_url"],
            {"Authorization": f"Bearer {access}",
             "Accept": "application/json"})
        if status != 200:
            raise DfError(Code.Unauthorized,
                          f"user info failed ({status})")
        info = json.loads(raw.decode("utf-8"))

        remote_id = str(info.get("id") or info.get("sub") or info.get("login")
                        or info.get("email") or "")
        if not remote_id:
            raise DfError(Code.Unauthorized, "user info lacks an id")
        local_name = f"oauth-{name}-{remote_id}"
        user = self.service.db.find("users", name=local_name)
        if user is None:
            user = self.service.db.insert("users", {
                "name": local_name,
                # Unusable password: oauth users sign in via the provider.
                "encrypted_password": auth.hash_password(
                    secrets.token_urlsafe(32)),
                "email": info.get("email", ""),
            })
            self.service.db.insert(
                "user_roles", {"user_id": user["id"], "role": auth.ROLE_GUEST})
            log.info("oauth user created", provider=name, user=local_name)
        return self.service.signer.sign(
            user["id"], local_name, self.service.roles_of(user["id"]))
