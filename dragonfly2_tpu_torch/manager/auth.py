"""Password hashes, signed session tokens, personal access tokens and
the two-role policy: the port's copy of ``dragonfly2_tpu/manager/auth.py``.

Passwords are PBKDF2-HMAC-SHA256 (``salt$hash``, 100,000 rounds), tokens
``base64url(payload).hmac_sha256`` over a JSON payload, so each package
verifies the other's hashes and, with one secret, signs the same tokens.
Root may do anything, guest only read.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import time

ROLE_ROOT = "root"
ROLE_GUEST = "guest"

_PBKDF2_ITERS = 100_000


def hash_password(password: str, salt: bytes | None = None) -> str:
    salt = salt or os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, _PBKDF2_ITERS)
    return f"{salt.hex()}${dk.hex()}"


def verify_password(password: str, encrypted: str) -> bool:
    try:
        salt_hex, dk_hex = encrypted.split("$", 1)
    except ValueError:
        return False
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), bytes.fromhex(salt_hex),
                             _PBKDF2_ITERS)
    return hmac.compare_digest(dk.hex(), dk_hex)


class TokenSigner:
    """HMAC-SHA256 signed bearer tokens: base64(json payload) + '.' + sig."""

    def __init__(self, secret: bytes | None = None, ttl: float = 7 * 24 * 3600):
        self.secret = secret or os.urandom(32)
        self.ttl = ttl

    def sign(self, user_id: int, name: str, roles: list[str]) -> str:
        payload = json.dumps({
            "uid": user_id, "name": name, "roles": roles,
            "exp": time.time() + self.ttl,
        }, separators=(",", ":")).encode()
        b64 = base64.urlsafe_b64encode(payload).rstrip(b"=")
        sig = hmac.new(self.secret, b64, hashlib.sha256).hexdigest()
        return f"{b64.decode()}.{sig}"

    def verify(self, token: str) -> dict | None:
        try:
            b64, sig = token.rsplit(".", 1)
        except ValueError:
            return None
        expect = hmac.new(self.secret, b64.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(sig, expect):
            return None
        try:
            pad = b64 + "=" * (-len(b64) % 4)
            payload = json.loads(base64.urlsafe_b64decode(pad))
        except Exception:
            return None
        if payload.get("exp", 0) < time.time():
            return None
        return payload


def new_personal_access_token() -> str:
    return "dfp_" + secrets.token_hex(24)


def can(roles: list[str], method: str) -> bool:
    """Default policy: root does anything; guest is read-only (GET)."""
    if ROLE_ROOT in roles:
        return True
    if ROLE_GUEST in roles:
        return method.upper() in ("GET", "HEAD", "OPTIONS")
    return False
