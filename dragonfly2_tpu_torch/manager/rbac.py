"""Per-resource role policies: the port's copy of
``dragonfly2_tpu/manager/rbac.py``.

A policy is ``(role, object, action)`` with the action ``read`` or
``*`` and the object a resource group (``jobs``, ``schedulers``, ...) or
``*``, kept in the ``rbac_policies`` table. Root may do anything, guest
may read anything; users get roles through ``user_roles``.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.manager import auth
from dragonfly2_tpu_torch.manager.database import Database

ACTION_READ = "read"
ACTION_ALL = "*"

# HTTP method → action.
_METHOD_ACTION = {
    "GET": ACTION_READ, "HEAD": ACTION_READ, "OPTIONS": ACTION_READ,
}


def method_action(method: str) -> str:
    return _METHOD_ACTION.get(method.upper(), ACTION_ALL)


def path_object(path: str) -> str:
    """API path → permission object: '/api/v1/jobs/3' → 'jobs'."""
    parts = [p for p in path.split("/") if p]
    if len(parts) >= 3 and parts[0] == "api":
        return parts[2]
    return ""


class Enforcer:
    def __init__(self, db: Database):
        self.db = db
        db.execute("""
            CREATE TABLE IF NOT EXISTS rbac_policies (
              id INTEGER PRIMARY KEY AUTOINCREMENT,
              role TEXT NOT NULL,
              object TEXT NOT NULL,
              action TEXT NOT NULL,
              UNIQUE(role, object, action)
            )""")

    # -- policy management -------------------------------------------------

    def add_policy(self, role: str, obj: str, action: str) -> None:
        if action not in (ACTION_READ, ACTION_ALL):
            raise ValueError(f"action must be 'read' or '*', got {action!r}")
        self.db.execute(
            "INSERT OR IGNORE INTO rbac_policies (role, object, action) "
            "VALUES (?, ?, ?)", (role, obj, action))

    def remove_policy(self, role: str, obj: str, action: str) -> None:
        self.db.execute(
            "DELETE FROM rbac_policies WHERE role=? AND object=? AND action=?",
            (role, obj, action))

    def policies(self, role: str = "") -> list[dict]:
        rows = self.db.execute(
            "SELECT role, object, action FROM rbac_policies"
            + (" WHERE role=?" if role else ""),
            (role,) if role else ())
        return [dict(r) for r in rows]

    def roles(self) -> list[str]:
        rows = self.db.execute("SELECT DISTINCT role FROM rbac_policies")
        return sorted({r["role"] for r in rows}
                      | {auth.ROLE_ROOT, auth.ROLE_GUEST})

    # -- enforcement -------------------------------------------------------

    def enforce(self, roles: list[str], obj: str, action: str) -> bool:
        if auth.ROLE_ROOT in roles:
            return True
        if action == ACTION_READ and auth.ROLE_GUEST in roles:
            return True
        if not roles:
            return False
        marks = ",".join("?" for _ in roles)
        rows = self.db.execute(
            f"SELECT 1 FROM rbac_policies WHERE role IN ({marks}) "
            "AND object IN (?, '*') AND action IN (?, '*') LIMIT 1",
            (*roles, obj, action))
        return bool(rows)

    def enforce_request(self, roles: list[str], method: str,
                        path: str) -> bool:
        return self.enforce(roles, path_object(path), method_action(method))
