"""The drpc wire contract of the methods the port serves: the port's copy
of ``dragonfly2_tpu/proto/wire.py``, cut to the methods its
``DaemonRpcServer`` registers: the download service (``Daemon.Download``,
``StatTask``, ``ImportTask``, ``ExportTask``, ``DeleteTask``, ``Health``)
and the peer service (``Peer.SyncPieceTasks``, ``GetPieceTasks``,
``TriggerDownloadTask``, ``StatTask``, ``DeleteTask``).

Bodies are validated at the server boundary (``rpc/server.py``), so a
malformed body fails fast with ``Code.BadRequest``. As in protobuf,
unknown fields pass, missing optional fields take their defaults, and a
missing required field or a wrong type rejects the call. A method with no
schema here passes unchecked (the JAX package's posture for methods its
schema does not know).
"""

from __future__ import annotations

from typing import Any


class SchemaError(ValueError):
    """A body failed validation; message names the method+field."""


class F:
    """One field: type, requiredness, optional nested/list schema."""

    __slots__ = ("type", "required", "spec", "item")

    def __init__(self, type_: type | tuple, required: bool = False,
                 spec: "Msg | None" = None, item: "F | None" = None):
        self.type = type_
        self.required = required
        self.spec = spec      # nested Msg for dict fields
        self.item = item      # element spec for list fields


class Msg:
    """A message shape: field name → F. Unknown fields are allowed."""

    __slots__ = ("name", "fields")

    def __init__(self, name: str, **fields: F):
        self.name = name
        self.fields = fields

    def validate(self, body: Any, where: str) -> None:
        if body is None:
            body = {}
        if not isinstance(body, dict):
            raise SchemaError(f"{where}: body must be a map, got "
                              f"{type(body).__name__}")
        for fname, f in self.fields.items():
            if fname not in body:
                if f.required:
                    raise SchemaError(f"{where}: missing required field "
                                      f"{fname!r}")
                continue
            value = body[fname]
            if value is None and not f.required:
                continue
            self._check(fname, f, value, where)

    def _check(self, fname: str, f: F, value: Any, where: str) -> None:
        ok = isinstance(value, f.type)
        # bools are ints in Python; don't let a bool satisfy an int field
        # unless the field is bool itself.
        if ok and isinstance(value, bool) and f.type is not bool:
            types = f.type if isinstance(f.type, tuple) else (f.type,)
            ok = bool in types
        # ints satisfy float fields (msgpack preserves the distinction) —
        # but bools, despite being ints, satisfy neither.
        if (not ok and f.type is float and isinstance(value, int)
                and not isinstance(value, bool)):
            ok = True
        if not ok:
            raise SchemaError(
                f"{where}: field {fname!r} must be "
                f"{getattr(f.type, '__name__', f.type)}, got "
                f"{type(value).__name__}")
        if f.spec is not None and isinstance(value, dict):
            f.spec.validate(value, f"{where}.{fname}")
        if f.item is not None and isinstance(value, (list, tuple)):
            for i, item in enumerate(value):
                self._check(f"{fname}[{i}]", f.item, item, where)


URL_META = Msg(
    "UrlMeta",
    digest=F(str), tag=F(str), range=F(str), filter=F(str),
    header=F(dict), application=F(str), priority=F(int),
    # QoS attribution: rides with the request, not part of its identity.
    tenant=F(str),
)

UNARY: dict[str, Msg] = {
    # The download service (dfget and dfcache attach to it).
    "Daemon.StatTask": Msg("DaemonStatTask", task_id=F(str, required=True)),
    "Daemon.ImportTask": Msg(
        "ImportTask",
        path=F(str, required=True), cache_id=F(str, required=True),
        tag=F(str), application=F(str), digest=F(str),
        persistent=F(bool), replica_count=F(int), ttl=F(float)),
    "Daemon.DeleteTask": Msg("DeleteTask", task_id=F(str, required=True)),
    "Daemon.Health": Msg("Health"),

    # The peer service (other daemons and the scheduler's triggers).
    "Peer.GetPieceTasks": Msg(
        "GetPieceTasks", task_id=F(str, required=True)),
    "Peer.TriggerDownloadTask": Msg(
        "TriggerDownloadTask",
        url=F(str, required=True), task_id=F(str), tag=F(str),
        application=F(str), digest=F(str), header=F(dict),
        filters=F(list, item=F(str)), seed=F(bool),
        disable_back_source=F(bool),
        # "tpu": the content also lands in the daemon's device sink.
        device=F(str),
        # A sharded preheat warms only this byte range ("bytes=a-b").
        range=F(str),
        # Register the pull as a striped slice broadcast.
        pod_broadcast=F(bool),
        # The triggering caller's tenant and priority class.
        tenant=F(str), priority=F(int)),
    "Peer.StatTask": Msg("PeerStatTask", task_id=F(str, required=True)),
    "Peer.DeleteTask": Msg("PeerDeleteTask", task_id=F(str, required=True)),
}

STREAM_OPEN: dict[str, Msg] = {
    "Daemon.Download": Msg(
        "DownloadOpen",
        url=F(str, required=True), output=F(str),
        meta=F(dict, spec=URL_META), disable_back_source=F(bool),
        device=F(str), pod_broadcast=F(bool),
        # The task id of a local base version: a delta download.
        delta_base=F(str)),
    "Daemon.ExportTask": Msg(
        "ExportTaskOpen",
        cache_id=F(str, required=True), output=F(str, required=True),
        tag=F(str), application=F(str), digest=F(str)),
    "Peer.SyncPieceTasks": Msg(
        "SyncPieceTasksOpen",
        task_id=F(str, required=True), peer_id=F(str)),
}


def validate_unary(method: str, body: Any) -> None:
    """Raises SchemaError when ``body`` violates the method's schema."""
    schema = UNARY.get(method)
    if schema is not None:
        schema.validate(body, method)


def validate_stream_open(method: str, body: Any) -> None:
    schema = STREAM_OPEN.get(method)
    if schema is not None:
        schema.validate(body, method)
