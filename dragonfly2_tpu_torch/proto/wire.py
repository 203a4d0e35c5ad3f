"""The drpc wire contract of the methods the port serves: the port's copy
of ``dragonfly2_tpu/proto/wire.py``, cut to the methods its
``DaemonRpcServer`` registers: the download service (``Daemon.Download``,
``StatTask``, ``ImportTask``, ``ExportTask``, ``DeleteTask``, ``Health``,
``FlightReport``, ``PodTimeline``) and the peer service
(``Peer.SyncPieceTasks``, ``GetPieceTasks``, ``TriggerDownloadTask``,
``StatTask``, ``DeleteTask``, ``Daemon.FlightReport``), plus
``Scheduler.PodTimeline``, which ``Daemon.PodTimeline`` proxies,
``Scheduler.AnnounceHost`` and ``Scheduler.LeaveHost``, which the
daemon's announcer sends, and the messages a conductor sends on ``Scheduler.AnnouncePeer``
(``STREAM_MSGS``: the piece reports with their ``timings``, the packed
batch envelope, the resume with its ``piece_bitmap``, and the terminal
messages with the flight digest), which ``validate_stream_msg`` checks.

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

PIECE = Msg(
    "Piece",
    piece_num=F(int, required=True), range_start=F(int), range_size=F(int),
    digest=F(str), download_cost_ms=F(int), dst_peer_id=F(str),
    # The flight recorder's split of download_cost_ms ({dcn_ms, stall_ms,
    # store_ms}) for the scheduler's PodAggregator; absent on origin and
    # imported pieces.
    timings=F(dict),
)

# The negotiated packed form of a piece-report batch (proto/reportcodec):
# the schema pins the envelope; decode_packed checks the structure.
PACKED_PIECES = Msg(
    "PackedPieces",
    v=F(int, required=True), n=F(int, required=True),
    peers=F(list, required=True, item=F(str)),
    nums=F(bytes, required=True), cols=F(bytes, required=True),
    digests=F(dict),
)

# A (re-)register's local task state; piece_bitmap is the negotiated
# packed alternative to piece_nums (bit i of byte i>>3: piece i landed).
RESUME = Msg(
    "Resume",
    piece_nums=F(list, item=F(int)),
    piece_bitmap=F(bytes),
    content_length=F(int), piece_size=F(int), total_piece_count=F(int),
    prefix_digest=F(str), pod_broadcast=F(bool), stripe=F(dict),
)

# The compact bounded flight digest (pkg/flight.digest) on the terminal
# announce message; checked loosely, it is byte-capped at the source.
FLIGHT_DIGEST = Msg(
    "FlightDigest",
    v=F(int), task_id=F(str), state=F(str), start_wall=F(float),
    wall_s=F(float), phases=F(dict), segments=F(list),
    pieces=F(list), events=F(list), clock=F(list),
)

# The previous announce's round trip, bracketing the scheduler's echoed
# ``sched_wall``: the pod lens's clock alignment of this host.
CLOCK_SAMPLE = Msg(
    "ClockSample",
    t0=F(float, required=True), t1=F(float, required=True),
    echo=F(float, required=True),
)

UNARY: dict[str, Msg] = {
    # The scheduler's host registry: the announcer's periodic announce and
    # its leave at the daemon's stop.
    "Scheduler.AnnounceHost": Msg(
        "AnnounceHost",
        id=F(str, required=True), hostname=F(str), ip=F(str), port=F(int),
        upload_port=F(int), type=F(int), idc=F(str), location=F(str),
        tpu_slice=F(str), tpu_worker_index=F(int), telemetry=F(dict),
        clock=F(dict, spec=CLOCK_SAMPLE)),
    "Scheduler.LeaveHost": Msg("LeaveHost", id=F(str, required=True)),
    # The scheduler's merged cross-host timeline, which Daemon.PodTimeline
    # proxies.
    "Scheduler.PodTimeline": Msg(
        "PodTimeline", task_id=F(str, required=True)),

    # The download service (dfget and dfcache attach to it).
    "Daemon.StatTask": Msg("DaemonStatTask", task_id=F(str, required=True)),
    "Daemon.ImportTask": Msg(
        "ImportTask",
        path=F(str, required=True), cache_id=F(str, required=True),
        tag=F(str), application=F(str), digest=F(str),
        persistent=F(bool), replica_count=F(int), ttl=F(float)),
    "Daemon.DeleteTask": Msg("DeleteTask", task_id=F(str, required=True)),
    "Daemon.Health": Msg("Health"),
    # A task's flight report (also on the peer service, for the
    # scheduler's on-demand pulls).
    "Daemon.FlightReport": Msg("FlightReport",
                               task_id=F(str, required=True)),
    "Daemon.PodTimeline": Msg("DaemonPodTimeline",
                              task_id=F(str, required=True)),

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


# Client-to-server messages of Scheduler.AnnouncePeer by their "type".
STREAM_MSGS: dict[str, dict[str, Msg]] = {
    "Scheduler.AnnouncePeer": {
        "register": Msg("Register", resume=F(dict, spec=RESUME)),
        "download_started": Msg(
            "DownloadStarted", content_length=F(int), piece_size=F(int),
            total_piece_count=F(int)),
        "piece_finished": Msg(
            "PieceFinished", piece=F(dict, required=True, spec=PIECE)),
        "pieces_finished": Msg(
            "PiecesFinished",
            # One of the two forms: the dict list, or the packed batch.
            pieces=F(list, item=F(dict, spec=PIECE)),
            packed=F(dict, spec=PACKED_PIECES)),
        "piece_failed": Msg(
            "PieceFailed", piece_num=F(int), parent_id=F(str),
            temporary=F(bool),
            # The typed failure reason (pkg/quarantine's vocabulary).
            reason=F(str)),
        "reschedule": Msg(
            "Reschedule", blocklist=F(list, item=F(str)),
            description=F(str)),
        "download_finished": Msg(
            "DownloadFinished", content_length=F(int), piece_size=F(int),
            total_piece_count=F(int),
            flight=F(dict, spec=FLIGHT_DIGEST)),
        "download_failed": Msg("DownloadFailed", reason=F(str),
                               flight=F(dict, spec=FLIGHT_DIGEST)),
    },
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


def validate_stream_msg(method: str, body: Any) -> None:
    """Validate one client-to-server stream message. A message of an
    unknown type passes, but on a method with schemas the body must be a
    map."""
    kinds = STREAM_MSGS.get(method)
    if kinds is None:
        return
    if not isinstance(body, dict):
        raise SchemaError(f"{method}: stream message must be a map, got "
                          f"{type(body).__name__}")
    schema = kinds.get(body.get("type", ""))
    if schema is not None:
        schema.validate(body, f"{method}/{body.get('type')}")
