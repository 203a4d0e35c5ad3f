"""Flight recorder, always-on per-task event timelines and their
critical-path fold: the port's copy of ``dragonfly2_tpu/pkg/flight.py``.

  * every task gets a bounded ring of typed events on the monotonic clock,
    stamped where the daemon's data plane makes its moves (register,
    schedule pushes, a piece's request, first byte, store write and
    landing, parent drops, quarantine, back-to-source, the device-sink
    landing, upload serving, the completion re-hash);
  * ``analyze()`` folds a task's events into a phase breakdown
    (sched_wait / dcn / ici / verify / store / stall / origin) whose
    segments partition the task's wall time exactly (``other`` takes the
    uninstrumented gaps), plus a per-piece waterfall, rendered by
    ``render_waterfall``; ``digest()`` is its compact form, at most
    ``DIGEST_MAX_BYTES`` of JSON, that a conductor ships on its terminal
    announce message;
  * ``FlightRecorder.finish_task`` feeds ``peer_task_phase_seconds{phase}``
    (the port's registry, the JAX buckets) and dumps a post-mortem bundle
    of a failed task to ``dump_dir``;
  * piece reports carry per-piece phase timings, which the scheduler's
    ``PodAggregator`` folds per host.

Intended divergence: ``TaskFlight.record`` takes a lock. The port's piece
downloader and upload server run on worker threads (``http.client``,
``http.server``), which stamp a task's ring beside the event loop; the
JAX recorder is written from its loop only. ``FlightRecorder.stamp_running``
is called by the runtime observatory (``pkg/prof``), which stamps slow
loop ticks and GC pauses into the running flights, and a post-mortem
bundle carries its ``runtime`` snapshot.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from collections import OrderedDict

from dragonfly2_tpu_torch.pkg import dflog, metrics

log = dflog.get("flight")

# Monotonic-anchored wall clock: wall is sampled ONCE at import and every
# later reading is anchor + perf_counter delta, so an NTP step mid-run
# cannot skew any timeline or clock sample built from it. Everything this
# module (and the pod-lens clock alignment on top of it) calls "wall time"
# is this clock, optionally plus a per-recorder offset (the chaos knob
# that lets a test inject a known skew).
_WALL_ANCHOR = time.time()
_PC_ANCHOR = time.perf_counter()


def anchored_wall() -> float:
    return _WALL_ANCHOR + (time.perf_counter() - _PC_ANCHOR)

# --------------------------------------------------------------------- #
# Event vocabulary (ints in the ring; names only at export time)
# --------------------------------------------------------------------- #

EV_REGISTER = 1        # announce register sent
EV_SCHEDULED = 2       # scheduler answered the register (note=kind)
EV_SCHED_PUSH = 3      # mid-task scheduler push (note=kind)
EV_RESCHEDULE = 4      # reschedule sent (starvation)
EV_SCHED_ANSWER = 5    # reschedule answered / schedule update applied
EV_RECONNECT = 6       # announce-stream recovery attempt (note=result)
EV_REQUEST = 7         # piece GET issued (note=parent ip:port)
EV_FIRST_BYTE = 8      # first body chunk arrived
EV_LANDED = 9          # piece verified+recorded (aux=cost_ms, note=locality)
EV_FAILED = 10         # piece attempt failed (note=typed reason)
EV_STORE_START = 11    # store write handed to the executor
EV_STORED = 12         # store write committed
EV_VERIFY_START = 13   # completion whole-content re-hash started
EV_VERIFIED = 14       # completion re-hash done
EV_PARENT_DROP = 15    # dispatcher dropped a parent (note=peer id)
EV_QUARANTINE = 16     # parent entered quarantine (note=endpoint|reason)
EV_STRIPE = 17         # stripe plan applied/cleared (aux=slice_size)
EV_BACK_SOURCE = 18    # task demoted to origin
EV_SOURCE_LANDED = 19  # origin piece landed (aux=cost_ms)
EV_HBM_START = 20      # device-sink landing started
EV_HBM_LANDED = 21     # device-sink landing done
EV_UPLOAD_SERVE = 22   # this daemon served a piece of the task (aux=bytes)
EV_TASK_DONE = 23
EV_TASK_FAILED = 24
EV_DELTA_REUSE = 25    # delta chunk copied from the local base (aux=cost_ms)
EV_DELTA_FETCH = 26    # delta chunk pulled as a ranged task (aux=cost_ms)
EV_LOOP_LAG = 27       # event loop wedged during this task (aux=lag_s)
EV_GC_PAUSE = 28       # slow cyclic-GC pause during this task (aux=pause_s)

EVENT_NAMES = {
    EV_REGISTER: "register", EV_SCHEDULED: "scheduled",
    EV_SCHED_PUSH: "sched_push", EV_RESCHEDULE: "reschedule",
    EV_SCHED_ANSWER: "sched_answer", EV_RECONNECT: "reconnect",
    EV_REQUEST: "request", EV_FIRST_BYTE: "first_byte",
    EV_LANDED: "landed", EV_FAILED: "failed",
    EV_STORE_START: "store_start", EV_STORED: "stored",
    EV_VERIFY_START: "verify_start", EV_VERIFIED: "verified",
    EV_PARENT_DROP: "parent_drop", EV_QUARANTINE: "quarantine",
    EV_STRIPE: "stripe", EV_BACK_SOURCE: "back_source",
    EV_SOURCE_LANDED: "source_landed", EV_HBM_START: "hbm_start",
    EV_HBM_LANDED: "hbm_landed", EV_UPLOAD_SERVE: "upload_serve",
    EV_TASK_DONE: "task_done", EV_TASK_FAILED: "task_failed",
    EV_DELTA_REUSE: "delta_reuse", EV_DELTA_FETCH: "delta_fetch",
    EV_LOOP_LAG: "loop_lag", EV_GC_PAUSE: "gc_pause",
}

# Runtime-interference events (pkg/prof stamps them into every RUNNING
# flight): not phase markers — the analyzer summarizes them separately
# so --explain can say the LOOP was wedged, not just "nothing happened".
_RUNTIME_EVENTS = (EV_LOOP_LAG, EV_GC_PAUSE)

# Canonical phase model. ``other`` (residual uninstrumented time) rides
# alongside so the fold partitions wall time exactly.
PHASES = ("sched_wait", "dcn", "ici", "verify", "store", "stall", "origin")

# Overlap priority: when two phases cover the same wall segment, the one
# doing WORK wins (a stall that overlaps a concurrent healthy transfer
# did not cost wall time).
_PRIORITY = {"verify": 6, "store": 5, "ici": 4, "dcn": 3, "origin": 2,
             "stall": 1, "sched_wait": 0}

# A first byte later than this after the request counts the gap as stall
# (the parent was connected but silent) instead of transfer time.
STALL_TTFB_S = 0.25

PHASE_SECONDS = metrics.histogram(
    "peer_task_phase_seconds",
    "Per-task phase durations from the flight recorder's critical-path fold",
    ("phase",),
    buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0))

# record() keeps per-piece slots for the wire-report timings; maps event
# code -> slot index in the 5-float row [request, first_byte, landed,
# store_start, stored].
_TRACK_SLOT = {EV_REQUEST: 0, EV_FIRST_BYTE: 1, EV_LANDED: 2,
               EV_STORE_START: 3, EV_STORED: 4}


class TaskFlight:
    """One task's bounded event ring. All times are seconds relative to
    the task's start on the monotonic clock (NTP steps cannot skew a
    timeline); ``start_wall`` anchors export to wall time."""

    __slots__ = ("task_id", "start_wall", "_start_pc", "_cap", "_ring",
                 "_n", "state", "note", "_end_pc", "_piece_track",
                 "_piece_cap", "_mu", "__weakref__")

    def __init__(self, task_id: str, capacity: int = 2048,
                 piece_track_cap: int = 4096, wall_offset: float = 0.0):
        self.task_id = task_id
        self.start_wall = anchored_wall() + wall_offset
        self._start_pc = time.perf_counter()
        self._cap = capacity
        self._ring: list = [None] * capacity
        self._n = 0
        self.state = "running"
        self.note = ""
        self._end_pc = -1.0
        self._piece_track: dict[int, list] = {}
        self._piece_cap = piece_track_cap
        self._mu = threading.Lock()

    # -- hot path ----------------------------------------------------------

    def record(self, code: int, piece: int = -1, aux: float = 0.0,
               note: str = "") -> None:
        """Append one event: a tuple into the preallocated ring, under the
        ring's lock (worker threads record beside the event loop)."""
        with self._mu:
            self._record(time.perf_counter() - self._start_pc, code, piece,
                         aux, note)

    def _record(self, t: float, code: int, piece: int, aux: float,
                note: str) -> None:
        self._ring[self._n % self._cap] = (t, code, piece, aux, note)
        self._n += 1
        if piece >= 0 and code in _TRACK_SLOT:
            slot = _TRACK_SLOT[code]
            track = self._piece_track.get(piece)
            if track is None:
                if len(self._piece_track) >= self._piece_cap:
                    self._piece_track.pop(next(iter(self._piece_track)))
                track = self._piece_track[piece] = [-1.0, -1.0, -1.0, -1.0,
                                                    -1.0]
            if slot == 0:
                # New attempt: the previous attempt's marks are stale.
                track[1] = track[2] = track[3] = track[4] = -1.0
            track[slot] = t

    # -- accessors ---------------------------------------------------------

    @property
    def events_total(self) -> int:
        return self._n

    @property
    def events_dropped(self) -> int:
        return max(0, self._n - self._cap)

    def wall_s(self) -> float:
        end = self._end_pc if self._end_pc >= 0 else (
            time.perf_counter() - self._start_pc)
        return max(0.0, end)

    def wall_now(self) -> float:
        """This task's anchored wall clock right now (start_wall + the
        monotonic delta, so it carries the recorder's wall offset and is
        NTP-step-proof) — what clock-alignment samples stamp."""
        return self.start_wall + (time.perf_counter() - self._start_pc)

    def events(self) -> list:
        """Chronological retained events (oldest dropped on overflow)."""
        with self._mu:
            if self._n <= self._cap:
                return [e for e in self._ring[:self._n]]
            head = self._n % self._cap
            return [e for e in self._ring[head:] + self._ring[:head]]

    def finish(self, state: str, note: str = "") -> None:
        self.record(EV_TASK_DONE if state == "done" else EV_TASK_FAILED,
                    -1, 0.0, note)
        self.state = state
        self.note = note
        self._end_pc = time.perf_counter() - self._start_pc

    def piece_report_timings(self, piece: int) -> "dict | None":
        """Per-phase ms for the wire piece report (scheduler straggler
        attribution): dcn_ms / stall_ms / store_ms. None when this piece
        recorded no request (origin/imported pieces)."""
        tr = self._piece_track.get(piece)
        if tr is None or tr[0] < 0:
            return None
        out: dict = {}
        store = 0.0
        if tr[3] >= 0 and tr[4] >= tr[3]:
            store = (tr[4] - tr[3]) * 1000.0
            out["store_ms"] = int(store)
        if tr[2] >= 0:
            total = (tr[2] - tr[0]) * 1000.0
            stall = 0.0
            if tr[1] >= 0 and (tr[1] - tr[0]) > STALL_TTFB_S:
                stall = (tr[1] - tr[0]) * 1000.0
            # dcn is what remains of the attempt after the silent gap and
            # the store write — the phases must not double-count.
            out["dcn_ms"] = int(max(0.0, total - stall - store))
            out["stall_ms"] = int(stall)
        return out or None


# --------------------------------------------------------------------- #
# Critical-path analyzer
# --------------------------------------------------------------------- #

def _fold_phases(intervals: list, wall: float) -> "tuple[dict, float, list]":
    """Partition [0, wall] across phase intervals: a sweep assigns each
    elementary segment to the highest-priority phase active in it, so the
    per-phase sums plus the residual ``other`` equal ``wall`` exactly.
    Also returns the assigned timeline as merged ``(start, end, phase)``
    segments (gaps omitted) — the pod lens ships these so a cross-host
    merge can draw phase-colored bars without re-shipping raw rings."""
    marks: list = []
    for s, e, ph in intervals:
        s = min(max(s, 0.0), wall)
        e = min(max(e, 0.0), wall)
        if e > s:
            marks.append((s, 1, ph))
            marks.append((e, -1, ph))
    phases = {ph: 0.0 for ph in PHASES}
    if not marks:
        return phases, wall, []
    marks.sort(key=lambda m: m[0])
    active = {ph: 0 for ph in PHASES}
    other = 0.0
    prev = 0.0
    segments: list = []
    i, n = 0, len(marks)
    while i < n:
        t = marks[i][0]
        if t > prev:
            best, bp = "", -1
            for ph, count in active.items():
                if count > 0 and _PRIORITY[ph] > bp:
                    best, bp = ph, _PRIORITY[ph]
            if best:
                phases[best] += t - prev
                if segments and segments[-1][2] == best \
                        and segments[-1][1] == prev:
                    segments[-1][1] = t
                else:
                    segments.append([prev, t, best])
            else:
                other += t - prev
            prev = t
        while i < n and marks[i][0] == t:
            active[marks[i][2]] += marks[i][1]
            i += 1
    if wall > prev:
        other += wall - prev
    return phases, other, segments


def analyze(tf: TaskFlight, *, stall_ttfb_s: float = STALL_TTFB_S,
            max_waterfall: int = 256, max_segments: int = 256) -> dict:
    """Fold a task's event ring into the phase breakdown + per-piece
    waterfall. Pure function of the ring — safe to call on a live task
    (the in-flight tail classifies as stall/sched_wait as appropriate)."""
    events = tf.events()
    wall = tf.wall_s()
    intervals: list = []          # (start_s, end_s, phase)
    open_req: dict = {}           # piece -> [t_req, t_first_byte, parent]
    open_marks: dict = {}         # paired-mark key -> t
    rows: dict = {}               # piece -> waterfall row
    sched_open: "float | None" = None

    def row_for(piece: int) -> dict:
        row = rows.get(piece)
        if row is None:
            row = rows[piece] = {
                "piece": piece, "attempts": 0, "parent": "",
                "t_request": -1.0, "t_first_byte": -1.0, "t_landed": -1.0,
                "status": "pending", "reason": "", "cost_ms": 0}
        return row

    for t, code, piece, aux, note in events:
        if code in (EV_REGISTER, EV_RESCHEDULE):
            if sched_open is None:
                sched_open = t
        elif code in (EV_SCHEDULED, EV_SCHED_ANSWER, EV_SCHED_PUSH):
            if sched_open is not None:
                intervals.append((sched_open, t, "sched_wait"))
                sched_open = None
        elif code == EV_REQUEST:
            open_req[piece] = [t, -1.0, note]
            row = row_for(piece)
            row["attempts"] += 1
            row["parent"] = note
            row["t_request"] = t
            row["t_first_byte"] = row["t_landed"] = -1.0
        elif code == EV_FIRST_BYTE:
            r = open_req.get(piece)
            if r is not None and r[1] < 0:
                r[1] = t
            if piece in rows:
                rows[piece]["t_first_byte"] = t
        elif code in (EV_LANDED, EV_FAILED):
            r = open_req.pop(piece, None)
            row = row_for(piece)
            if code == EV_LANDED:
                row["status"] = "ok"
                row["t_landed"] = t
                row["cost_ms"] = int(aux)
            else:
                row["status"] = "failed"
                row["reason"] = note
            if r is None:
                # Landed without a recorded request (native span interior,
                # local import): back out the interval from the cost.
                if code == EV_LANDED and aux > 0:
                    phase = "ici" if note == "intra" else "dcn"
                    intervals.append((max(0.0, t - aux / 1000.0), t, phase))
                continue
            t_req, t_fb = r[0], r[1]
            if code == EV_FAILED and note == "stall":
                intervals.append((t_req, t, "stall"))
                continue
            phase = "ici" if (code == EV_LANDED and note == "intra") \
                else "dcn"
            if t_fb >= 0 and (t_fb - t_req) > stall_ttfb_s:
                intervals.append((t_req, t_fb, "stall"))
                intervals.append((t_fb, t, phase))
            else:
                intervals.append((t_req, t, phase))
        elif code in (EV_DELTA_REUSE, EV_DELTA_FETCH):
            # Delta tasks: local base copies book as store (host-local
            # work), ranged-span pulls as dcn — so --explain separates
            # local-copy time from wire time while the partition stays
            # wall-time-exact (cost-backed intervals like source_landed).
            if aux > 0:
                phase = "store" if code == EV_DELTA_REUSE else "dcn"
                intervals.append((max(0.0, t - aux / 1000.0), t, phase))
        elif code == EV_SOURCE_LANDED:
            intervals.append((max(0.0, t - aux / 1000.0), t, "origin"))
            row = row_for(piece)
            row["status"] = "ok"
            row["parent"] = "origin"
            row["t_landed"] = t
            row["cost_ms"] = int(aux)
        elif code == EV_STORE_START:
            open_marks[("store", piece)] = t
        elif code == EV_STORED:
            t0 = open_marks.pop(("store", piece), None)
            if t0 is not None:
                intervals.append((t0, t, "store"))
        elif code == EV_VERIFY_START:
            open_marks["verify"] = t
        elif code == EV_VERIFIED:
            t0 = open_marks.pop("verify", None)
            if t0 is not None:
                intervals.append((t0, t, "verify"))
        elif code == EV_HBM_START:
            open_marks[("hbm", piece)] = t
        elif code == EV_HBM_LANDED:
            t0 = open_marks.pop(("hbm", piece), None)
            if t0 is not None:
                intervals.append((t0, t, "ici"))

    # Tails: a request still open at the end of the timeline is the
    # black-box case — the piece never came back. Beyond the first-byte
    # threshold that is a stall, not transfer time.
    for piece, (t_req, t_fb, _parent) in open_req.items():
        if wall - t_req > stall_ttfb_s:
            intervals.append((t_req, wall, "stall"))
        else:
            intervals.append((t_req, wall, "dcn"))
    if sched_open is not None:
        intervals.append((sched_open, wall, "sched_wait"))

    phases, other, segments = _fold_phases(intervals, wall)
    dominant = ""
    if any(v > 0 for v in phases.values()):
        dominant = max(PHASES, key=lambda p: phases[p])

    ordered = [rows[k] for k in sorted(rows)]
    truncated = len(ordered) > max_waterfall
    counts: dict = {}
    runtime: dict = {}
    for _t, code, _p, aux, _n in events:
        name = EVENT_NAMES.get(code, str(code))
        counts[name] = counts.get(name, 0) + 1
        if code in _RUNTIME_EVENTS:
            r = runtime.get(name)
            if r is None:
                r = runtime[name] = {"count": 0, "max_s": 0.0, "total_s": 0.0}
            r["count"] += 1
            r["total_s"] += aux
            if aux > r["max_s"]:
                r["max_s"] = aux
    for r in runtime.values():
        r["max_s"] = round(r["max_s"], 4)
        r["total_s"] = round(r["total_s"], 4)
    return {
        "task_id": tf.task_id,
        "state": tf.state,
        "note": tf.note,
        "started_at": tf.start_wall,
        "wall_s": round(wall, 6),
        "phases": {ph: round(v, 6) for ph, v in phases.items()},
        "other_s": round(other, 6),
        "dominant_phase": dominant,
        "segments": [[round(s, 6), round(e, 6), ph]
                     for s, e, ph in segments[:max_segments]],
        "segments_truncated": len(segments) > max_segments,
        "events": tf.events_total,
        "events_dropped": tf.events_dropped,
        "event_counts": counts,
        "runtime": runtime,
        "pieces": ordered[:max_waterfall],
        "pieces_truncated": truncated,
    }


def runtime_advisory(report: dict) -> str:
    """One-line loop-lag/GC advisory from an ``analyze()`` report's
    runtime-interference events, or "" when the runtime stayed quiet.
    Rendered under the --explain waterfall so a stall phase caused by a
    wedged loop or a GC storm names its culprit."""
    rt = report.get("runtime") or {}
    parts = []
    ll = rt.get("loop_lag")
    if ll:
        parts.append(f"event loop wedged {ll['count']}x "
                     f"(max {ll['max_s']:.2f}s, {ll['total_s']:.2f}s total)")
    gp = rt.get("gc_pause")
    if gp:
        parts.append(f"gc paused {gp['count']}x "
                     f"(max {gp['max_s']:.2f}s, {gp['total_s']:.2f}s total)")
    if not parts:
        return ""
    return ("runtime interference: " + ", ".join(parts) +
            " during this task — see /debug/prof")


def render_waterfall(report: dict) -> str:
    """Text rendering of an ``analyze()`` report: phase bars + per-piece
    waterfall. The SAME renderer backs ``/debug/flight/<id>?format=text``
    and ``dfget --explain`` so the two can never diverge."""
    wall = report["wall_s"] or 1e-9
    width = 30
    lines = [
        f"task {report['task_id'][:40]} state={report['state']} "
        f"wall={report['wall_s']:.3f}s "
        f"dominant={report['dominant_phase'] or '-'}",
        "phase breakdown:",
    ]
    entries = [(ph, report["phases"].get(ph, 0.0)) for ph in PHASES]
    entries.append(("other", report.get("other_s", 0.0)))
    for ph, v in entries:
        bar = "#" * int(round(width * v / wall))
        lines.append(f"  {ph:<10} {v:8.3f}s {100 * v / wall:5.1f}% {bar}")
    advisory = runtime_advisory(report)
    if advisory:
        lines.append(advisory)
    pieces = report.get("pieces") or []
    suffix = " (truncated)" if report.get("pieces_truncated") else ""
    lines.append(f"pieces: {len(pieces)}{suffix}")
    for row in pieces:
        start = row["t_request"] if row["t_request"] >= 0 else row["t_landed"]
        end = row["t_landed"] if row["t_landed"] >= 0 else start
        if start < 0:
            continue
        lead = int(width * min(start, wall) / wall)
        span = max(1, int(width * max(0.0, end - start) / wall))
        bar = ("." * lead + "#" * span)[:width]
        extra = f" reason={row['reason']}" if row["reason"] else ""
        lines.append(
            f"  p{row['piece']:<5} {bar:<{width}} +{start:7.3f}s "
            f"{max(0.0, end - start) * 1000:7.1f}ms "
            f"x{row['attempts']} {row['status']}{extra} {row['parent']}")
    return "\n".join(lines)


# --------------------------------------------------------------------- #
# Flight digest: the compact, bounded form that ships off-host
# --------------------------------------------------------------------- #

# Hard byte budget for one shipped digest (serialized JSON). The daemon
# attaches one per task to its terminal announce message, so the bound is
# per TASK, not per piece — podlens_bench publishes the measured maximum.
DIGEST_MAX_BYTES = 16384

# Compact piece row order inside a digest (arrays, not dicts — at 64
# pieces the keys would dominate the byte budget):
# [piece, attempts, t_request, t_first_byte, t_landed, ok, reason, parent]
DIGEST_PIECE_FIELDS = ("piece", "attempts", "t_request", "t_first_byte",
                       "t_landed", "ok", "reason", "parent")


def _digest_encoded_len(d: dict) -> int:
    return len(json.dumps(d, separators=(",", ":")))


def digest(tf: TaskFlight, *, max_bytes: int = DIGEST_MAX_BYTES,
           max_pieces: int = 64, max_events: int = 96,
           max_segments: int = 64,
           clock_samples: "list | None" = None) -> dict:
    """Fold a task's ring into the compact digest the daemon ships to the
    scheduler on task completion/failure: phase totals + merged phase
    segments + a truncated piece waterfall + the newest named events,
    hard-capped at ``max_bytes`` of serialized JSON (pieces, events and
    segments are halved until the cap holds). ``clock_samples`` carries
    the announce-stream round-trip samples ([t0, t1, sched_echo] triples
    on this host's anchored wall clock) the scheduler's clock aligner
    consumes."""
    report = analyze(tf, max_waterfall=max_pieces,
                     max_segments=max_segments)
    pieces = [[r["piece"], r["attempts"], round(r["t_request"], 4),
               round(r["t_first_byte"], 4), round(r["t_landed"], 4),
               1 if r["status"] == "ok" else 0, r["reason"],
               r["parent"]] for r in report["pieces"]]
    events = [[round(t, 4), EVENT_NAMES.get(code, str(code)), piece,
               note] for t, code, piece, _aux, note
              in tf.events()[-max_events:]]
    d = {
        "v": 1,
        "task_id": tf.task_id,
        "state": tf.state,
        "note": tf.note[:200],
        "start_wall": round(tf.start_wall, 6),
        "wall_s": report["wall_s"],
        "phases": report["phases"],
        "other_s": report["other_s"],
        "dominant_phase": report["dominant_phase"],
        "segments": report["segments"],
        "pieces": pieces,
        "pieces_total": len(report["pieces"]),
        "pieces_truncated": report["pieces_truncated"],
        "events": events,
        "events_total": tf.events_total,
        "events_dropped": tf.events_dropped,
    }
    if clock_samples:
        d["clock"] = [[round(t0, 6), round(t1, 6), round(echo, 6)]
                      for t0, t1, echo in clock_samples[-4:]]
    # Byte cap: drop detail (events first — the segments/pieces carry the
    # analytic payload), never the phase totals.
    size = _digest_encoded_len(d)
    while size > max_bytes and (d["events"] or len(d["pieces"]) > 8
                                or len(d["segments"]) > 16):
        if d["events"]:
            d["events"] = d["events"][len(d["events"]) // 2:] \
                if len(d["events"]) > 8 else []
        elif len(d["pieces"]) > 8:
            d["pieces"] = d["pieces"][:len(d["pieces"]) // 2]
            d["pieces_truncated"] = True
        else:
            d["segments"] = d["segments"][:len(d["segments"]) // 2]
        size = _digest_encoded_len(d)
    d["bytes"] = size
    return d


def digest_piece_rows(d: dict) -> list:
    """Expand a digest's compact piece arrays back into dict rows."""
    return [dict(zip(DIGEST_PIECE_FIELDS, row))
            for row in d.get("pieces") or []]


# --------------------------------------------------------------------- #
# Recorder: the bounded per-process task index
# --------------------------------------------------------------------- #

class FlightRecorder:
    """Bounded index of TaskFlights. Eviction prefers finished tasks;
    the caps make "always-on" safe (memory is O(max_tasks * capacity)
    tuples regardless of how many tasks a daemon serves)."""

    def __init__(self, *, capacity: int = 2048, max_tasks: int = 128,
                 dump_dir: str = "", keep_bundles: int = 32,
                 wall_offset: float = 0.0):
        self.capacity = capacity
        self.max_tasks = max_tasks
        self.dump_dir = dump_dir
        self.keep_bundles = keep_bundles
        # Chaos/test knob: skew every wall stamp this recorder's flights
        # report (start_wall, clock samples) by a known amount — what the
        # pod-lens alignment e2e injects and must then recover.
        self.wall_offset = wall_offset
        # Latest fleet-scorecard row the scheduler returned for THIS host
        # (announcer stashes it each announce); embedded into post-mortem
        # bundles so a failure autopsy carries the subject host's
        # fleet-wide standing at failure time.
        self.scorecard_snapshot: dict = {}
        # Runtime observatory (pkg/prof), when this role armed one: its
        # pruned snapshot rides along in post-mortem bundles so a failed
        # task's autopsy shows what the PROCESS was doing, not just what
        # the task saw.
        self.runtime = None
        self._tasks: "OrderedDict[str, TaskFlight]" = OrderedDict()
        self._lock = threading.Lock()

    def task(self, task_id: str) -> TaskFlight:
        tf = self._tasks.get(task_id)
        if tf is not None:
            return tf
        with self._lock:
            tf = self._tasks.get(task_id)
            if tf is None:
                while len(self._tasks) >= self.max_tasks:
                    self._evict_one()
                tf = self._tasks[task_id] = TaskFlight(
                    task_id, self.capacity,
                    wall_offset=self.wall_offset)
        return tf

    def _evict_one(self) -> None:
        for tid, tf in self._tasks.items():
            if tf.state != "running":
                del self._tasks[tid]
                return
        self._tasks.popitem(last=False)

    def get(self, task_id: str) -> "TaskFlight | None":
        return self._tasks.get(task_id)

    def stamp_running(self, code: int, aux: float = 0.0,
                      note: str = "") -> None:
        """Record one event into EVERY running flight — how pkg/prof
        stamps runtime interference (a wedged loop, a slow GC pause)
        into the task windows it overlapped. Bounded by max_tasks."""
        for tf in list(self._tasks.values()):
            if tf.state == "running":
                tf.record(code, -1, aux, note)

    def summary(self) -> list:
        return [{"task_id": tf.task_id, "state": tf.state,
                 "wall_s": round(tf.wall_s(), 3),
                 "events": tf.events_total,
                 "events_dropped": tf.events_dropped}
                for tf in self._tasks.values()]

    def finish_task(self, task_id: str, state: str,
                    note: str = "") -> "TaskFlight | None":
        """Terminal transition: stamps the wall clock, feeds the phase
        histograms, and (on failure, with a dump dir configured) writes
        the post-mortem bundle. Idempotent per task."""
        tf = self._tasks.get(task_id)
        if tf is None or tf.state != "running":
            return tf
        tf.finish(state, note)
        report = analyze(tf)
        for ph in PHASES:
            v = report["phases"][ph]
            if v > 0:
                PHASE_SECONDS.labels(ph).observe(v)
        if state == "failed" and self.dump_dir:
            self._dump(tf, report)
        return tf

    def _dump(self, tf: TaskFlight, report: dict) -> None:
        """Post-mortem bundle: the autopsy + the raw (named) event
        timeline + this host's latest fleet-scorecard row, gzipped
        (bundles are JSON text — gzip is ~10x on event timelines), pruned
        to ``keep_bundles`` files. Best-effort — a full disk must never
        fail the task path that triggered the dump."""
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"flight-{tf.task_id[:16]}-"
                f"{int(time.time() * 1000)}.json.gz")
            bundle = {
                "report": report,
                "events": [
                    {"t": round(t, 6),
                     "event": EVENT_NAMES.get(code, str(code)),
                     "piece": piece, "aux": aux, "note": note}
                    for t, code, piece, aux, note in tf.events()],
            }
            if self.scorecard_snapshot:
                bundle["scorecard"] = dict(self.scorecard_snapshot)
            if self.runtime is not None:
                # Pruned prof snapshot + loop-lag/GC summary: best-effort
                # like the rest of the dump path.
                try:
                    bundle["runtime"] = self.runtime.postmortem()
                except Exception:
                    log.warning("runtime snapshot for bundle failed",
                                exc_info=True)
            with gzip.open(path, "wt") as f:
                json.dump(bundle, f)
            log.info("flight post-mortem dumped", task=tf.task_id[:16],
                     path=path)
            self._prune()
        except OSError:
            pass

    def _prune(self) -> None:
        """Newest-``keep_bundles`` rotation: a crash-looping task dumping
        a bundle per attempt must not grow the log volume forever. mtime
        orders; the filename's ms stamp breaks same-second ties. Counts
        ``.json`` (pre-gzip era) and ``.json.gz`` bundles alike — one
        budget, not one per extension."""

        def stamp(path: str) -> int:
            tail = path.rsplit("-", 1)[-1]
            for suffix in (".json.gz", ".json"):
                if tail.endswith(suffix):
                    tail = tail[:-len(suffix)]
                    break
            try:
                return int(tail)
            except ValueError:
                return 0

        try:
            bundles = sorted(
                (os.path.join(self.dump_dir, name)
                 for name in os.listdir(self.dump_dir)
                 if name.startswith("flight-")
                 and name.endswith((".json", ".json.gz"))),
                key=lambda p: (os.path.getmtime(p), stamp(p)))
            drop = bundles[:-self.keep_bundles] if self.keep_bundles > 0 \
                else bundles
            for path in drop:
                os.unlink(path)
        except OSError:
            pass


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def for_task(task_id: str) -> TaskFlight:
    """Get-or-create the default recorder's flight for ``task_id`` — the
    one call every instrumented choke point makes."""
    return _RECORDER.task(task_id)


def get(task_id: str) -> "TaskFlight | None":
    return _RECORDER.get(task_id)


# --------------------------------------------------------------------- #
# Pod-level aggregation (scheduler side)
# --------------------------------------------------------------------- #

class PodAggregator:
    """Per-task, per-host phase attribution from the piece reports'
    ``timings`` (proto/wire PIECE), plus typed failure / quarantine
    correlation — the ``/debug/pod/<task_id>`` straggler view. Bounded
    like the recorder: the oldest task aggregate is evicted past
    ``max_tasks``."""

    _PHASE_KEYS = ("dcn", "stall", "store")

    def __init__(self, max_tasks: int = 256):
        self.max_tasks = max_tasks
        self._tasks: "OrderedDict[str, dict]" = OrderedDict()

    def _task(self, task_id: str) -> dict:
        entry = self._tasks.get(task_id)
        if entry is None:
            while len(self._tasks) >= self.max_tasks:
                self._tasks.popitem(last=False)
            entry = self._tasks[task_id] = {"hosts": {}, "quarantine": []}
        return entry

    def _host(self, task_id: str, host_id: str) -> dict:
        hosts = self._task(task_id)["hosts"]
        h = hosts.get(host_id)
        if h is None:
            h = hosts[host_id] = {
                "pieces": 0,
                "ms": {k: 0 for k in self._PHASE_KEYS},
                "failures": {},
            }
        return h

    def note_piece(self, task_id: str, host_id: str,
                   timings: "dict | None", cost_ms: int = 0) -> None:
        h = self._host(task_id, host_id)
        h["pieces"] += 1
        ms = h["ms"]
        if timings:
            ms["dcn"] += int(timings.get("dcn_ms", 0) or 0)
            ms["stall"] += int(timings.get("stall_ms", 0) or 0)
            ms["store"] += int(timings.get("store_ms", 0) or 0)
        else:
            # Legacy report (no per-phase split): the whole cost is
            # transfer time.
            ms["dcn"] += int(cost_ms or 0)

    def note_pieces(self, task_id: str, host_id: str, n: int,
                    phase_ms) -> None:
        """Batch form of note_piece for the packed ingest fast path:
        ``n`` pieces with pre-summed (dcn, stall, store) milliseconds —
        untimed pieces already folded their whole cost into dcn
        (proto/reportcodec computes the sums with note_piece's exact
        semantics, so N note_piece calls and one note_pieces call land
        the same aggregate)."""
        h = self._host(task_id, host_id)
        h["pieces"] += n
        ms = h["ms"]
        ms["dcn"] += phase_ms[0]
        ms["stall"] += phase_ms[1]
        ms["store"] += phase_ms[2]

    def note_failure(self, task_id: str, host_id: str, reason: str) -> None:
        h = self._host(task_id, host_id)
        h["failures"][reason] = h["failures"].get(reason, 0) + 1

    def note_quarantine(self, task_id: str, host_id: str,
                        reason: str) -> None:
        q = self._task(task_id)["quarantine"]
        q.append({"host": host_id, "reason": reason})
        del q[:-64]   # bounded

    def report(self, task_id: str) -> "dict | None":
        entry = self._tasks.get(task_id)
        if entry is None:
            return None
        hosts = []
        totals = {k: 0 for k in self._PHASE_KEYS}
        for host_id, h in entry["hosts"].items():
            total_ms = sum(h["ms"].values())
            for k in self._PHASE_KEYS:
                totals[k] += h["ms"][k]
            dominant = max(self._PHASE_KEYS, key=lambda k: h["ms"][k]) \
                if total_ms else ""
            hosts.append({
                "host": host_id,
                "pieces": h["pieces"],
                "ms": dict(h["ms"]),
                "mean_piece_ms": round(total_ms / h["pieces"], 2)
                if h["pieces"] else 0.0,
                "dominant_phase": dominant,
                "failures": dict(h["failures"]),
            })
        hosts.sort(key=lambda h: -h["mean_piece_ms"])
        slowest = hosts[0]["host"] if hosts and hosts[0]["mean_piece_ms"] > 0 \
            else ""
        dominant = max(self._PHASE_KEYS, key=lambda k: totals[k]) \
            if any(totals.values()) else ""
        return {
            "task_id": task_id,
            "hosts": hosts,
            "slowest_host": slowest,
            "dominant_phase": dominant,
            "quarantine": list(entry["quarantine"]),
        }
