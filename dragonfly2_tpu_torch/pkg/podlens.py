"""The pod lens: cross-host merged broadcast timelines with clock
alignment, the port's copy of ``dragonfly2_tpu/pkg/podlens.py``.

  * ``ClockEstimator``: a per-host clock offset from announce round-trip
    samples. The daemon stamps ``t0``/``t1`` (its anchored wall clock,
    ``pkg/flight.anchored_wall``) around an announce whose answer carried
    the scheduler's ``sched_wall`` echo; the NTP midpoint gives ``offset
    = (t0 + t1) / 2 - echo`` with the bound ``|true - est| <= rtt / 2``,
    which the estimator carries.
  * ``PodLens``: a bounded per-task store of the flight digests daemons
    ship when a task ends (``pkg/flight.digest``), merged by
    ``timeline()`` into one wall-aligned pod report: per-host phase
    segments in the scheduler's clock domain, the slowest host, the
    pod-dominant phase and the worst alignment bound.
  * ``render_timeline``: the per-host phase-coloured lag waterfall
    (``/debug/pod/<task_id>/timeline?format=text``, ``dfget --pod``).
  * ``completion_stats``: the SLO engine's per-completion SLIs of one
    digest.

Each host's reduction is kept as MessagePack bytes packed by the port's
codec (``rpc/codec.py``), byte for byte what the JAX module's
``msgpack.packb`` keeps, so ``resident_bytes`` and the LRU cut agree.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from dragonfly2_tpu_torch.pkg import dflog
from dragonfly2_tpu_torch.pkg.fleet import _deep_bytes
from dragonfly2_tpu_torch.pkg.flight import PHASES
from dragonfly2_tpu_torch.rpc import codec

log = dflog.get("podlens")

# Worst-case relative drift between two anchored monotonic clocks, used
# to age a sample's error bound (crystal oscillators drift ~10-100 ppm;
# 200 keeps the bound honest on throttled VMs).
DRIFT_PPM = 200.0
# Floor on any reported alignment bound: scheduling jitter between "stamp
# taken" and "message on the wire" is real even on loopback.
MIN_ERR_S = 0.002
# Offset assumed for a host with no samples at all (bound, not estimate).
UNALIGNED_ERR_S = 1.0


class ClockEstimator:
    """Per-host offset (host_wall - sched_wall) with carried uncertainty.

    ``add_sample`` is O(1); hosts are LRU-capped. The estimate picks the
    sample with the smallest AGED bound (rtt/2 + age * drift): a tight
    old sample eventually loses to a looser fresh one, so a rebooted
    host's stale offset cannot linger."""

    def __init__(self, *, max_hosts: int = 4096, keep: int = 4,
                 clock=time.monotonic):
        self.max_hosts = max_hosts
        self.keep = keep
        self._clock = clock
        # host -> list of [offset, rtt/2, taken_at] (newest last)
        self._hosts: "OrderedDict[str, list]" = OrderedDict()

    def add_sample(self, host_id: str, t0: float, t1: float,
                   echo: float) -> bool:
        """One round trip: host stamped ``t0`` at send and ``t1`` at
        response receipt (its anchored wall clock); the response carried
        the scheduler's ``echo`` wall stamp. Rejects malformed samples
        (negative rtt, missing echo) instead of poisoning the estimate."""
        rtt = t1 - t0
        if rtt < 0 or echo <= 0 or t0 <= 0:
            return False
        samples = self._hosts.get(host_id)
        if samples is None:
            while len(self._hosts) >= self.max_hosts:
                self._hosts.popitem(last=False)
            samples = self._hosts[host_id] = []
        else:
            self._hosts.move_to_end(host_id)
        samples.append([(t0 + t1) / 2.0 - echo, rtt / 2.0, self._clock()])
        del samples[:-self.keep]
        return True

    def estimate(self, host_id: str) -> "tuple[float, float, int]":
        """(offset_s, err_bound_s, n_samples). Unknown hosts report
        offset 0 with the UNALIGNED bound — the merge stays usable, the
        printed bound stays honest."""
        samples = self._hosts.get(host_id)
        if not samples:
            return 0.0, UNALIGNED_ERR_S, 0
        now = self._clock()
        best = min(samples,
                   key=lambda s: s[1] + max(0.0, now - s[2])
                   * DRIFT_PPM * 1e-6)
        err = best[1] + max(0.0, now - best[2]) * DRIFT_PPM * 1e-6
        return best[0], max(MIN_ERR_S, err), len(samples)

    def hosts_tracked(self) -> int:
        return len(self._hosts)


def completion_stats(d: dict) -> "tuple[float, float, float]":
    """(makespan_s, ttfb_s, stall_frac) of one shipped digest — the SLO
    engine's per-completion SLIs. TTFB = earliest first-byte (or landed)
    mark; -1 when the digest carries no piece rows. Reads the compact
    piece arrays in place (this runs once per task completion on the
    scheduler's ingest path — no row dicts)."""
    wall = float(d.get("wall_s") or 0.0)
    phases = d.get("phases") or {}
    stall_frac = (phases.get("stall", 0.0) / wall) if wall > 0 else 0.0
    ttfb = -1.0
    for row in d.get("pieces") or ():
        # Row layout: DIGEST_PIECE_FIELDS — t_first_byte at 3, t_landed
        # at 4.
        try:
            t = row[3] if row[3] >= 0 else row[4]
        except (TypeError, IndexError):
            continue
        if t >= 0 and (ttfb < 0 or t < ttfb):
            ttfb = t
    return wall, ttfb, stall_frac


class PodLens:
    """Bounded store of shipped flight digests + the clock estimator,
    merged on demand into the cross-host timeline.

    Retention is a REDUCTION, not the raw digest: the merge needs the
    phase totals, the merged phase segments and the counts — not the
    per-piece waterfall or the named events (those stay on the host at
    ``/debug/flight`` and come back whole via an on-demand
    ``Daemon.FlightReport`` pull). The reduction is stored as one
    MessagePack bytes object per host: a live dict per digest would hand
    every cyclic-GC pass the whole store to rescan. Reads (timelines,
    rare) decode on demand."""

    # Digest keys the merge consumes — everything else is dropped at
    # ingest (the reduction that keeps the store and the GC honest).
    _KEEP = ("v", "task_id", "state", "note", "start_wall", "wall_s",
             "phases", "other_s", "dominant_phase", "segments",
             "pieces_total", "pieces_truncated", "events_total",
             "events_dropped")
    _MAX_SEGMENTS = 48

    def __init__(self, *, max_tasks: int = 256,
                 clock_estimator: "ClockEstimator | None" = None):
        self.max_tasks = max_tasks
        self.clock = clock_estimator or ClockEstimator()
        # task_id -> {host_id: (peer_id, MessagePack bytes of the reduction)}
        self._tasks: "OrderedDict[str, dict]" = OrderedDict()

    def note_flight(self, task_id: str, host_id: str, d: dict,
                    peer_id: str = "") -> None:
        """Ingest one shipped digest (terminal announce message or an
        on-demand ``Daemon.FlightReport`` pull). Clock samples ride the
        digest; they feed the estimator here."""
        if not isinstance(d, dict):
            return
        for sample in d.get("clock") or []:
            try:
                t0, t1, echo = sample
                self.clock.add_sample(host_id, float(t0), float(t1),
                                      float(echo))
            except (TypeError, ValueError):
                continue
        entry = self._tasks.get(task_id)
        if entry is None:
            while len(self._tasks) >= self.max_tasks:
                self._tasks.popitem(last=False)
            entry = self._tasks[task_id] = {}
        keep = {k: d[k] for k in self._KEEP if k in d}
        keep["pieces_total"] = d.get("pieces_total",
                                     len(d.get("pieces") or ()))
        segs = keep.get("segments")
        if segs and len(segs) > self._MAX_SEGMENTS:
            keep["segments"] = segs[:self._MAX_SEGMENTS]
        try:
            raw = codec.packb(keep)
        except (TypeError, ValueError):
            return                      # unserializable digest: drop
        entry[host_id] = (peer_id, raw)

    def digests_for(self, task_id: str) -> dict:
        """Decoded shipped digest reductions ({host_id: dict})."""
        out = {}
        for host_id, (peer_id, raw) in (self._tasks.get(task_id)
                                        or {}).items():
            d = codec.unpackb(raw)
            if peer_id:
                d["peer_id"] = peer_id
            out[host_id] = d
        return out

    def shipped_hosts(self, task_id: str) -> set:
        """Hosts whose digest already arrived (no decode — the pull-
        budget check on the timeline path)."""
        return set(self._tasks.get(task_id) or ())

    def tasks(self) -> list:
        return [{"task_id": tid, "hosts": len(hosts)}
                for tid, hosts in self._tasks.items()]

    def timeline(self, task_id: str,
                 extra: "dict | None" = None) -> "dict | None":
        """The merged pod timeline: every host's digest aligned into the
        scheduler's wall domain (host_wall - offset). ``extra`` holds
        digests pulled on demand for hosts that never shipped one (they
        merge but are not retained). None when no digest is known."""
        digests = self.digests_for(task_id)
        for host_id, d in (extra or {}).items():
            if isinstance(d, dict):
                digests.setdefault(host_id, d)
        if not digests:
            return None
        hosts = []
        totals = {ph: 0.0 for ph in PHASES}
        err_max = 0.0
        t0_pod = None
        end_pod = 0.0
        for host_id, d in digests.items():
            offset, err, n_samples = self.clock.estimate(host_id)
            start = float(d.get("start_wall") or 0.0) - offset
            wall = float(d.get("wall_s") or 0.0)
            phases = {ph: float((d.get("phases") or {}).get(ph, 0.0))
                      for ph in PHASES}
            for ph, v in phases.items():
                totals[ph] += v
            err_max = max(err_max, err)
            if t0_pod is None or start < t0_pod:
                t0_pod = start
            end_pod = max(end_pod, start + wall)
            hosts.append({
                "host": host_id,
                "peer_id": d.get("peer_id", ""),
                "state": d.get("state", ""),
                "start_wall": round(start, 6),
                "wall_s": round(wall, 6),
                "phases": {ph: round(v, 6) for ph, v in phases.items()},
                "other_s": d.get("other_s", 0.0),
                "dominant_phase": d.get("dominant_phase", ""),
                "segments": d.get("segments") or [],
                "pieces": d.get("pieces_total",
                                len(d.get("pieces") or ())),
                "events_dropped": d.get("events_dropped", 0),
                "clock_offset_s": round(offset, 6),
                "align_err_s": round(err, 6),
                "clock_samples": n_samples,
            })
        t0_pod = t0_pod or 0.0
        for h in hosts:
            h["t_start"] = round(h["start_wall"] - t0_pod, 6)
        # Slowest = the host whose own task wall was longest (alignment
        # error cannot flip it, unlike last-finisher ordering would).
        hosts.sort(key=lambda h: -h["wall_s"])
        slowest = hosts[0]["host"] if hosts and hosts[0]["wall_s"] > 0 \
            else ""
        dominant = max(PHASES, key=lambda p: totals[p]) \
            if any(v > 0 for v in totals.values()) else ""
        return {
            "task_id": task_id,
            "hosts": hosts,
            "hosts_total": len(hosts),
            "t0_wall": round(t0_pod, 6),
            "span_s": round(max(0.0, end_pod - t0_pod), 6),
            "slowest_host": slowest,
            "dominant_phase": dominant,
            "phase_totals": {ph: round(v, 6) for ph, v in totals.items()},
            "align_err_max_s": round(err_max, 6),
        }

    def resident_bytes(self) -> int:
        return _deep_bytes(self._tasks) + _deep_bytes(self.clock._hosts)


# --------------------------------------------------------------------- #
# Text rendering: the per-host phase-colored lag waterfall
# --------------------------------------------------------------------- #

PHASE_CHARS = {"sched_wait": ".", "dcn": "=", "ici": "~", "verify": "v",
               "store": "s", "stall": "!", "origin": "o"}


def render_timeline(report: dict, width: int = 48) -> str:
    """One wall-aligned bar per host, phase-colored; the slowest host is
    starred and the alignment error bound is printed so nobody reads
    sub-bound lead/lag differences as real. The SAME renderer backs
    ``/debug/pod/<task_id>/timeline?format=text`` and ``dfget --pod``."""
    span = report["span_s"] or 1e-9
    lines = [
        f"pod {report['task_id'][:40]} hosts={report['hosts_total']} "
        f"span={report['span_s']:.3f}s "
        f"slowest={report['slowest_host'] or '-'} "
        f"dominant={report['dominant_phase'] or '-'} "
        f"align_err<={report['align_err_max_s'] * 1000:.1f}ms",
        "legend: " + " ".join(f"{c}={ph}"
                              for ph, c in PHASE_CHARS.items()),
    ]
    for h in report["hosts"]:
        bar = [" "] * width
        base = h["t_start"]
        for seg in h["segments"]:
            try:
                s, e, ph = seg
            except (TypeError, ValueError):
                continue
            c = PHASE_CHARS.get(ph, "?")
            lo = int(width * min(max(base + s, 0.0), span) / span)
            hi = int(width * min(max(base + e, 0.0), span) / span)
            for i in range(lo, max(hi, lo + 1)):
                if i < width:
                    bar[i] = c
        mark = "*" if h["host"] == report["slowest_host"] else " "
        lines.append(
            f" {mark}{h['host'][:28]:<28} |{''.join(bar)}| "
            f"+{h['t_start']:6.3f}s wall={h['wall_s']:7.3f}s "
            f"{h['dominant_phase'] or '-':<10} "
            f"off={h['clock_offset_s'] * 1000:+7.1f}ms "
            f"±{h['align_err_s'] * 1000:.1f}ms")
    return "\n".join(lines)
