"""The runtime observatory, continuous in-process profiling for every
role: the port's copy of ``dragonfly2_tpu/pkg/prof.py``.

Three instruments behind one ``RuntimeObservatory``:

  * ``StackSampler``: a daemon thread (``df-prof-sampler``) walks
    ``sys._current_frames()`` at ``hz`` and folds each thread's stack
    into a bounded call-tree trie keyed by code object. Trie nodes are
    interned (a sample through an existing path allocates nothing in the
    trie) and the node budget is a hard cap with a truncation counter.
    Attribution is per thread name, which is why every long-lived thread
    of the port carries a ``df-`` prefix: the device sink's worker
    (``df-device-sink``), the piece fetchers (``df-piece-http``), the
    upload server (``df-upload``) separate at a glance.
  * ``LoopLagProbe``: a heartbeat task per asyncio loop; the delta
    between the intended and the actual wake is the loop's lag, kept in
    a preallocated ring and a bounded histogram. Ticks above ``slow_s``
    are stamped into every running task flight (``EV_LOOP_LAG``). The
    ring backs the ``loop_lag`` SLO (``pkg/slo`` kind "probe").
  * ``GCObservatory``: ``gc.callbacks`` pause histograms per generation
    and collection counters; pauses above ``gc_slow_s`` stamp
    ``EV_GC_PAUSE`` the same way. ``/proc/self`` gauges (RSS, open fds,
    threads, context switches) refresh on a snapshot.

Served by ``pkg/metrics_server`` on the daemon, the scheduler and the
manager:
  GET /debug/prof                       top-N self-time per thread (JSON)
  GET /debug/prof/flame?format=folded   flamegraph-ready folded stacks
  GET /debug/prof/runtime               loop lag + GC + /proc gauges

The observatory is a process singleton (``install()``/``release()``,
refcounted): a process embedding a daemon and a scheduler runs one
sampler thread and books each GC pause once.
"""

from __future__ import annotations

import asyncio
import gc
import os
import threading
import time
import sys
from dataclasses import dataclass

from dragonfly2_tpu_torch.pkg import dflog, metrics

log = dflog.get("prof")

SAMPLES_TOTAL = metrics.counter(
    "runtime_profiler_samples_total",
    "Sampling passes the stack profiler completed (one pass folds every "
    "live thread's stack into the bounded trie)")

TRUNCATED_TOTAL = metrics.counter(
    "runtime_profiler_truncated_total",
    "Stack folds cut short by the trie node cap — the bounded-memory "
    "degradation counter (raise max_nodes if this moves)")

LAG_SECONDS = metrics.histogram(
    "runtime_loop_lag_seconds",
    "Asyncio event-loop heartbeat lag (actual wake minus intended wake); "
    "the loop-wedge detector behind the loop_lag SLO",
    (), buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
             5.0))

SLOW_TICKS_TOTAL = metrics.counter(
    "runtime_loop_slow_ticks_total",
    "Heartbeat ticks whose lag crossed the slow-tick threshold (each one "
    "is also stamped into every running task flight as a typed event)")

GC_PAUSE_SECONDS = metrics.histogram(
    "runtime_gc_pause_seconds",
    "Cyclic-GC pause per collection, by generation (gc.callbacks "
    "start/stop delta)",
    ("generation",),
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0))

GC_COLLECTIONS_TOTAL = metrics.counter(
    "runtime_gc_collections_total",
    "Cyclic-GC collections observed by generation",
    ("generation",))

RSS_BYTES = metrics.gauge(
    "runtime_rss_bytes",
    "Resident set size from /proc/self/statm (refreshed on scrape)")

OPEN_FDS = metrics.gauge(
    "runtime_open_fds",
    "Open file descriptors from /proc/self/fd (refreshed on scrape)")

THREADS_GAUGE = metrics.gauge(
    "runtime_threads",
    "Live threads in this process (refreshed on scrape)")

CTX_SWITCHES = metrics.gauge(
    "runtime_ctx_switches",
    "Context switches from /proc/self/status by kind "
    "(voluntary/involuntary; cumulative counters mirrored as gauges)",
    ("kind",))


@dataclass
class ProfConfig:
    """Runtime-observatory knobs, the ``prof:`` block of the daemon's,
    the scheduler's and the manager's configs. On by default, as in the
    JAX package; ``enabled=False`` removes every hook."""

    enabled: bool = True
    hz: float = 19.0              # sampler passes per second
    max_nodes: int = 8192         # trie node hard cap (then truncation)
    max_depth: int = 48           # frames folded per stack
    lag_interval_s: float = 0.25  # heartbeat period per probed loop
    lag_slow_s: float = 0.25      # slow-tick threshold -> flight events
    gc_slow_s: float = 0.05       # GC pause threshold -> flight events
    lag_ring: int = 4096          # lag samples retained for the SLO probe


# Internal fixed bucket edges for the JSON-served lag/GC histograms
# (preallocated count arrays; the Prometheus families use their own).
_LAG_EDGES = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
              5.0)


def proc_stats() -> dict:
    """Best-effort /proc/self gauges; zeros off-Linux. Cheap enough to
    call per scrape (two small reads + one dirlist)."""
    out = {"rss_bytes": 0, "open_fds": 0, "threads": threading.active_count(),
           "voluntary_ctx_switches": 0, "involuntary_ctx_switches": 0}
    try:
        with open("/proc/self/statm") as f:
            out["rss_bytes"] = int(f.read().split()[1]) * os.sysconf(
                "SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        pass
    try:
        out["open_fds"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("voluntary_ctxt_switches:"):
                    out["voluntary_ctx_switches"] = int(line.split()[1])
                elif line.startswith("nonvoluntary_ctxt_switches:"):
                    out["involuntary_ctx_switches"] = int(line.split()[1])
    except (OSError, IndexError, ValueError):
        pass
    return out


# --------------------------------------------------------------------- #
# (a) Sampling stack profiler
# --------------------------------------------------------------------- #

class StackSampler:
    """Folded-stack trie fed by a sampling daemon thread.

    Trie nodes are ``[self_count, {code: child}]`` keyed by code object —
    interning by identity means a steady-state sample allocates nothing
    in OUR structures (``sys._current_frames`` itself builds one dict per
    pass; that is the floor). Node creation stops at ``max_nodes``; the
    overflow shows up in ``truncated`` instead of memory."""

    def __init__(self, hz: float = 19.0, max_nodes: int = 8192,
                 max_depth: int = 48):
        self.hz = max(0.5, float(hz))
        self.max_nodes = max_nodes
        self.max_depth = max_depth
        self.samples = 0
        self.truncated = 0
        self._roots: "dict[str, list]" = {}     # thread name -> node
        self._nodes = 0
        self._labels: dict = {}                 # code -> "file:func"
        self._stackbuf: list = [None] * max_depth
        self._names: "dict[int, str]" = {}      # ident -> thread name
        self._names_refreshed = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="df-prof-sampler")
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            with self._lock:
                self._sample_once()
            SAMPLES_TOTAL.inc()

    # -- the sampling pass -------------------------------------------------

    def _thread_name(self, ident: int, now: float) -> str:
        name = self._names.get(ident)
        if name is None or now - self._names_refreshed > 1.0:
            self._names = {t.ident: t.name for t in threading.enumerate()}
            self._names_refreshed = now
            name = self._names.get(ident)
        return name or f"tid-{ident}"

    def _sample_once(self) -> None:
        me = threading.get_ident()
        now = time.monotonic()
        buf = self._stackbuf
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            n = 0
            while frame is not None and n < self.max_depth:
                buf[n] = frame.f_code
                n += 1
                frame = frame.f_back
            name = self._thread_name(ident, now)
            node = self._roots.get(name)
            if node is None:
                node = self._roots[name] = [0, {}]
            truncated = False
            for i in range(n - 1, -1, -1):      # outermost first
                children = node[1]
                child = children.get(buf[i])
                if child is None:
                    if self._nodes >= self.max_nodes:
                        truncated = True
                        break
                    child = children[buf[i]] = [0, {}]
                    self._nodes += 1
                node = child
            node[0] += 1
            if truncated:
                self.truncated += 1
                TRUNCATED_TOTAL.inc()
        self.samples += 1

    @property
    def nodes(self) -> int:
        return self._nodes

    # -- rendering ---------------------------------------------------------

    def _label(self, code) -> str:
        label = self._labels.get(code)
        if label is None:
            label = self._labels[code] = (
                f"{os.path.basename(code.co_filename)}:{code.co_name}")
        return label

    def folded(self, max_lines: int = 4096) -> str:
        """Flamegraph-ready folded stacks: ``thread;frame;frame count``
        per line, leaf self-counts only (standard collapse format)."""
        lines: list = []
        with self._lock:
            for tname, root in sorted(self._roots.items()):
                stack = [tname]
                self._fold(root, stack, lines, max_lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def _fold(self, node: list, stack: list, out: list,
              max_lines: int) -> None:
        if len(out) >= max_lines:
            return
        if node[0] > 0:
            out.append(f"{';'.join(stack)} {node[0]}")
        for code, child in node[1].items():
            stack.append(self._label(code))
            self._fold(child, stack, out, max_lines)
            stack.pop()

    def report(self, topn: int = 20) -> dict:
        """Top-N self-time frames per thread plus sampler state — the
        ``/debug/prof`` JSON body."""
        threads: dict = {}
        with self._lock:
            for tname, root in self._roots.items():
                per_frame: "dict[str, int]" = {}
                total = self._self_counts(root, per_frame)
                top = sorted(per_frame.items(), key=lambda kv: -kv[1])[:topn]
                threads[tname] = {
                    "samples": total,
                    "top_self": [
                        {"frame": frame, "self": count,
                         "frac": round(count / total, 4) if total else 0.0}
                        for frame, count in top],
                }
            return {
                "hz": self.hz,
                "samples": self.samples,
                "nodes": self._nodes,
                "max_nodes": self.max_nodes,
                "truncated": self.truncated,
                "threads": threads,
            }

    def _self_counts(self, node: list, acc: dict) -> int:
        total = node[0]
        for code, child in node[1].items():
            if child[0] > 0:
                label = self._label(code)
                acc[label] = acc.get(label, 0) + child[0]
            total += self._self_counts(child, acc)
        return total

    def top_frames(self, n: int = 5) -> list:
        """Flat process-wide top self-time frames (fallback snapshots
        want one list, not a per-thread tree)."""
        acc: "dict[str, int]" = {}
        with self._lock:
            for root in self._roots.values():
                self._self_counts(root, acc)
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [{"frame": f, "self": c} for f, c in top]


# --------------------------------------------------------------------- #
# (b) Event-loop lag probe
# --------------------------------------------------------------------- #

class LoopLagProbe:
    """One heartbeat task per probed loop. A wedge of W seconds surfaces
    as ONE tick with ~W lag (the heartbeat self-reschedules), so the SLO
    probe counts wedged WALL TIME, not tick counts — immune to dilution
    by the healthy ticks around a stall."""

    def __init__(self, obs: "RuntimeObservatory", name: str,
                 interval_s: float = 0.25, slow_s: float = 0.25,
                 ring: int = 4096):
        self.obs = obs
        self.name = name
        self.interval_s = interval_s
        self.slow_s = slow_s
        self._ring: list = [None] * ring        # (mono_t, lag_s)
        self._cap = ring
        self._n = 0
        self.started_mono = time.monotonic()
        self.max_lag_s = 0.0
        self.slow_ticks = 0
        self._buckets = [0] * (len(_LAG_EDGES) + 1)
        self._task: "asyncio.Task | None" = None

    def arm(self) -> "LoopLagProbe":
        """Create the heartbeat on the RUNNING loop (call from it)."""
        loop = asyncio.get_running_loop()
        self.started_mono = time.monotonic()
        self._task = loop.create_task(self._beat(loop))
        try:
            self._task.set_name(f"df-prof-loop-{self.name}")
        except AttributeError:
            pass
        return self

    def disarm(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _beat(self, loop) -> None:
        interval = self.interval_s
        while True:
            t0 = loop.time()
            await asyncio.sleep(interval)
            lag = max(0.0, loop.time() - t0 - interval)
            self.note_lag(lag)

    def note_lag(self, lag: float) -> None:
        """One heartbeat observation (the async beat calls this; tests
        may feed synthetic ticks)."""
        self._ring[self._n % self._cap] = (time.monotonic(), lag)
        self._n += 1
        i = 0
        for edge in _LAG_EDGES:
            if lag <= edge:
                break
            i += 1
        self._buckets[i] += 1
        LAG_SECONDS.observe(lag)
        if lag > self.max_lag_s:
            self.max_lag_s = lag
        if lag >= self.slow_s:
            self.slow_ticks += 1
            SLOW_TICKS_TOTAL.inc()
            self.obs._stamp_flights_loop_lag(lag)

    # -- SLO feed ----------------------------------------------------------

    def wedged_seconds(self, window: float, threshold: float,
                       now: "float | None" = None) -> "tuple[float, float]":
        """(wedged, observed) wall-seconds over the trailing window: the
        pkg/slo kind="probe" good/bad fraction. Each retained tick whose
        lag crossed ``threshold`` contributes its full lag — the wall
        time the loop was not serving."""
        if now is None:
            now = time.monotonic()
        cutoff = now - window
        bad = 0.0
        oldest_seen = now
        newest = self._n - 1
        oldest = max(0, self._n - self._cap)
        i = newest
        while i >= oldest:
            row = self._ring[i % self._cap]
            i -= 1
            if row is None or row[0] < cutoff:
                break
            oldest_seen = row[0]
            if row[1] >= threshold:
                bad += row[1]
        observed = min(window, now - max(self.started_mono, cutoff))
        # A ring that wrapped inside the window shrinks what we can vouch
        # for to the retained span.
        if self._n > self._cap:
            observed = min(observed, now - oldest_seen)
        observed = max(0.0, observed)
        return min(bad, observed), observed

    def summary(self) -> dict:
        return {
            "name": self.name,
            "interval_s": self.interval_s,
            "slow_s": self.slow_s,
            "ticks": self._n,
            "max_lag_s": round(self.max_lag_s, 6),
            "slow_ticks": self.slow_ticks,
            "histogram": {
                "edges_s": list(_LAG_EDGES),
                "counts": list(self._buckets),
            },
        }


# --------------------------------------------------------------------- #
# (c) GC observatory
# --------------------------------------------------------------------- #

class GCObservatory:
    """gc.callbacks pause clock. Collections are not reentrant, so one
    start stamp per observatory suffices; the callback runs on whatever
    thread triggered the collection — everything it touches is a scalar
    store or a bounded bucket increment."""

    _GENS = ("0", "1", "2")

    def __init__(self, obs: "RuntimeObservatory", slow_s: float = 0.05):
        self.obs = obs
        self.slow_s = slow_s
        self.collections = [0, 0, 0]
        self.collected = 0
        self.uncollectable = 0
        self.max_pause_s = 0.0
        self.slow_pauses = 0
        self._pause_sum = [0.0, 0.0, 0.0]
        self._start_pc = -1.0
        self._armed = False
        self._pause_children = [GC_PAUSE_SECONDS.labels(g)
                                for g in self._GENS]
        self._count_children = [GC_COLLECTIONS_TOTAL.labels(g)
                                for g in self._GENS]

    def arm(self) -> None:
        if not self._armed:
            gc.callbacks.append(self._cb)
            self._armed = True

    def disarm(self) -> None:
        if self._armed:
            try:
                gc.callbacks.remove(self._cb)
            except ValueError:
                pass
            self._armed = False

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start_pc = time.perf_counter()
            return
        if self._start_pc < 0:
            return
        pause = time.perf_counter() - self._start_pc
        self._start_pc = -1.0
        gen = min(2, max(0, int(info.get("generation", 0))))
        self.collections[gen] += 1
        self._pause_sum[gen] += pause
        self.collected += int(info.get("collected", 0))
        self.uncollectable += int(info.get("uncollectable", 0))
        if pause > self.max_pause_s:
            self.max_pause_s = pause
        self._pause_children[gen].observe(pause)
        self._count_children[gen].inc()
        if pause >= self.slow_s:
            self.slow_pauses += 1
            self.obs._stamp_flights_gc(pause)

    def summary(self) -> dict:
        return {
            "collections": list(self.collections),
            "pause_sum_s": [round(v, 6) for v in self._pause_sum],
            "max_pause_s": round(self.max_pause_s, 6),
            "slow_pauses": self.slow_pauses,
            "slow_s": self.slow_s,
            "collected": self.collected,
            "uncollectable": self.uncollectable,
            "tracked": gc.get_count(),
        }


# --------------------------------------------------------------------- #
# The umbrella + process singleton
# --------------------------------------------------------------------- #

class RuntimeObservatory:
    """Sampler + per-loop lag probes + GC observatory behind one handle.
    ``recorder`` (a pkg/flight.FlightRecorder) is where slow ticks and
    slow GC pauses land as typed events; roles without a recorder
    (scheduler) just skip the stamping."""

    def __init__(self, cfg: "ProfConfig | None" = None, recorder=None):
        self.cfg = cfg or ProfConfig()
        self.recorder = recorder
        self.sampler = StackSampler(self.cfg.hz, self.cfg.max_nodes,
                                    self.cfg.max_depth)
        self.gc = GCObservatory(self, self.cfg.gc_slow_s)
        self.probes: "dict[str, LoopLagProbe]" = {}
        self.started_wall = time.time()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.sampler.start()
        self.gc.arm()

    def stop(self) -> None:
        for probe in self.probes.values():
            probe.disarm()
        self.probes.clear()
        self.gc.disarm()
        self.sampler.stop()

    def arm_loop(self, name: str = "main") -> LoopLagProbe:
        """Attach a lag probe to the RUNNING loop (call from it). One
        probe per name; re-arming a name replaces the old probe."""
        old = self.probes.get(name)
        if old is not None:
            old.disarm()
        probe = LoopLagProbe(
            self, name, self.cfg.lag_interval_s, self.cfg.lag_slow_s,
            self.cfg.lag_ring)
        self.probes[name] = probe
        return probe.arm()

    # -- flight stamping ---------------------------------------------------

    def _stamp_flights_loop_lag(self, lag: float) -> None:
        rec = self.recorder
        if rec is not None:
            from dragonfly2_tpu_torch.pkg import flight as flightlib

            rec.stamp_running(flightlib.EV_LOOP_LAG, lag, "loop_lag")

    def _stamp_flights_gc(self, pause: float) -> None:
        rec = self.recorder
        if rec is not None:
            from dragonfly2_tpu_torch.pkg import flight as flightlib

            rec.stamp_running(flightlib.EV_GC_PAUSE, pause, "gc_pause")

    # -- SLO feed ----------------------------------------------------------

    def slo_probes(self) -> dict:
        """pkg/slo kind="probe" callables, keyed by spec field."""
        return {"loop_lag": self._loop_lag_counts}

    def _loop_lag_counts(self, window: float,
                         threshold: float) -> "tuple[float, float]":
        bad = total = 0.0
        for probe in self.probes.values():
            b, t = probe.wedged_seconds(window, threshold)
            bad += b
            total += t
        return bad, total

    # -- reports -----------------------------------------------------------

    def runtime_report(self) -> dict:
        """/debug/prof/runtime: loop lag + GC + /proc gauges (and the
        Prometheus runtime_* gauges refresh here too — scrape-time, not
        continuous)."""
        proc = proc_stats()
        RSS_BYTES.set(proc["rss_bytes"])
        OPEN_FDS.set(proc["open_fds"])
        THREADS_GAUGE.set(proc["threads"])
        CTX_SWITCHES.labels("voluntary").set(
            proc["voluntary_ctx_switches"])
        CTX_SWITCHES.labels("involuntary").set(
            proc["involuntary_ctx_switches"])
        return {
            "loops": [p.summary() for p in self.probes.values()],
            "gc": self.gc.summary(),
            "proc": proc,
            "uptime_s": round(time.time() - self.started_wall, 1),
        }

    def profile_report(self, topn: int = 20) -> dict:
        return self.sampler.report(topn)

    def folded(self, max_lines: int = 4096) -> str:
        return self.sampler.folded(max_lines)

    def postmortem(self, topn: int = 10) -> dict:
        """Pruned snapshot for flight post-mortem bundles: what the
        PROCESS was doing when the task died — top frames per thread,
        loop-lag and GC summaries, proc gauges."""
        prof = self.sampler.report(topn)
        return {
            "prof": {
                "samples": prof["samples"],
                "truncated": prof["truncated"],
                "threads": {
                    name: t["top_self"][:topn]
                    for name, t in prof["threads"].items() if t["top_self"]
                },
            },
            "loops": [p.summary() for p in self.probes.values()],
            "gc": self.gc.summary(),
            "proc": proc_stats(),
        }


_OBS: "RuntimeObservatory | None" = None
_REFS = 0
_OBS_LOCK = threading.Lock()


def install(cfg: "ProfConfig | None" = None,
            recorder=None) -> RuntimeObservatory:
    """Get-or-create the process observatory (refcounted — pair every
    install with a release). The first caller's config wins; a recorder
    attaches whenever one is offered and none is set."""
    global _OBS, _REFS
    with _OBS_LOCK:
        if _OBS is None:
            _OBS = RuntimeObservatory(cfg)
            _OBS.start()
        if recorder is not None and _OBS.recorder is None:
            _OBS.recorder = recorder
        _REFS += 1
        return _OBS


def release(obs: RuntimeObservatory) -> None:
    global _OBS, _REFS
    with _OBS_LOCK:
        if obs is not _OBS:
            obs.stop()      # a privately-constructed observatory
            return
        _REFS -= 1
        if _REFS <= 0:
            _OBS, _REFS = None, 0
            obs.stop()


def observatory() -> "RuntimeObservatory | None":
    return _OBS


def fallback_snapshot(top: int = 5) -> dict:
    """Runtime snapshot for a structured device fallback: where the
    probe attempt spent its wall time (sampler top frames), RSS, and
    loop lag if a probe is armed. Works unarmed (frames empty)."""
    obs = _OBS
    proc = proc_stats()
    out = {
        "rss_mb": round(proc["rss_bytes"] / 1e6, 1),
        "open_fds": proc["open_fds"],
        "threads": proc["threads"],
        "samples": 0,
        "top_self": [],
        "max_loop_lag_ms": None,
        "gc_collections": None,
    }
    if obs is not None:
        out["samples"] = obs.sampler.samples
        out["top_self"] = obs.sampler.top_frames(top)
        out["gc_collections"] = sum(obs.gc.collections)
        if obs.probes:
            out["max_loop_lag_ms"] = round(
                max(p.max_lag_s for p in obs.probes.values()) * 1000, 2)
    return out
