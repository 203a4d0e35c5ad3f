"""Distributed tracing: spans, context propagation, JSONL and OTLP
export. The port's copy of ``dragonfly2_tpu/pkg/tracing.py``.

A W3C-traceparent context rides drpc frame metadata (``md``: dfget ->
daemon -> scheduler -> seed peer) and the piece HTTP hop's
``traceparent`` header (a child -> its parent's upload server), scoped
by a ``contextvars`` variable. Finished spans go to a ring, to a JSONL
file (``DF_TRACE_FILE``) and, with ``DF_TRACE_OTLP_ENDPOINT`` (e.g.
``http://collector:4318``) or ``exporter().set_otlp()``, to any OTLP/HTTP
JSON collector, pushed by a ``df-otlp-export`` thread on
``urllib.request``. The wire forms are the JAX module's, so a JAX peer
and a port peer join one trace. One difference, intended: the OTLP
payload's instrumentation scope is named after this module.

A span's context does not cross threads by itself: code that hands work
to a thread injects on the loop (``inject()``) and passes the headers.
"""

from __future__ import annotations

import contextvars
import json
import os
import queue as _queue
import secrets
import threading
import time
import urllib.request
from contextlib import contextmanager
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.pkg import metrics as _metrics

# Exporter health on the standard scrape surface: silent span loss
# (queue-full, unreachable collector) must be visible in /metrics, not
# only on the exporter object.
OTLP_SPANS = _metrics.counter(
    "tracing_otlp_spans_total",
    "OTLP span export outcomes (sent = landed in the collector, "
    "dropped = queue overflow / unreachable collector / closed exporter)",
    ("result",))

_current: contextvars.ContextVar["SpanContext | None"] = contextvars.ContextVar(
    "df_trace_ctx", default=None)

TRACEPARENT = "traceparent"


@dataclass(frozen=True)
class SpanContext:
    trace_id: str     # 32 hex
    span_id: str      # 16 hex

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, value: str) -> "SpanContext | None":
        parts = value.split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        return cls(trace_id=parts[1], span_id=parts[2])


@dataclass
class Span:
    name: str
    context: SpanContext
    parent_id: str = ""
    start: float = field(default_factory=time.time)
    end: float = 0.0
    attrs: dict = field(default_factory=dict)
    status: str = "ok"
    # Monotonic anchor: duration derives from perf_counter, never from two
    # wall-clock reads — an NTP step mid-span must not produce negative or
    # garbage durations. ``start`` stays wall clock for export anchoring;
    # ``end`` is reconstructed as start + monotonic duration so exported
    # timestamps and duration_ms can never disagree.
    start_pc: float = field(default_factory=time.perf_counter)
    duration_s: float = 0.0

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def finish(self, status: str = "") -> None:
        self.duration_s = max(0.0, time.perf_counter() - self.start_pc)
        self.end = self.start + self.duration_s
        if status:
            self.status = status
        _EXPORTER.export(self)

    def to_json(self) -> dict:
        return {"name": self.name, "trace_id": self.context.trace_id,
                "span_id": self.context.span_id, "parent_id": self.parent_id,
                "start": self.start, "end": self.end,
                "duration_ms": round(self.duration_s * 1000, 3),
                "attrs": self.attrs, "status": self.status}


def _otlp_attr_value(value) -> dict:
    """Map a python attr to an OTLP AnyValue (proto3 JSON form)."""
    if isinstance(value, bool):
        return {"boolValue": value}
    if isinstance(value, int):
        return {"intValue": str(value)}   # int64 rides as a JSON string
    if isinstance(value, float):
        return {"doubleValue": value}
    return {"stringValue": str(value)}


def otlp_payload(spans: "list[Span]", service_name: str) -> dict:
    """OTLP/JSON ExportTraceServiceRequest for ``spans``. The OTLP JSON
    mapping special-cases trace/span ids as HEX strings (not the generic
    proto3 base64-bytes rule), status code 1=OK 2=ERROR, and int64s as
    decimal strings."""
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeSpans": [{
            "scope": {"name": "dragonfly2_tpu_torch.pkg.tracing"},
            "spans": [{
                "traceId": s.context.trace_id,
                "spanId": s.context.span_id,
                **({"parentSpanId": s.parent_id} if s.parent_id else {}),
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(int(s.start * 1e9)),
                "endTimeUnixNano": str(int(s.end * 1e9)),
                "attributes": [{"key": k, "value": _otlp_attr_value(v)}
                               for k, v in s.attrs.items()],
                "status": {"code": 1 if s.status == "ok" else 2,
                           **({} if s.status == "ok"
                              else {"message": s.status})},
            } for s in spans],
        }],
    }]}


class OTLPExporter:
    """Background OTLP/HTTP JSON push to ``{endpoint}/v1/traces``.

    Dependency-free (urllib on a daemon thread), never blocks the traced
    code path: finished spans enqueue; the worker batches up to
    ``batch_max`` per POST and drops on the floor when the collector is
    unreachable (tracing must never become a data-plane liability).
    """

    def __init__(self, endpoint: str, *, service_name: str = "",
                 flush_interval: float = 1.0, batch_max: int = 256,
                 timeout: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = (service_name
                             or os.environ.get("DF_SERVICE_NAME", "")
                             or "dragonfly2-tpu")
        self.flush_interval = flush_interval
        self.batch_max = batch_max
        self.timeout = timeout
        self.sent_spans = 0
        self.dropped_spans = 0
        self._q: _queue.Queue = _queue.Queue(maxsize=8192)
        self._stop = threading.Event()
        # In-flight accounting: a span is "unfinished" from enqueue until
        # its POST attempt completes (task_done in _run). flush() waits on
        # this, not on queue-emptiness — the queue empties the moment the
        # worker POPS a batch, while the POST for it can run another 5 s.
        self._done_cv = threading.Condition()
        self._unfinished = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="df-otlp-export")
        self._thread.start()

    def enqueue(self, span: "Span") -> None:
        if self._stop.is_set():
            self._drop(1)   # closed: no worker will ever post it
            return
        # Count BEFORE the put: the worker may pop and task_done between a
        # put and a later increment, driving the counter negative and
        # letting a concurrent flush() return while a span it should wait
        # for is still in flight.
        with self._done_cv:
            self._unfinished += 1
        try:
            self._q.put_nowait(span)
        except _queue.Full:
            self._drop(1)
            self._task_done(1)

    def _task_done(self, n: int) -> None:
        with self._done_cv:
            self._unfinished -= n
            self._done_cv.notify_all()

    def _drop(self, n: int) -> None:
        self.dropped_spans += n
        OTLP_SPANS.labels("dropped").inc(n)

    def _drain_batch(self) -> "list[Span]":
        batch: list[Span] = []
        try:
            batch.append(self._q.get(timeout=self.flush_interval))
            while len(batch) < self.batch_max:
                batch.append(self._q.get_nowait())
        except _queue.Empty:
            pass
        return batch

    def _post(self, batch: "list[Span]") -> None:
        body = json.dumps(
            otlp_payload(batch, self.service_name)).encode()
        req = urllib.request.Request(
            f"{self.endpoint}/v1/traces", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                self.sent_spans += len(batch)
                OTLP_SPANS.labels("sent").inc(len(batch))
        except OSError:
            self._drop(len(batch))

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._drain_batch()
            if batch:
                try:
                    self._post(batch)
                except Exception:
                    # The contract is "drop on the floor", never die: a
                    # malformed endpoint (ValueError from urllib) must not
                    # kill the worker and silently wedge export forever.
                    self._drop(len(batch))
                finally:
                    self._task_done(len(batch))
        # Stop raced a final enqueue: whatever is still queued will never
        # post — account it as dropped so no flush() waits forever.
        tail = 0
        while True:
            try:
                self._q.get_nowait()
                tail += 1
            except _queue.Empty:
                break
        if tail:
            self._drop(tail)
            self._task_done(tail)

    def flush(self, timeout: float = 5.0) -> None:
        """Wait until every span enqueued so far has finished its POST
        attempt (sent or dropped), up to ``timeout`` — queue-empty alone is
        not done: the worker pops a batch before POSTing it, and that POST
        can hold the final batch in flight for seconds (tests, shutdown,
        set_otlp re-point)."""
        deadline = time.monotonic() + timeout
        with self._done_cv:
            while self._unfinished > 0:
                left = deadline - time.monotonic()
                if left <= 0 or not self._done_cv.wait(timeout=min(left, 0.1)):
                    if time.monotonic() >= deadline:
                        return

    def close(self) -> None:
        self.flush(timeout=2.0)
        self._stop.set()
        # Join the worker: it wakes within flush_interval (the blocking
        # get's timeout) and exits; a close() that returns while the
        # thread still runs could post after the process tears down the
        # endpoint (or interleave with a re-pointed exporter).
        self._thread.join(timeout=self.flush_interval + self.timeout + 1.0)


class Exporter:
    """Ring buffer + optional JSONL file (DF_TRACE_FILE or set_file()) +
    optional OTLP/HTTP push (DF_TRACE_OTLP_ENDPOINT or set_otlp())."""

    _OTLP_UNSET = object()   # distinct from None: None = explicitly disabled

    def __init__(self, capacity: int = 2048):
        self.capacity = capacity
        self.spans: list[Span] = []
        self._path = os.environ.get("DF_TRACE_FILE", "")
        self._otlp = Exporter._OTLP_UNSET

    def set_file(self, path: str) -> None:
        self._path = path

    def set_otlp(self, endpoint: str, **kwargs) -> "OTLPExporter | None":
        """Enable (or re-point) the OTLP push; empty endpoint disables —
        and STAYS disabled even when DF_TRACE_OTLP_ENDPOINT is set (the
        explicit call outranks the env default)."""
        if isinstance(self._otlp, OTLPExporter):
            self._otlp.close()
        self._otlp = OTLPExporter(endpoint, **kwargs) if endpoint else None
        return self._otlp

    @property
    def otlp(self) -> "OTLPExporter | None":
        if self._otlp is Exporter._OTLP_UNSET:
            endpoint = os.environ.get("DF_TRACE_OTLP_ENDPOINT", "")
            self._otlp = OTLPExporter(endpoint) if endpoint else None
        return self._otlp

    def export(self, span: Span) -> None:
        self.spans.append(span)
        if len(self.spans) > self.capacity:
            del self.spans[: len(self.spans) - self.capacity]
        path = self._path or os.environ.get("DF_TRACE_FILE", "")
        if path:
            try:
                with open(path, "a") as f:
                    f.write(json.dumps(span.to_json()) + "\n")
            except OSError:
                pass
        otlp = self.otlp
        if otlp is not None:
            otlp.enqueue(span)

    def find(self, name: str = "", trace_id: str = "") -> list[Span]:
        return [s for s in self.spans
                if (not name or s.name == name)
                and (not trace_id or s.context.trace_id == trace_id)]

    def clear(self) -> None:
        self.spans.clear()


_EXPORTER = Exporter()


def exporter() -> Exporter:
    return _EXPORTER


def current() -> SpanContext | None:
    return _current.get()


@contextmanager
def span(name: str, **attrs):
    """Start a child of the current context (or a new root), scoped to the
    block. The span exports on exit; exceptions mark status=error."""
    parent = _current.get()
    ctx = SpanContext(
        trace_id=parent.trace_id if parent else secrets.token_hex(16),
        span_id=secrets.token_hex(8))
    sp = Span(name=name, context=ctx,
              parent_id=parent.span_id if parent else "", attrs=dict(attrs))
    token = _current.set(ctx)
    try:
        yield sp
    except BaseException:
        sp.finish("error")
        raise
    else:
        sp.finish()
    finally:
        _current.reset(token)


def inject() -> dict:
    """Outgoing metadata for the current context ({} when not tracing)."""
    ctx = _current.get()
    return {TRACEPARENT: ctx.to_traceparent()} if ctx else {}


@contextmanager
def extract(metadata: dict | None, name: str, **attrs):
    """Server side: adopt the caller's context from frame metadata and run
    the handler inside a span (otelgrpc stats-handler analog)."""
    ctx = None
    if metadata and TRACEPARENT in metadata:
        ctx = SpanContext.from_traceparent(metadata[TRACEPARENT])
    token = _current.set(ctx) if ctx is not None else None
    try:
        with span(name, **attrs) as sp:
            yield sp
    finally:
        if token is not None:
            _current.reset(token)
