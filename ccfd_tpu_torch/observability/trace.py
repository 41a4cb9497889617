"""Distributed tracing: spans, context propagation and tail sampling.

The port's copy of ccfd_tpu/observability/trace.py:

- **Context propagation**: W3C ``traceparent`` (``00-<trace>-<span>-<flags>``)
  injected by the HTTP clients (utils/httpclient.py, serving/client.py),
  extracted by the servers (bus, engine REST), and carried on bus records
  (``headers``), so one produced batch yields one trace from the producer
  through the router (``router.batch`` -> ``router.decode`` /
  ``router.score`` / ``router.route``) into the engine and notify.
- **Per-component tracers**: :class:`Tracer` records span durations into
  the component's scraped registry (``trace_span_seconds{span=...}``, with
  the trace id as an exemplar) and hands finished spans to a
  :class:`SpanSink`.
- **Tail-based sampling**: the sink keeps every trace that is slow,
  errored or flagged (``fraud``, ``degraded``, ``breaker_open``) and a
  deterministic crc32 fraction (``CCFD_TRACE_SAMPLE``) of the rest.

Span context is per thread (``contextvars``); code that hops threads (the
router's score worker) passes ``parent=`` explicitly. Span listeners
(``SpanSink.add_listener``: the stage profiler's span ingestion) see every
finished span before sampling. Not ported: the debug ring and the device
profile.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import os
import threading
import time
import zlib
from typing import Any, Iterator, Mapping, NamedTuple

from ccfd_tpu_torch.metrics.prom import Registry

TRACEPARENT = "traceparent"
_TRACEPARENT_B = b"traceparent"


class SpanContext(NamedTuple):
    trace_id: str  # 32 lowercase hex chars
    span_id: str   # 16 lowercase hex chars
    sampled: bool = True


_current: contextvars.ContextVar[SpanContext | None] = contextvars.ContextVar(
    "ccfd_torch_trace_ctx", default=None)


def current_context() -> SpanContext | None:
    """The active span's context on this thread (None outside any span)."""
    return _current.get()


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(ctx: SpanContext | None) -> str | None:
    if ctx is None:
        return None
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


def parse_traceparent(value: Any) -> SpanContext | None:
    """``00-<32 hex>-<16 hex>-<2 hex>`` -> SpanContext; anything else None
    (a malformed header starts a fresh trace, never fails the request)."""
    if isinstance(value, bytes):
        try:
            value = value.decode("ascii")
        except UnicodeDecodeError:
            return None
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id.lower(), span_id.lower(),
                       sampled=bool(int(flags, 16) & 1))


def inject_headers(headers: dict | None = None,
                   ctx: SpanContext | None = None) -> dict:
    """Add a ``traceparent`` entry for ``ctx`` (default: the current span)
    to ``headers``; no entry when there is no active span."""
    headers = {} if headers is None else headers
    tp = format_traceparent(ctx if ctx is not None else current_context())
    if tp is not None:
        headers[TRACEPARENT] = tp
    return headers


def extract_context(headers: Mapping | None) -> SpanContext | None:
    """A SpanContext from an HTTP-header-shaped mapping (str or bytes keys,
    any case)."""
    if not headers:
        return None
    v = headers.get(TRACEPARENT)
    if v is None:
        v = headers.get(_TRACEPARENT_B)
    if v is None:
        for k in headers:
            name = k.decode("latin-1") if isinstance(k, bytes) else str(k)
            if name.lower() == TRACEPARENT:
                v = headers[k]
                break
    return parse_traceparent(v)


class Span:
    """One timed operation; ``attrs`` may change until it is finished."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "component",
                 "start", "duration_s", "status", "attrs", "_t0")

    def __init__(self, trace_id: str, span_id: str, parent_id: str | None,
                 name: str, component: str, start: float,
                 attrs: dict | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.component = component
        self.start = start              # wall clock: cross-process alignment
        self._t0 = time.perf_counter()  # monotonic: the duration
        self.duration_s = 0.0
        self.status = "ok"
        self.attrs = attrs if attrs is not None else {}

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def to_dict(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "component": self.component,
            "start": self.start,
            "duration_s": self.duration_s,
            "status": self.status,
            "attrs": dict(self.attrs),
        }


# span attrs whose truthiness forces a tail-sampling keep
FLAG_ATTRS = ("fraud", "degraded", "breaker_open")


class _TraceBuf:
    __slots__ = ("spans", "last", "reason")

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.last = 0.0
        self.reason: str | None = None  # first forced-keep reason seen


class SpanSink:
    """Span collector with tail-based sampling. Spans buffer per trace; a
    trace is decided when idle for ``decision_window_s`` (on read) or when
    the pending set overflows. Keep: any span errored, any span >=
    ``slow_s``, any flag attr (:data:`FLAG_ATTRS`), else crc32 of the trace
    id below ``sample``. Kept traces live in a bounded ring."""

    def __init__(
        self,
        sample: float = 0.01,
        slow_s: float = 0.1,
        max_pending: int = 1024,
        max_retained: int = 256,
        decision_window_s: float = 5.0,
        registry: Registry | None = None,
    ):
        self.sample = min(1.0, max(0.0, float(sample)))
        self.slow_s = float(slow_s)
        self.max_pending = int(max_pending)
        self.max_retained = int(max_retained)
        self.decision_window_s = float(decision_window_s)
        self._lock = threading.Lock()
        # span listeners (the stage profiler): every finished span, before
        # sampling
        self._listeners: list = []
        self._pending: "collections.OrderedDict[str, _TraceBuf]" = collections.OrderedDict()
        self._retained: "collections.OrderedDict[str, list[Span]]" = collections.OrderedDict()
        r = registry if registry is not None else Registry()
        self.registry = r
        self._c_spans = r.counter("ccfd_trace_spans_total", "spans recorded by component")
        self._c_kept = r.counter("ccfd_traces_kept_total", "tail-sampled traces kept, by reason")
        self._c_dropped = r.counter("ccfd_traces_dropped_total", "tail-sampled traces dropped")
        self._g_retained = r.gauge("ccfd_traces_retained", "traces currently held for /traces")
        self._g_pending = r.gauge("ccfd_traces_pending", "traces awaiting a sampling decision")
        self._c_listener_err = r.counter(
            "ccfd_trace_listener_errors_total",
            "span-listener callbacks that raised (the span still lands)")

    def add_listener(self, fn) -> None:
        """Subscribe ``fn(span)`` to every finished span (unsampled); a
        raising listener is counted, never a lost span."""
        self._listeners.append(fn)

    def add(self, span: Span) -> None:
        for fn in self._listeners:
            try:
                fn(span)
            except Exception:  # noqa: BLE001 - a listener bug must not drop spans
                self._c_listener_err.inc()
        self._c_spans.inc(labels={"component": span.component})
        with self._lock:
            retained = self._retained.get(span.trace_id)
            if retained is not None:
                if len(retained) < 512:  # a runaway trace stays bounded
                    retained.append(span)
                return
            buf = self._pending.get(span.trace_id)
            if buf is None:
                buf = self._pending[span.trace_id] = _TraceBuf()
            if len(buf.spans) < 512:
                buf.spans.append(span)
            buf.last = time.monotonic()
            if buf.reason is None:
                buf.reason = self._forced_reason(span)
            self._g_pending.set(len(self._pending))
            if len(self._pending) > self.max_pending:
                oldest, oldbuf = next(iter(self._pending.items()))
                del self._pending[oldest]
                self._decide_locked(oldest, oldbuf)

    def _forced_reason(self, span: Span) -> str | None:
        if span.status != "ok":
            return "error"
        if span.duration_s >= self.slow_s:
            return "slow"
        for flag in FLAG_ATTRS:
            if span.attrs.get(flag):
                return flag
        return None

    def _hash_keep(self, trace_id: str) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) < self.sample * 4294967296.0

    def _decide_locked(self, trace_id: str, buf: _TraceBuf) -> None:
        reason = buf.reason or ("sampled" if self._hash_keep(trace_id) else None)
        if reason is None:
            self._c_dropped.inc()
            return
        self._c_kept.inc(labels={"reason": reason})
        self._retained[trace_id] = buf.spans
        while len(self._retained) > self.max_retained:
            self._retained.popitem(last=False)
        self._g_retained.set(len(self._retained))

    def flush(self, older_than_s: float | None = None) -> None:
        """Decide pending traces idle longer than ``older_than_s`` (default:
        the decision window; 0.0 decides everything now)."""
        window = self.decision_window_s if older_than_s is None else float(older_than_s)
        now = time.monotonic()
        with self._lock:
            due = [tid for tid, buf in self._pending.items() if now - buf.last >= window]
            for tid in due:
                self._decide_locked(tid, self._pending.pop(tid))
            self._g_pending.set(len(self._pending))

    # -- read side (the exporter's /traces endpoints) ------------------------
    def trace(self, trace_id: str) -> list[dict[str, Any]] | None:
        self.flush()
        with self._lock:
            spans = self._retained.get(trace_id)
            if spans is None:
                buf = self._pending.get(trace_id)
                spans = buf.spans if buf is not None else None
            if spans is None:
                return None
            return sorted((s.to_dict() for s in spans), key=lambda d: d["start"])

    def traces(self) -> list[dict[str, Any]]:
        """Retained-trace summaries, newest first."""
        self.flush()
        with self._lock:
            items = list(self._retained.items())
        out = []
        for tid, spans in reversed(items):
            starts = [s.start for s in spans]
            ends = [s.start + s.duration_s for s in spans]
            roots = [s for s in spans if s.parent_id is None]
            out.append({
                "trace_id": tid,
                "spans": len(spans),
                "root": roots[0].name if roots else spans[0].name,
                "components": sorted({s.component for s in spans}),
                "start": min(starts),
                "duration_s": max(ends) - min(starts),
                "errored": any(s.status != "ok" for s in spans),
            })
        return out


class Tracer:
    """Per-component span factory. ``registry`` is the component's scraped
    registry; ``sink`` the shared :class:`SpanSink` (None: spans are only
    timed into the histogram)."""

    def __init__(self, registry: Registry | None = None,
                 component: str = "ccfd", sink: SpanSink | None = None):
        self.registry = registry or Registry()
        self.component = component
        self.sink = sink
        self._hist = self.registry.histogram("trace_span_seconds", "span durations by name")

    def start(self, name: str, parent: SpanContext | None = None,
              attrs: dict | None = None) -> Span:
        """Begin a span without activating it on this thread (pair with
        :meth:`finish`); the parent defaults to the current context."""
        if parent is None:
            parent = current_context()
        trace_id = parent.trace_id if parent is not None else new_trace_id()
        parent_id = parent.span_id if parent is not None else None
        return Span(trace_id, new_span_id(), parent_id, name, self.component,
                    time.time(), attrs)

    def finish(self, span: Span, status: str | None = None) -> None:
        span.duration_s = max(0.0, time.perf_counter() - span._t0)
        if status is not None:
            span.status = status
        self._hist.observe(span.duration_s, labels={"span": span.name},
                           exemplar={"trace_id": span.trace_id})
        if self.sink is not None:
            self.sink.add(span)

    @contextlib.contextmanager
    def span(self, name: str, parent: SpanContext | None = None,
             attrs: dict | None = None) -> Iterator[Span]:
        sp = self.start(name, parent=parent, attrs=attrs)
        token = _current.set(sp.context)
        try:
            yield sp
        except BaseException:
            sp.status = "error"
            raise
        finally:
            _current.reset(token)
            self.finish(sp)

    @contextlib.contextmanager
    def activate(self, ctx: SpanContext | None) -> Iterator[None]:
        """Make ``ctx`` current on this thread without opening a span."""
        token = _current.set(ctx)
        try:
            yield
        finally:
            _current.reset(token)
