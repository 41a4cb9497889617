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
finished span before sampling.

**One clock.** A span stamps its start and end with ``time.monotonic_ns``
(CLOCK_MONOTONIC, the clock of the C++ front's enqueue stamps), and its
wall ``start`` is that start plus one process offset (:data:`WALL_OFFSET_NS`),
so spans line up with a device trace on the host's wall clock.
:class:`SpanRecorder` keeps every finished span in memory, and the
interpreter's collections as ``host.gc`` spans: it stands where the
reference's debug ring does. Not ported: the device profile.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import gc
import os
import random
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


# ids come from one generator the OS seeds, not from a system call each (a
# traced take makes a span a step); a forked child reseeds it
_ids = random.Random()
os.register_at_fork(after_in_child=_ids.seed)


def new_trace_id() -> str:
    return f"{_ids.getrandbits(128) or 1:032x}"


def new_span_id() -> str:
    return f"{_ids.getrandbits(64) or 1:016x}"


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


def _wall_offset_ns(reads: int = 5) -> int:
    """``time.time_ns()`` minus ``time.monotonic_ns()``: the wall clock
    read between two monotonic reads, from the narrowest of ``reads``
    pairs."""
    best = None
    for _ in range(reads):
        a = time.monotonic_ns()
        w = time.time_ns()
        b = time.monotonic_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


# the process's one offset from CLOCK_MONOTONIC to the wall clock
WALL_OFFSET_NS = _wall_offset_ns()


class Span:
    """One timed operation; ``attrs`` may change until it is finished.
    ``start_ns`` is on CLOCK_MONOTONIC; ``start`` is the wall clock, from
    ``start_ns`` and :data:`WALL_OFFSET_NS` unless given."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "component",
                 "start", "duration_s", "status", "attrs", "start_ns")

    def __init__(self, trace_id: str, span_id: str, parent_id: str | None,
                 name: str, component: str, start: float | None = None,
                 attrs: dict | None = None, start_ns: int | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.component = component
        if start_ns is None:
            start_ns = (time.monotonic_ns() if start is None
                        else round(start * 1e9) - WALL_OFFSET_NS)
        self.start_ns = start_ns
        # wall clock: cross-process alignment, and a device trace's clock
        self.start = (start_ns + WALL_OFFSET_NS) / 1e9 if start is None else start
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
              attrs: dict | None = None, start_ns: int | None = None) -> Span:
        """Begin a span without activating it on this thread (pair with
        :meth:`finish`); the parent defaults to the current context, the
        start (``time.monotonic_ns``) to now."""
        if parent is None:
            parent = current_context()
        trace_id = parent.trace_id if parent is not None else new_trace_id()
        parent_id = parent.span_id if parent is not None else None
        return Span(trace_id, new_span_id(), parent_id, name, self.component,
                    attrs=attrs, start_ns=start_ns)

    def finish(self, span: Span, status: str | None = None,
               end_ns: int | None = None) -> None:
        """End ``span`` at ``end_ns`` (``time.monotonic_ns``; default now)
        and hand it to the histogram and the sink."""
        if end_ns is None:
            end_ns = time.monotonic_ns()
        span.duration_s = max(0, end_ns - span.start_ns) / 1e9
        if status is not None:
            span.status = status
        self._hist.observe(span.duration_s, labels={"span": span.name},
                           exemplar={"trace_id": span.trace_id})
        if self.sink is not None:
            self.sink.add(span)

    def record(self, name: str, start_ns: int, end_ns: int,
               parent: SpanContext | None = None, attrs: dict | None = None) -> Span:
        """A finished span between two ``time.monotonic_ns`` stamps the
        caller took (or, as the C++ front's enqueue stamps, was handed)."""
        sp = self.start(name, parent=parent, attrs=attrs, start_ns=start_ns)
        self.finish(sp, end_ns=end_ns)
        return sp

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


class SpanRecorder:
    """Every finished span handed to :meth:`add`, kept in memory up to
    ``max_spans`` (later ones only counted in ``dropped``): a
    :class:`Tracer`'s ``sink``, or a :class:`SpanSink` listener. Armed
    (:meth:`arm`), it also records each collection of the interpreter's
    collector as a ``host.gc`` span with no parent (attrs ``generation``,
    ``collected``). It writes no file and serves no endpoint: its reader
    takes :meth:`spans` in the same process."""

    def __init__(self, max_spans: int = 500_000):
        self.max_spans = int(max_spans)
        self.dropped = 0
        # each span as a tuple of its fields: once their attrs hold plain
        # values the collector stops tracking them, so what the recorder
        # keeps does not lengthen the pauses it records. No lock:
        # list.append is atomic, and a collection (so the gc callback,
        # which adds) may start inside add on the same thread
        self._spans: list[tuple] = []
        self._gc_start_ns: int | None = None

    def add(self, span: Span) -> None:
        if len(self._spans) < self.max_spans:
            self._spans.append((span.trace_id, span.span_id, span.parent_id, span.name,
                                span.component, span.start, span.duration_s, span.status,
                                span.attrs, span.start_ns))
        else:
            self.dropped += 1

    def arm(self) -> None:
        """Record the collector's pauses from now on."""
        if self._on_gc not in gc.callbacks:
            gc.callbacks.append(self._on_gc)

    def disarm(self) -> None:
        with contextlib.suppress(ValueError):
            gc.callbacks.remove(self._on_gc)
        self._gc_start_ns = None

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start_ns = time.monotonic_ns()
            return
        t0, self._gc_start_ns = self._gc_start_ns, None
        if t0 is None:
            return  # armed during a collection
        self.record("host.gc", t0, time.monotonic_ns(), "host",
                    attrs={"generation": info.get("generation"),
                           "collected": info.get("collected")})

    def record(self, name: str, start_ns: int, end_ns: int, component: str,
               attrs: dict | None = None) -> None:
        """Keep a span with no parent between two ``time.monotonic_ns``
        stamps that no tracer or sink sees: what only a recorder's reader
        wants (the collector's pauses, the native front's idle takers)."""
        sp = Span(new_trace_id(), new_span_id(), None, name, component, attrs=attrs,
                  start_ns=start_ns)
        sp.duration_s = max(0, end_ns - start_ns) / 1e9
        self.add(sp)

    def spans(self) -> list[dict[str, Any]]:
        """The recorded spans as ``Span.to_dict`` plus ``end`` (the wall
        clock, as ``start``) and ``start_ns``/``end_ns``
        (CLOCK_MONOTONIC), in the order they finished."""
        out = []
        for tid, sid, pid, name, comp, start, dur, status, attrs, start_ns in list(self._spans):
            out.append({"trace_id": tid, "span_id": sid, "parent_id": pid, "name": name,
                        "component": comp, "start": start, "duration_s": dur,
                        "status": status, "attrs": dict(attrs), "end": start + dur,
                        "start_ns": start_ns, "end_ns": start_ns + round(dur * 1e9)})
        return out
