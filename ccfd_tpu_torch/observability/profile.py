"""Stage profiles: a machine-readable queueing/service/dispatch decomposition.

The port's copy of ccfd_tpu/observability/profile.py. Two things differ,
because the port compiles no XLA programs: the compile attribution counts
the port's builds (each nvcc run of ``ops/_build.py`` and each g++ run of
``native/__init__.py``, fed through :func:`record_build`) in place of
``jax.monitoring``'s ``backend_compile`` events, and
:meth:`StageProfiler.profile_device` wraps ``torch.profiler`` in place of
``jax.profiler.trace``. The document's keys are the reference's.

PR 2's spans, PR 6's overload gauges and the bench rows are human-readable
evidence; ROADMAP item 3's InferLine-style provisioning planner
(arXiv:1812.01776) needs a machine-readable PROFILE of each pipeline stage
— per stage, how much of a transaction's latency was queueing (waiting for
the stage), service (host work in the stage) and device dispatch (the device
round trip), plus how service time scales with batch size (the curve the
planner trades against batching deadlines). This module maintains exactly
that, live:

- :class:`LatencyDigest` — a fixed-geometric-bucket quantile sketch
  (t-digest-shaped accuracy at a fraction of the code): bounded memory,
  mergeable counts, interpolated quantiles. Every component below records
  into digests, never raw samples.
- :class:`StageProfiler` — per-stage accumulators with three components
  (``queue`` / ``service`` / ``dispatch``) and a batch-size-conditioned
  service curve. Fed two ways, both wired by the operator:

  1. **direct observes** on the hot paths that know their own split — the
     router feeds bus queueing delay, decode/route service and the scorer
     dispatch per micro-batch; the serving ``DynamicBatcher`` feeds REST
     batcher wait and dispatch time per coalesced launch;
  2. **span ingestion** — a listener on the PR 2 :class:`SpanSink` maps
     finished spans (every span, not just tail-sampled keeps) onto stages
     by name, so stages with no direct feed (producer, engine REST,
     notify, serving) profile for free wherever tracing is on.

  Kernel and native-library builds attribute through :func:`record_build`
  (``compile`` section + ``ccfd_build_events_total``): a stage whose p99
  spikes because a library was built mid-traffic shows the build in the
  same profile, and :meth:`StageProfiler.profile_device` wraps
  ``torch.profiler`` for the deep device-level view.

- **StageProfile artifact** — :meth:`StageProfiler.snapshot` renders the
  whole profile as one JSON document (schema :data:`PROFILE_SCHEMA`,
  validated by :func:`validate_profile`), served live at the exporter's
  ``/profile`` endpoint and written crash-safely (tmp+rename) by
  :meth:`StageProfiler.write`. This document is the input contract the
  future planner consumes.

The profiler is wall-clock-free on the hot path (two ``perf_counter``
reads per batch where it is fed directly) and entirely lock-striped per
stage; a disabled profiler costs one ``is None`` check.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import math
import os
import threading
import time
import weakref
from typing import Any, Iterator, Mapping

PROFILE_SCHEMA = "ccfd.stage_profile.v1"

# the three latency components every stage decomposes into
COMPONENTS = ("queue", "service", "dispatch")

# canonical pipeline stages (ISSUE 9: produce -> bus -> router decode/
# score/route -> engine -> notify, plus the REST serving path). Stages not
# in this tuple are still accepted — the planner contract only promises
# these names when the corresponding path carried traffic.
STAGES = (
    "produce",        # producer batch emit (service)
    "bus",            # topic wait: produce timestamp -> router poll (queue)
    "router.decode",  # record decode into the (B, 30) matrix (service)
    "router.score",   # scorer device round trip (dispatch)
    "router.route",   # rule eval + engine process starts (service)
    "engine",         # KIE REST surface (service)
    "notify",         # notification handling (service)
    "rest",           # serving predict request end to end (service)
    "rest.batcher",   # DynamicBatcher queue sojourn (queue)
    "rest.dispatch",  # serving-side coalesced device dispatch (dispatch)
)

# span name -> (stage, component): the SpanSink ingestion map. The router
# span family (router.batch/decode/score/route) is deliberately ABSENT:
# the router feeds its stages directly (richer — batch sizes, the
# queue/service split — and present even with tracing off), and ingesting
# its spans too would double-count every batch. Stages with no hot-path
# feed profile through their spans.
SPAN_STAGES: Mapping[str, tuple[str, str]] = {
    "producer.batch": ("produce", "service"),
    "producer.produce": ("produce", "service"),
    "engine.rest": ("engine", "service"),
    "notify.handle": ("notify", "service"),
    "serving.predict": ("rest", "service"),
}

# batch-size buckets conditioning the service curve (the scorer's own
# bucket ladder shape)
BATCH_BUCKETS = (1, 8, 64, 256, 1024, 4096, 16384)


class LatencyDigest:
    """Fixed-geometric-bucket latency sketch: 1 µs .. ~137 s at 2^(1/4)
    spacing (~9% worst-case relative quantile error after interpolation),
    bounded memory, cheap adds. NOT thread-safe — callers lock."""

    # 4 buckets per octave over 27 octaves: 1e-6 * 2**(k/4)
    _BASE = 1e-6
    _PER_OCTAVE = 4
    _N = 27 * _PER_OCTAVE + 1

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts = [0] * self._N
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def _index(self, value: float) -> int:
        if value <= self._BASE:
            return 0
        i = int(math.log2(value / self._BASE) * self._PER_OCTAVE) + 1
        return min(self._N - 1, i)

    @classmethod
    def _upper(cls, i: int) -> float:
        if i <= 0:
            return cls._BASE
        return cls._BASE * 2.0 ** (i / cls._PER_OCTAVE)

    def add(self, value: float, n: int = 1) -> None:
        value = max(0.0, float(value))
        self.counts[self._index(value)] += n
        self.count += n
        self.sum += value * n
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def quantile(self, q: float) -> float:
        """Interpolated quantile in SECONDS; NaN with no samples."""
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev_cum = cum
            cum += c
            if cum >= rank:
                lo = self._upper(i - 1) if i > 0 else 0.0
                hi = self._upper(i)
                frac = (rank - prev_cum) / c if c else 1.0
                v = lo + (hi - lo) * frac
                # never report outside the observed envelope (the last
                # bucket's upper bound can exceed the true max wildly)
                return min(max(v, self.min), self.max)
        return self.max

    def copy(self) -> "LatencyDigest":
        """Field-complete clone (readers snapshot under the writer's lock;
        the layout knowledge stays HERE, not at every call site)."""
        out = LatencyDigest()
        out.counts = list(self.counts)
        out.count = self.count
        out.sum = self.sum
        out.min = self.min
        out.max = self.max
        return out

    def to_dict(self) -> dict[str, Any]:
        if self.count == 0:
            return {"count": 0, "sum_s": 0.0}
        return {
            "count": self.count,
            "sum_s": round(self.sum, 6),
            "mean_ms": round(1e3 * self.sum / self.count, 4),
            "p50_ms": round(1e3 * self.quantile(0.5), 4),
            "p90_ms": round(1e3 * self.quantile(0.9), 4),
            "p99_ms": round(1e3 * self.quantile(0.99), 4),
            "min_ms": round(1e3 * self.min, 4),
            "max_ms": round(1e3 * self.max, 4),
        }


class _StageAcc:
    __slots__ = ("lock", "digests", "by_batch", "rows")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.digests = {c: LatencyDigest() for c in COMPONENTS}
        # batch-bucket -> service-or-dispatch digest (the service curve)
        self.by_batch: dict[int, LatencyDigest] = {}
        self.rows = 0


def _batch_bucket(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return BATCH_BUCKETS[-1]


# the build hook: ops/_build.py and native/__init__.py call record_build
# after each compiler run; it forwards to the most recently armed profiler
# through a weakref (a torn-down platform's profiler is collectable), and
# counts every build process-wide whether or not a profiler is armed
_BUILD_TARGET: "weakref.ref[StageProfiler] | None" = None
_BUILDS_MU = threading.Lock()
_BUILDS = 0

# per-stage build attribution: a build runs synchronously on the thread
# that first needs the library, so a contextvar label set by the component
# that triggered it (the scorer's warmup, the decision plane's) names the
# stage the build bills to
_COMPILE_STAGE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ccfd_compile_stage", default="untagged")


@contextlib.contextmanager
def compile_stage(label: str) -> Iterator[None]:
    """Attribute builds inside the block to ``label`` (the device
    telemetry plane's executable-inventory companion: WHICH stage paid
    the build, not just that one happened)."""
    token = _COMPILE_STAGE.set(str(label))
    try:
        yield
    finally:
        _COMPILE_STAGE.reset(token)


def record_build(secs: float) -> None:
    """One compiler run (nvcc for a kernel library, g++ for the native host
    library) of ``secs`` wall seconds: counted process-wide and fed to the
    armed profiler, billed to the active :func:`compile_stage` label."""
    global _BUILDS
    with _BUILDS_MU:
        _BUILDS += 1
    target = _BUILD_TARGET() if _BUILD_TARGET is not None else None
    if target is not None:
        target._record_compile(float(secs))


def builds_total() -> int:
    """Compiler runs in this process so far (armed profiler or not)."""
    with _BUILDS_MU:
        return _BUILDS


class StageProfiler:
    """Live per-stage latency decomposition; see the module docstring.

    With a ``registry``, :meth:`refresh_gauges` (called on every
    :meth:`snapshot`, i.e. on every ``/profile`` read and SLO tick)
    exports ``ccfd_stage_latency_ms{stage,component,quantile}`` so the
    SLO Grafana board charts the decomposition without parsing the JSON
    artifact, plus the compile-event counter/clock.
    """

    def __init__(self, registry=None,
                 overload_registry=None) -> None:
        self._stages: dict[str, _StageAcc] = {}
        self._stages_mu = threading.Lock()
        self._overload_registry = overload_registry
        self._compile_mu = threading.Lock()
        self._compile = LatencyDigest()
        # stage label -> digest (see compile_stage): the per-stage compile
        # attribution the Device board and incident bundles read
        self._compile_stages: dict[str, LatencyDigest] = {}
        self._compile_armed = False
        self.registry = registry
        self._g_stage = self._c_compile = self._c_compile_s = None
        self._c_compile_stage_s = None
        if registry is not None:
            self._g_stage = registry.gauge(
                "ccfd_stage_latency_ms",
                "stage-profile latency decomposition by stage, component "
                "(queue/service/dispatch) and quantile",
            )
            self._c_compile = registry.counter(
                "ccfd_build_events_total",
                "kernel and native-library builds (nvcc, g++) in this "
                "process; a build mid-traffic explains a stage p99 spike",
            )
            self._c_compile_s = registry.counter(
                "ccfd_build_seconds_total",
                "cumulative wall seconds spent in kernel and native-library "
                "builds",
            )
            self._c_compile_stage_s = registry.counter(
                "ccfd_compile_stage_seconds_total",
                "cumulative build seconds attributed to the stage that "
                "triggered them (compile_stage labels; 'untagged' = builds "
                "outside any labeled block)",
            )

    # -- ingestion ---------------------------------------------------------
    def _acc(self, stage: str) -> _StageAcc:
        acc = self._stages.get(stage)
        if acc is None:
            with self._stages_mu:
                acc = self._stages.setdefault(stage, _StageAcc())
        return acc

    def observe(self, stage: str, queue_s: float | None = None,
                service_s: float | None = None,
                dispatch_s: float | None = None,
                batch: int | None = None, rows: int = 1) -> None:
        """Record one sample for ``stage``. Any subset of the three
        components may be present; ``batch`` additionally conditions the
        service/dispatch sample on the batch-size bucket (the service
        curve a provisioning planner fits)."""
        acc = self._acc(stage)
        with acc.lock:
            acc.rows += rows
            if queue_s is not None:
                acc.digests["queue"].add(queue_s)
            if service_s is not None:
                acc.digests["service"].add(service_s)
            if dispatch_s is not None:
                acc.digests["dispatch"].add(dispatch_s)
            if batch is not None and (service_s is not None
                                      or dispatch_s is not None):
                b = _batch_bucket(int(batch))
                d = acc.by_batch.get(b)
                if d is None:
                    d = acc.by_batch[b] = LatencyDigest()
                d.add(dispatch_s if dispatch_s is not None else service_s)

    def on_span(self, span) -> None:
        """SpanSink listener: fold a finished span into its stage (see
        :data:`SPAN_STAGES` for why the router family is excluded)."""
        mapped = SPAN_STAGES.get(span.name)
        if mapped is None:
            return
        stage, component = mapped
        self.observe(stage, **{f"{component}_s": span.duration_s})

    def digest(self, stage: str, component: str) -> LatencyDigest | None:
        """A consistent COPY of the stage/component digest (or None).
        Digests are not thread-safe and hot-path writers hold the stage
        lock — readers (budget ledger, load_shape shares) get a snapshot
        taken under it, never the live object."""
        acc = self._stages.get(stage)
        if acc is None:
            return None
        with acc.lock:
            d = acc.digests.get(component)
            return d.copy() if d is not None else None

    # -- build attribution --------------------------------------------------
    def arm_compile_listener(self) -> bool:
        """Attribute kernel and native-library builds (:func:`record_build`)
        to this profiler; the most recently armed profiler wins, as in the
        reference. Always True: the hook is the port's own."""
        global _BUILD_TARGET
        self._compile_armed = True
        _BUILD_TARGET = weakref.ref(self)
        return True

    def _record_compile(self, secs: float) -> None:
        stage = _COMPILE_STAGE.get()
        with self._compile_mu:
            self._compile.add(float(secs))
            d = self._compile_stages.get(stage)
            if d is None:
                d = self._compile_stages[stage] = LatencyDigest()
            d.add(float(secs))
            if self._c_compile is not None:
                self._c_compile.inc()
                self._c_compile_s.inc(float(secs))
                self._c_compile_stage_s.inc(float(secs),
                                            labels={"stage": stage})

    def compile_counts(self) -> dict[str, int]:
        """Per-stage build counts (``total`` included): the cheap read that
        shows no build ran while serving, without a full :meth:`snapshot`."""
        with self._compile_mu:
            out = {stage: d.count
                   for stage, d in self._compile_stages.items()}
            out["total"] = self._compile.count
        return out

    @contextlib.contextmanager
    def profile_device(self, logdir: str) -> Iterator[None]:
        """Device-level trace around a block (``torch.profiler``, CPU and,
        where CUDA is available, CUDA activities), written to ``logdir`` as
        a Chrome trace (``trace.json``) with the per-kernel device time
        summary (``device_time.json``): the deep-dive companion to the
        always-on stage profile."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        write_json_crash_safe(os.path.join(logdir, "device_time.json"),
                              device_time_summary(prof))

    # -- export ------------------------------------------------------------
    def _overload_section(self) -> dict[str, Any]:
        reg = self._overload_registry
        if reg is None:
            return {}
        out: dict[str, Any] = {}
        try:
            lim = reg.get("ccfd_inflight_limit")
            used = reg.get("ccfd_inflight_used")
            if lim is not None:
                out["inflight"] = {
                    "limit": {("|".join(f"{k}={v}" for k, v in key) or "all"):
                              val for key, val in lim.items()},
                    "used": ({("|".join(f"{k}={v}" for k, v in key) or "all"):
                              val for key, val in used.items()}
                             if used is not None else {}),
                }
            for name in ("ccfd_shed_total", "ccfd_admission_total",
                         "ccfd_dispatch_timeout_total",
                         "ccfd_priority_inversions_total"):
                m = reg.get(name)
                if m is not None and hasattr(m, "total"):
                    out[name] = m.total()
        # ccfd-lint: disable=counted-drops -- read-side export fallback: the overload section is simply absent from /profile, which the reader sees
        except Exception:  # noqa: BLE001 - profile export must never 500
            pass
        return out

    def refresh_gauges(self) -> None:
        if self._g_stage is None:
            return
        with self._stages_mu:
            stages = dict(self._stages)
        for stage, acc in stages.items():
            with acc.lock:
                for comp, d in acc.digests.items():
                    if d.count == 0:
                        continue
                    for q, qname in ((0.5, "p50"), (0.99, "p99")):
                        self._g_stage.set(
                            1e3 * d.quantile(q),
                            labels={"stage": stage, "component": comp,
                                    "quantile": qname})

    def snapshot(self) -> dict[str, Any]:
        """The StageProfile document (:data:`PROFILE_SCHEMA`) — the
        planner input contract; also refreshes the stage gauges."""
        self.refresh_gauges()
        with self._stages_mu:
            stages = dict(self._stages)
        doc_stages: dict[str, Any] = {}
        for stage, acc in stages.items():
            with acc.lock:
                entry: dict[str, Any] = {"rows": acc.rows}
                for comp, d in acc.digests.items():
                    entry[comp] = d.to_dict()
                if acc.by_batch:
                    entry["service_by_batch"] = {
                        str(b): d.to_dict()
                        for b, d in sorted(acc.by_batch.items())
                    }
            doc_stages[stage] = entry
        with self._compile_mu:
            compile_section = self._compile.to_dict()
            compile_by_stage = {s: d.to_dict()
                                for s, d in self._compile_stages.items()}
        return {
            "schema": PROFILE_SCHEMA,
            "generated_unix": time.time(),
            "stages": doc_stages,
            "compile": compile_section,
            "compile_by_stage": compile_by_stage,
            "overload": self._overload_section(),
        }

    def write(self, path: str) -> dict[str, Any]:
        """Crash-safe artifact write (tmp+rename); returns the document."""
        doc = self.snapshot()
        write_json_crash_safe(path, doc)
        return doc


def device_time_summary(prof) -> dict[str, Any]:
    """Per-kernel device time (µs) of a finished ``torch.profiler`` run and
    its sum: what ``/debug/profile`` writes beside the trace."""
    kernels: dict[str, float] = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = float(getattr(e, "device_time_total", 0.0) or 0.0)
        if us > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + us
    return {"device_us": round(sum(kernels.values()), 3),
            "kernels": {k: round(v, 3) for k, v in sorted(kernels.items())}}


def write_json_crash_safe(path: str, doc: Mapping[str, Any]) -> None:
    """Crash-safe JSON write — tmp + fsync + rename plus a ``.sha256``
    sidecar (runtime/durability.write_json_interchange): a crash
    mid-write leaves the previous artifact intact, never a torn file,
    and the sidecar lets consumers verify the bytes. Raises OSError on
    failure."""
    from ccfd_tpu_torch.runtime.durability import write_json_interchange

    write_json_interchange(path, doc, artifact="profile_doc",
                           best_effort=False, indent=1, sort_keys=True)


def _digest_errors(where: str, d: Any) -> list[str]:
    errs: list[str] = []
    if not isinstance(d, Mapping):
        return [f"{where}: not a mapping"]
    if not isinstance(d.get("count"), int) or d["count"] < 0:
        errs.append(f"{where}: missing/invalid count")
        return errs
    if d["count"] > 0:
        for k in ("sum_s", "mean_ms", "p50_ms", "p99_ms"):
            v = d.get(k)
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                errs.append(f"{where}: missing/non-finite {k}")
    return errs


def validate_profile(doc: Any) -> list[str]:
    """Schema check for a StageProfile document -> list of problems
    ([] = valid). Hand-rolled (no jsonschema dependency): the planner and
    the CI smoke both gate on it, so failures must NAME the path."""
    errs: list[str] = []
    if not isinstance(doc, Mapping):
        return ["document: not a mapping"]
    if doc.get("schema") != PROFILE_SCHEMA:
        errs.append(f"schema: expected {PROFILE_SCHEMA!r}, "
                    f"got {doc.get('schema')!r}")
    if not isinstance(doc.get("generated_unix"), (int, float)):
        errs.append("generated_unix: missing")
    stages = doc.get("stages")
    if not isinstance(stages, Mapping):
        return errs + ["stages: missing"]
    for name, entry in stages.items():
        if not isinstance(entry, Mapping):
            errs.append(f"stages.{name}: not a mapping")
            continue
        if not isinstance(entry.get("rows"), int):
            errs.append(f"stages.{name}.rows: missing")
        for comp in COMPONENTS:
            if comp in entry:
                errs.extend(_digest_errors(f"stages.{name}.{comp}",
                                           entry[comp]))
        for b, d in (entry.get("service_by_batch") or {}).items():
            if not str(b).isdigit():
                errs.append(f"stages.{name}.service_by_batch: "
                            f"non-integer bucket {b!r}")
            errs.extend(_digest_errors(
                f"stages.{name}.service_by_batch.{b}", d))
    if "compile" in doc:
        errs.extend(_digest_errors("compile", doc["compile"]))
    cbs = doc.get("compile_by_stage")
    if cbs is not None:
        if not isinstance(cbs, Mapping):
            errs.append("compile_by_stage: not a mapping")
        else:
            for stage, d in cbs.items():
                errs.extend(_digest_errors(f"compile_by_stage.{stage}", d))
    return errs
