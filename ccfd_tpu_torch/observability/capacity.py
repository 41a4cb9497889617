"""Capacity observatory: the queueing model fitted over the stage profile.

The port's copy of ccfd_tpu/observability/capacity.py. The StageProfile
says what each stage's latency decomposition WAS; a planner needs what it
WILL BE: the predicted latency at the admitted rate, which stage saturates
first, and how a knob move shifts the prediction.

- :class:`CapacityModel`: fitted continuously from the live
  :class:`~ccfd_tpu_torch.observability.profile.StageProfiler`. Each
  :meth:`~CapacityModel.refresh` diffs the profiler's CUMULATIVE digests
  against the previous tick, giving a windowed per-stage arrival rate
  (batches/s and rows/s) and mean service time, EWMA-smoothed; the
  batch-conditioned service curve is fitted the same way (per-bucket
  deltas).
- **Queueing approximation**: per stage, utilization rho = lambda * s_bar /
  servers (the M/M/1 form); queue-only stages (``bus``, ``rest.batcher``)
  invert the M/M/1 wait equation from the measured wait instead. Predicted
  p50/p99 come from the fitted means with exponential-tail multipliers
  (ln 2, ln 100) and sum to an end-to-end prediction.
  ``ccfd_capacity_model_error_ratio`` (|predicted - observed| / observed
  on the e2e p99) is the model's own trustworthiness SLI.
- **Bottleneck attribution**: the knee of each fitted service curve bounds
  the stage's sustainable row rate; headroom = max rate / admitted rate
  (1/rho where no curve exists). The minimum-headroom stage is the
  bottleneck (``ccfd_capacity_bottleneck{stage}``,
  ``ccfd_capacity_headroom_ratio{stage}``).
- **What-if evaluator**: :meth:`~CapacityModel.whatif` re-evaluates the
  fitted model under the actuator vocabulary (router ``workers``, batcher
  ``batch`` and ``deadline_ms``, admission ``max_inflight``) without
  touching the live system; served at ``/capacity/whatif?workers=&batch=&
  deadline_ms=&max_inflight=`` beside ``/capacity`` (schema
  :data:`CAPACITY_SCHEMA`, checked by :func:`validate_capacity`).
- **Service-curve regression sentinel**: the first fit past
  ``min_samples`` is persisted as the per-stage baseline through the
  durability seam (``runtime/durability.py``: tmp+rename and a sha256
  sidecar, read back through ``verify_interchange``); a later fit departing
  from it by more than ``regression_tolerance`` for
  ``regression_persistence`` consecutive windows fires
  ``ccfd_capacity_regression_total{stage}`` once per excursion.

The model, its stage map and its documents are the reference's. The port's
profiler feeds stages the reference leaves empty (the native front's
``rest``, ``rest.batcher`` and ``rest.dispatch``, and the parallel router's
``router.coalesce.batcher`` and ``router.coalesce.dispatch``); how the
reference's map bills them is recorded in ROADMAP C: the coalescing stages
carry no work component the map reads (queue and dispatch where the map
reads service), so they never enter the fit, and the enclosing ``rest``
stage sums into the e2e prediction beside its own parts, as it does in the
reference on its Python transport.

The model runs as a supervised operator service (the ``capacity``
component, ``CCFD_CAPACITY_*`` knobs); readers (the exporter's endpoints,
incident bundles) see only fitted state under the model lock, and no
profiler lock is ever held together with it.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Callable, Mapping

from ccfd_tpu_torch.observability.profile import write_json_crash_safe

CAPACITY_SCHEMA = "ccfd.capacity.v1"
BASELINE_SCHEMA = "ccfd.capacity_baseline.v1"

# exponential-tail quantile multipliers: for a mean-w exponential sojourn,
# p50 = w ln 2 and p99 = w ln 100 (the M/M/1 waiting-time tail)
_LN2 = math.log(2.0)
_LN100 = math.log(100.0)

# stages whose own digest records QUEUEING (wait) rather than work; every
# other stage's work component is service or dispatch per STAGE_LAYERS
STAGE_LAYERS: Mapping[str, str] = {
    "bus": "queue",
    "rest.batcher": "queue",
    "router.score": "dispatch",
    "rest.dispatch": "dispatch",
}

# queue stage -> the work stage that drains it: the queue's predicted wait
# scales with the DRAIN stage's utilization under what-if moves, and the
# drain stage's own prediction must NOT add a second wait term (the queue
# stage already carries it — no double counting in the e2e sum)
QUEUE_DRAINS: Mapping[str, str] = {
    "bus": "router.score",
    "rest.batcher": "rest.dispatch",
}

# queue stage -> every work stage in the consumer lane it feeds (the white
# -box topology the reference pipeline actually has). Used by bottleneck
# attribution: a fed work stage runs flat out — rho -> 1 — exactly when
# the queue ahead of it overflows, while the queue's wait-inverted rho
# asymptotes to 1 from BELOW, so raw min-headroom would always name the
# drain lane; the caller-visible backlog lives in the queue.
QUEUE_FEEDS: Mapping[str, tuple[str, ...]] = {
    "bus": ("router.decode", "router.score", "router.route"),
    "rest.batcher": ("rest.dispatch",),
}

_HEADROOM_CAP = 1000.0
_RHO_CAP = 0.98  # keep the W_q = s*rho/(1-rho) form finite past saturation


def stage_layer(stage: str) -> str:
    """Queueing layer a stage bills to: ``queue`` / ``dispatch`` /
    ``service`` (the same static map the budget ledger's shape implies)."""
    return STAGE_LAYERS.get(stage, "service")


def _rho_from_wait(lam: float, wait_s: float) -> float:
    """Invert the M/M/1 mean-wait equation for utilization: with
    W_q = rho^2 / (lambda (1 - rho)), rho solves
    rho^2 + lam*W*rho - lam*W = 0 -> the positive root below 1."""
    lw = max(0.0, lam * wait_s)
    if lw <= 0.0:
        return 0.0
    return min(1.0, (-lw + math.sqrt(lw * lw + 4.0 * lw)) / 2.0)


class _StageFit:
    """Fitted per-stage state (plain attrs; all rates in /s, times in s)."""

    __slots__ = (
        "layer", "lam_batches", "lam_rows", "mean_service_s", "mean_raw_s",
        "utilization", "servers", "curve", "curve_raw", "curve_n",
        "knee_batch", "max_rows_per_s", "headroom", "observed_p50_ms",
        "observed_p99_ms", "work_count", "active",
    )

    def __init__(self, layer: str) -> None:
        self.layer = layer
        self.lam_batches = 0.0
        self.lam_rows = 0.0
        self.mean_service_s = 0.0
        self.mean_raw_s = 0.0  # un-smoothed mean of the last window alone
        self.utilization = 0.0
        self.servers = 1
        self.curve: dict[int, float] = {}  # batch bucket -> fitted mean s
        self.curve_raw: dict[int, float] = {}  # bucket -> last-window mean s
        self.curve_n: dict[int, int] = {}  # bucket -> samples this window
        self.knee_batch: int | None = None
        self.max_rows_per_s: float | None = None
        self.headroom = _HEADROOM_CAP
        self.observed_p50_ms = 0.0
        self.observed_p99_ms = 0.0
        self.work_count = 0  # cumulative samples on the work component
        self.active = False  # saw traffic in the last fitted window


class CapacityModel:
    """Continuously fitted queueing model over a StageProfiler; see the
    module docstring. Thread-safe: the supervised refresh tick and the
    exporter's ``/capacity`` + ``/capacity/whatif`` reads interleave."""

    def __init__(self, profiler, registry=None, *,
                 baseline_path: str | None = None,
                 regression_tolerance: float = 1.0,
                 regression_persistence: int = 2,
                 min_samples: int = 50,
                 ewma_alpha: float = 0.5,
                 clock: Callable[[], float] = time.monotonic):
        self.profiler = profiler
        self.baseline_path = baseline_path or None
        self.regression_tolerance = max(0.01, float(regression_tolerance))
        self.regression_persistence = max(1, int(regression_persistence))
        self.min_samples = max(1, int(min_samples))
        self.ewma_alpha = min(1.0, max(0.01, float(ewma_alpha)))
        self._clock = clock
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._prev: dict[str, dict[str, Any]] | None = None
        self._prev_ts: float = 0.0
        self._fits: dict[str, _StageFit] = {}
        self._window_s = 0.0
        self._refreshes = 0
        self._fitted_unix: float | None = None
        self._e2e: dict[str, float] = {}
        self._bottleneck: dict[str, Any] | None = None
        # actuator base values (operator wires them; what-if deltas are
        # evaluated against these)
        self._actuators: dict[str, Any] = {
            "workers": 1, "batch": None, "deadline_ms": None,
            "max_inflight": None,
        }
        # regression sentinel state: per-stage baseline mean (ms), the
        # per-bucket baseline curve for curve-bearing stages, the
        # in-excursion flag (edge trigger), worst deviation ratio for the
        # doc, and fire counts
        self._baseline: dict[str, float] = {}
        self._baseline_curve: dict[str, dict[int, float]] = {}
        self._baseline_source: str | None = None
        self._in_regression: dict[str, bool] = {}
        self._breach_streak: dict[str, int] = {}
        self._worst_ratio: dict[str, float] = {}
        self._regressions: dict[str, int] = {}
        self._g_err = self._g_bottleneck = self._g_headroom = None
        self._g_util = self._g_pred = self._c_regress = None
        if registry is not None:
            self._g_err = registry.gauge(
                "ccfd_capacity_model_error_ratio",
                "capacity-model trustworthiness SLI: |predicted - observed|"
                " / observed on end-to-end p99 (planner may be trusted "
                "while this is small)",
            )
            self._g_bottleneck = registry.gauge(
                "ccfd_capacity_bottleneck",
                "1 on the minimum-headroom stage (the stage that saturates "
                "first at the current admitted rate), 0 elsewhere",
            )
            self._g_headroom = registry.gauge(
                "ccfd_capacity_headroom_ratio",
                "per-stage max sustainable row rate (service-curve knee) "
                "over the admitted rate; 1/utilization where no curve "
                "exists — < 1 means the stage is past saturation",
            )
            self._g_util = registry.gauge(
                "ccfd_capacity_utilization",
                "fitted per-stage utilization rho = arrival rate x mean "
                "service time / servers (wait-equation inversion for "
                "queue-only stages)",
            )
            self._g_pred = registry.gauge(
                "ccfd_capacity_predicted_p99_ms",
                "queueing-model predicted p99 per stage (stage label; "
                "stage=\"e2e\" is the end-to-end sum the error-ratio SLI "
                "compares against observation)",
            )
            self._c_regress = registry.counter(
                "ccfd_capacity_regression_total",
                "service-curve regression sentinel fires by stage: fitted "
                "mean service departed from the persisted baseline by more "
                "than the tolerance (one increment per excursion edge)",
            )
        if self.baseline_path:
            self._load_baseline()

    # -- actuator base values ----------------------------------------------
    def set_actuators(self, workers: int | None = None,
                      batch: int | None = None,
                      deadline_ms: float | None = None,
                      max_inflight: int | None = None) -> None:
        """Record the live actuator values what-if deltas are measured
        against (operator wiring; harnesses set them directly)."""
        with self._mu:
            if workers is not None:
                self._actuators["workers"] = max(1, int(workers))
            if batch is not None:
                self._actuators["batch"] = max(1, int(batch))
            if deadline_ms is not None:
                self._actuators["deadline_ms"] = float(deadline_ms)
            if max_inflight is not None:
                self._actuators["max_inflight"] = max(1, int(max_inflight))

    # -- baseline persistence (the durability seam) -------------------------
    def _load_baseline(self) -> None:
        from ccfd_tpu_torch.runtime.durability import verify_interchange

        path = self.baseline_path
        if verify_interchange(path) is False:
            # torn/corrupt baseline: refit from live traffic rather than
            # alert against bytes the sidecar disowns
            return
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(doc, Mapping) or doc.get("schema") != BASELINE_SCHEMA:
            return
        stages = doc.get("stages")
        if not isinstance(stages, Mapping):
            return
        loaded: dict[str, float] = {}
        curves: dict[str, dict[int, float]] = {}
        for stage, entry in stages.items():
            if not isinstance(entry, Mapping):
                continue
            mean = entry.get("mean_service_ms")
            if isinstance(mean, (int, float)) and math.isfinite(mean) \
                    and mean > 0:
                loaded[str(stage)] = float(mean)
            curve = entry.get("curve_ms")
            if isinstance(curve, Mapping):
                parsed = {
                    int(b): float(ms) for b, ms in curve.items()
                    if isinstance(ms, (int, float)) and math.isfinite(ms)
                    and ms > 0
                }
                if parsed:
                    curves[str(stage)] = parsed
        if loaded:
            self._baseline.update(loaded)
            self._baseline_curve.update(curves)
            self._baseline_source = path

    def _persist_baseline(self) -> None:
        if not self.baseline_path:
            return
        with self._mu:
            doc = {
                "schema": BASELINE_SCHEMA,
                "generated_unix": time.time(),
                "min_samples": self.min_samples,
                "stages": {
                    stage: {
                        "mean_service_ms": round(mean, 4),
                        **({"curve_ms": {
                            str(b): round(ms, 4) for b, ms in
                            sorted(self._baseline_curve[stage].items())
                        }} if self._baseline_curve.get(stage) else {}),
                    }
                    for stage, mean in sorted(self._baseline.items())
                },
            }
        try:
            write_json_crash_safe(self.baseline_path, doc)
        except OSError:
            # the sentinel keeps alerting from the in-memory baseline; a
            # restart refits instead of alerting against nothing
            self._baseline_source = None

    # -- fitting -----------------------------------------------------------
    @staticmethod
    def _cumulative(doc: Mapping[str, Any]) -> dict[str, dict[str, Any]]:
        """Per-stage cumulative (count, sum) for the work component, rows,
        and the by-batch curve — the delta basis for one fit window."""
        out: dict[str, dict[str, Any]] = {}
        for stage, entry in (doc.get("stages") or {}).items():
            # the layer names the component carrying the stage's own time
            work = entry.get(stage_layer(stage)) or {}
            curve = {}
            for b, d in (entry.get("service_by_batch") or {}).items():
                if isinstance(d, Mapping) and d.get("count"):
                    curve[int(b)] = (int(d["count"]), float(d.get("sum_s",
                                                                 0.0)))
            out[stage] = {
                "count": int(work.get("count", 0)),
                "sum_s": float(work.get("sum_s", 0.0)),
                "rows": int(entry.get("rows", 0)),
                "p50_ms": float(work.get("p50_ms", 0.0) or 0.0),
                "p99_ms": float(work.get("p99_ms", 0.0) or 0.0),
                "curve": curve,
            }
        return out

    def _ewma(self, old: float, new: float, first: bool) -> float:
        if first:
            return new
        a = self.ewma_alpha
        return a * new + (1.0 - a) * old

    def refresh(self) -> dict[str, Any] | None:
        """One fit tick: snapshot the profiler, diff against the previous
        tick, update fits/gauges/sentinel. Returns the capacity document
        (None until two ticks have bracketed a window)."""
        doc = self.profiler.snapshot()  # takes stage locks; never under _mu
        now = self._clock()
        cum = self._cumulative(doc)
        baseline_dirty = False
        with self._mu:
            prev, prev_ts = self._prev, self._prev_ts
            self._prev, self._prev_ts = cum, now
            dt = now - prev_ts
            if prev is None or dt <= 0.0:
                return None
            self._window_s = dt
            self._refreshes += 1
            self._fitted_unix = time.time()
            workers = int(self._actuators["workers"])
            for stage, c in cum.items():
                p = prev.get(stage) or {"count": 0, "sum_s": 0.0, "rows": 0,
                                        "curve": {}}
                fit = self._fits.get(stage)
                first = fit is None
                if first:
                    fit = self._fits[stage] = _StageFit(stage_layer(stage))
                fit.work_count = c["count"]
                fit.observed_p50_ms = c["p50_ms"]
                fit.observed_p99_ms = c["p99_ms"]
                dc = c["count"] - p["count"]
                drows = max(0, c["rows"] - p["rows"])
                fit.active = dc > 0
                fit.mean_raw_s = 0.0
                if dc > 0:
                    dsum = max(0.0, c["sum_s"] - p["sum_s"])
                    fit.lam_batches = self._ewma(fit.lam_batches, dc / dt,
                                                 first)
                    fit.lam_rows = self._ewma(fit.lam_rows, drows / dt,
                                              first)
                    fit.mean_raw_s = dsum / dc
                    fit.mean_service_s = self._ewma(fit.mean_service_s,
                                                    dsum / dc, first)
                fit.curve_raw = {}
                fit.curve_n = {}
                for b, (bc, bs) in c["curve"].items():
                    pb = p["curve"].get(b)
                    dbc = bc - (pb[0] if pb else 0)
                    if dbc > 0:
                        dbs = max(0.0, bs - (pb[1] if pb else 0.0))
                        old = fit.curve.get(b)
                        fit.curve[b] = self._ewma(old or 0.0, dbs / dbc,
                                                  old is None)
                        fit.curve_raw[b] = dbs / dbc
                        fit.curve_n[b] = dbc
                fit.servers = workers if fit.layer == "dispatch" else 1
                if fit.layer == "queue":
                    fit.utilization = _rho_from_wait(fit.lam_batches,
                                                     fit.mean_service_s)
                else:
                    fit.utilization = (fit.lam_batches * fit.mean_service_s
                                       / max(1, fit.servers))
                self._fit_knee(fit)
                if fit.layer != "queue":
                    # the sentinel watches fitted SERVICE time; a queue
                    # stage's wait regresses with load, not serving cost
                    baseline_dirty |= self._sentinel(stage, fit)
            self._attribute_bottleneck()
            self._predict_into_gauges()
            out = self._document_locked()
        if baseline_dirty:
            self._persist_baseline()
        return out

    def _fit_knee(self, fit: _StageFit) -> None:
        """Knee of the fitted service curve -> max sustainable row rate ->
        headroom. Queue stages and curve-less stages fall back to 1/rho;
        curve-bearing stages are ALSO clamped by 1/rho — the bucket grid
        labels a batch by its bucket ceiling, so the knee can promise
        throughput the stage only reaches at a larger batch size, while
        at the operating point it saturates at lambda/rho regardless."""
        best_b, best_tp = None, 0.0
        for b, mean_s in fit.curve.items():
            if mean_s <= 0.0:
                continue
            tp = b / mean_s
            if tp > best_tp:
                best_b, best_tp = b, tp
        rho_bound = (min(_HEADROOM_CAP, 1.0 / fit.utilization)
                     if fit.utilization > 0.0 else _HEADROOM_CAP)
        if best_b is not None and fit.layer != "queue":
            fit.knee_batch = best_b
            fit.max_rows_per_s = best_tp * max(1, fit.servers)
            if fit.lam_rows > 0.0:
                fit.headroom = min(_HEADROOM_CAP, rho_bound,
                                   fit.max_rows_per_s / fit.lam_rows)
            else:
                fit.headroom = _HEADROOM_CAP
        else:
            fit.knee_batch = None
            fit.max_rows_per_s = None
            fit.headroom = rho_bound

    def _sentinel(self, stage: str, fit: _StageFit) -> bool:
        """Regression sentinel for one stage; True when the baseline was
        (first-)captured or extended and needs persisting. Edge-triggered:
        one counter increment per excursion, re-armed only after the fit is
        back inside HALF the tolerance band (hysteresis — a mean hovering
        at the edge cannot machine-gun the counter).

        Three guards keep load and noise from masquerading as a cost
        regression:

        - Curve-bearing stages are judged per batch bucket against the
          baselined curve: the overall per-batch mean is confounded with
          the batch MIX (heavier load -> bigger batches -> bigger
          per-batch cost), so a pure load swing would read as one. A
          bucket first populated under today's load is absorbed into the
          baseline at its first fitted value, and a bucket with only a
          handful of window samples gets no verdict at all (one scheduler
          stall on a 2-batch bucket is noise). Curve-less stages fall
          back to the overall mean.
        - The verdict reads the RAW window fit, not the EWMA — the
          EWMA's memory stretches one contaminated window across several
          ticks, which would defeat the persistence guard below.
        - ``regression_persistence`` consecutive breaching windows are
          required before the counter fires (a ``for:`` clause, in
          Prometheus terms): a single contended window on a busy box is
          a transient, not a regression."""
        mean_ms = 1e3 * fit.mean_service_s
        min_n = max(2, self.min_samples // 10)
        base = self._baseline.get(stage)
        if base is None:
            if fit.work_count >= self.min_samples and mean_ms > 0.0:
                self._baseline[stage] = mean_ms
                if fit.curve:
                    self._baseline_curve[stage] = {
                        b: 1e3 * s for b, s in fit.curve.items()
                        if s > 0.0 and fit.curve_n.get(b, 0) >= min_n}
                return True
            return False
        tol = self.regression_tolerance
        dirty = False
        ratios: list[float] = []
        if fit.curve:
            bcurve = self._baseline_curve.setdefault(stage, {})
            for b, s_raw in fit.curve_raw.items():
                if s_raw <= 0.0 or fit.curve_n.get(b, 0) < min_n:
                    continue
                b_ms = bcurve.get(b)
                if b_ms is None:
                    s_fit = fit.curve.get(b)
                    if s_fit and s_fit > 0.0:
                        bcurve[b] = 1e3 * s_fit
                        dirty = True
                elif b_ms > 0:
                    ratios.append(1e3 * s_raw / b_ms)
            if not ratios:
                # nothing judgeable this window (buckets just baselined
                # or under-sampled); verdict on a later tick
                return dirty
        if not ratios:
            raw_ms = 1e3 * fit.mean_raw_s
            if raw_ms <= 0.0:
                return dirty
            ratios = [raw_ms / base if base > 0 else 1.0]
        worst = max(ratios, key=lambda r: abs(math.log(r)) if r > 0 else 0.0)
        self._worst_ratio[stage] = worst
        breach = any(
            r > 1.0 + tol or r < 1.0 / (1.0 + tol) for r in ratios)
        inside = all(
            (1.0 / (1.0 + 0.5 * tol)) <= r <= (1.0 + 0.5 * tol)
            for r in ratios)
        if breach:
            streak = self._breach_streak.get(stage, 0) + 1
            self._breach_streak[stage] = streak
            if streak >= self.regression_persistence \
                    and not self._in_regression.get(stage):
                self._in_regression[stage] = True
                self._regressions[stage] = self._regressions.get(stage, 0) + 1
                if self._c_regress is not None:
                    self._c_regress.inc(labels={"stage": stage})
        else:
            self._breach_streak[stage] = 0
            if inside and self._in_regression.get(stage):
                self._in_regression[stage] = False
        return dirty

    # -- prediction --------------------------------------------------------
    def _predict_stage(self, stage: str, fit: _StageFit,
                       fits: Mapping[str, _StageFit],
                       overrides: Mapping[str, Any] | None = None,
                       ) -> tuple[float, float]:
        """Predicted (p50_ms, p99_ms) for one stage under optional what-if
        overrides. Queue stages: the fitted mean wait, scaled by how the
        drain stage's W_q moves under the overrides, with exponential-tail
        quantiles. Work stages: the observed service quantiles (scaled
        along the service curve for a batch move), plus an own W_q term
        only when no fitted queue stage already carries the wait."""
        ov = overrides or {}
        lam_scale = self._lam_scale(ov)
        if fit.layer == "queue":
            wait_s = fit.mean_service_s
            drain = fits.get(QUEUE_DRAINS.get(stage, ""))
            if ov and drain is not None:
                wait_s *= self._wq_shift(drain, ov, lam_scale)
            if stage == "rest.batcher":
                wait_s = self._deadline_shift(wait_s, ov)
            return 1e3 * wait_s * _LN2, 1e3 * wait_s * _LN100
        p50, p99 = fit.observed_p50_ms, fit.observed_p99_ms
        scale = self._batch_scale(fit, ov)
        p50, p99 = p50 * scale, p99 * scale
        queued_elsewhere = any(
            QUEUE_DRAINS.get(q) == stage and q in fits for q in QUEUE_DRAINS)
        if not queued_elsewhere:
            rho = min(_RHO_CAP, fit.utilization * lam_scale
                      * self._server_shift(fit, ov) * scale)
            wq = fit.mean_service_s * scale * rho / (1.0 - rho)
            p50 += 1e3 * wq * _LN2
            p99 += 1e3 * wq * _LN100
        return p50, p99

    def _lam_scale(self, ov: Mapping[str, Any]) -> float:
        new = ov.get("max_inflight")
        base = self._actuators.get("max_inflight")
        if new and base:
            return min(1.0, float(new) / float(base))
        return 1.0

    def _server_shift(self, fit: _StageFit, ov: Mapping[str, Any]) -> float:
        """rho multiplier for a worker-count move on a dispatch stage."""
        new = ov.get("workers")
        if not new or fit.layer != "dispatch":
            return 1.0
        return max(1, fit.servers) / max(1, int(new))

    def _batch_scale(self, fit: _StageFit, ov: Mapping[str, Any]) -> float:
        """Service-time multiplier for a batch-size move, read off the
        FITTED service curve (bucket means): s(new bucket) / s(base)."""
        new = ov.get("batch")
        if not new or fit.layer != "dispatch" or not fit.curve:
            return 1.0
        base_b = self._actuators.get("batch")
        if base_b is None and fit.lam_batches > 0.0:
            base_b = fit.lam_rows / fit.lam_batches  # fitted mean batch
        base_s = self._curve_at(fit, base_b) if base_b else None
        new_s = self._curve_at(fit, float(new))
        if not base_s or not new_s:
            return 1.0
        return new_s / base_s

    @staticmethod
    def _curve_at(fit: _StageFit, batch: float) -> float | None:
        if not fit.curve:
            return None
        b = min(fit.curve, key=lambda k: abs(k - batch))
        return fit.curve.get(b) or None

    def _wq_shift(self, drain: _StageFit, ov: Mapping[str, Any],
                  lam_scale: float) -> float:
        """How the drain stage's W_q moves under overrides — the factor a
        queue stage's fitted wait is scaled by. Anchored to observation:
        with no overrides the factor is 1, so steady-state prediction
        stays what was measured."""
        scale = self._batch_scale(drain, ov)
        rho0 = min(_RHO_CAP, max(1e-6, drain.utilization))
        rho1 = min(_RHO_CAP, rho0 * lam_scale * self._server_shift(drain, ov)
                   * scale)
        wq0 = rho0 / (1.0 - rho0)
        wq1 = scale * rho1 / (1.0 - rho1)
        return wq1 / wq0 if wq0 > 0 else 1.0

    def _deadline_shift(self, wait_s: float, ov: Mapping[str, Any]) -> float:
        """Batcher-deadline move: the coalescing wait scales with the
        deadline and is capped by it (monotonic in the new deadline)."""
        new = ov.get("deadline_ms")
        base = self._actuators.get("deadline_ms")
        if not new or not base or base <= 0:
            return wait_s
        return min(float(new) / 1e3, wait_s * float(new) / float(base))

    def _e2e_predict(self, fits: Mapping[str, _StageFit],
                     overrides: Mapping[str, Any] | None = None,
                     ) -> tuple[dict[str, dict[str, float]],
                                dict[str, float]]:
        """Per-stage + summed predictions; the observed side sums the SAME
        stage set's digest quantiles so both sides of the error ratio are
        defined identically."""
        stages: dict[str, dict[str, float]] = {}
        pred50 = pred99 = obs50 = obs99 = 0.0
        for stage, fit in fits.items():
            if fit.work_count <= 0:
                continue
            p50, p99 = self._predict_stage(stage, fit, fits, overrides)
            stages[stage] = {
                "predicted_p50_ms": round(p50, 4),
                "predicted_p99_ms": round(p99, 4),
                "observed_p50_ms": round(fit.observed_p50_ms, 4),
                "observed_p99_ms": round(fit.observed_p99_ms, 4),
            }
            pred50 += p50
            pred99 += p99
            obs50 += fit.observed_p50_ms
            obs99 += fit.observed_p99_ms
        e2e = {
            "predicted_p50_ms": round(pred50, 4),
            "predicted_p99_ms": round(pred99, 4),
            "observed_p50_ms": round(obs50, 4),
            "observed_p99_ms": round(obs99, 4),
        }
        if obs99 > 0.0:
            e2e["error_ratio"] = round(abs(pred99 - obs99) / obs99, 6)
        return stages, e2e

    def _attribute_bottleneck(self) -> None:
        """Min-headroom stage among those carrying traffic (call under
        _mu). A fully idle window keeps the previous attribution.

        Two refinements keep the attribution caller-honest:

        - Near-saturation ties break on predicted wait contribution:
          when several stages sit inside a 1.2x band of the minimum
          headroom, the one whose predicted p99 dominates e2e latency is
          the bottleneck the caller feels.
        - A work stage fed by a BACKING-UP queue (:data:`QUEUE_FEEDS`,
          queue utilization >= 0.5) yields attribution to that queue:
          the fed lane runs flat out — rho -> 1 — exactly because the
          queue ahead of it is overflowing, and the queue's own
          wait-inverted rho asymptotes to 1 from below, so it could
          never numerically undercut its drain lane; the backlog the
          caller waits in is the queue's. A drain that saturates on its
          own (a cost step at low queue pressure) keeps the
          attribution — the sentinel names the cost change."""
        candidates = [(stage, fit) for stage, fit in self._fits.items()
                      if fit.active and fit.lam_batches > 0.0]
        if not candidates:
            return
        floor = min(fit.headroom for _, fit in candidates)
        near = [(stage, fit) for stage, fit in candidates
                if fit.headroom <= max(floor * 1.2, floor + 1e-9)]
        if len(near) > 1:
            stage, fit = max(
                near, key=lambda kv: self._predict_stage(
                    kv[0], kv[1], self._fits)[1])
        else:
            stage, fit = near[0]
        for q, fed in QUEUE_FEEDS.items():
            if stage in fed:
                qfit = self._fits.get(q)
                if qfit is not None and qfit.active \
                        and qfit.utilization >= 0.5:
                    stage, fit = q, qfit
                break
        self._bottleneck = {
            "stage": stage,
            "layer": fit.layer,
            "headroom_ratio": round(fit.headroom, 4),
            "utilization": round(fit.utilization, 4),
            "admitted_rows_per_s": round(fit.lam_rows, 3),
            "max_rows_per_s": (round(fit.max_rows_per_s, 3)
                               if fit.max_rows_per_s else None),
        }

    def _predict_into_gauges(self) -> None:
        """Refresh exported gauges from the fitted state (under _mu)."""
        stages, e2e = self._e2e_predict(self._fits)
        self._e2e = e2e
        bn = (self._bottleneck or {}).get("stage")
        for stage, fit in self._fits.items():
            labels = {"stage": stage}
            if self._g_headroom is not None:
                self._g_headroom.set(fit.headroom, labels=labels)
                self._g_util.set(fit.utilization, labels=labels)
                self._g_bottleneck.set(1.0 if stage == bn else 0.0,
                                       labels=labels)
            if self._g_pred is not None and stage in stages:
                self._g_pred.set(stages[stage]["predicted_p99_ms"],
                                 labels=labels)
        if self._g_pred is not None:
            self._g_pred.set(e2e["predicted_p99_ms"],
                             labels={"stage": "e2e"})
        if self._g_err is not None and "error_ratio" in e2e:
            self._g_err.set(e2e["error_ratio"])

    # -- documents ---------------------------------------------------------
    def _document_locked(self, overrides: Mapping[str, Any] | None = None,
                         ) -> dict[str, Any]:
        stages_pred, e2e = self._e2e_predict(self._fits, overrides)
        doc_stages: dict[str, Any] = {}
        for stage, fit in self._fits.items():
            entry: dict[str, Any] = {
                "layer": fit.layer,
                "arrival_batches_per_s": round(fit.lam_batches, 4),
                "arrival_rows_per_s": round(fit.lam_rows, 3),
                "mean_service_ms": round(1e3 * fit.mean_service_s, 4),
                "utilization": round(fit.utilization, 4),
                "servers": fit.servers,
                "headroom_ratio": round(fit.headroom, 4),
                "samples": fit.work_count,
            }
            if fit.curve:
                entry["fitted_curve_ms"] = {
                    str(b): round(1e3 * s, 4)
                    for b, s in sorted(fit.curve.items())
                }
            if fit.knee_batch is not None:
                entry["knee"] = {
                    "batch": fit.knee_batch,
                    "mean_ms": round(
                        1e3 * (fit.curve.get(fit.knee_batch) or 0.0), 4),
                    "max_rows_per_s": round(fit.max_rows_per_s or 0.0, 3),
                }
            base = self._baseline.get(stage)
            if base is not None:
                mean_ms = 1e3 * fit.mean_service_s
                # worst per-bucket deviation for curve-bearing stages
                # (what the sentinel actually judges); mean-based otherwise
                ratio = self._worst_ratio.get(
                    stage, mean_ms / base if base > 0 else 1.0)
                entry["regression"] = {
                    "baseline_mean_ms": round(base, 4),
                    "ratio": round(ratio, 4),
                    "in_regression": bool(self._in_regression.get(stage)),
                    "fired_total": self._regressions.get(stage, 0),
                }
            if stage in stages_pred:
                entry.update(stages_pred[stage])
            doc_stages[stage] = entry
        doc: dict[str, Any] = {
            "schema": CAPACITY_SCHEMA,
            "generated_unix": time.time(),
            "fitted_unix": self._fitted_unix,
            "window_s": round(self._window_s, 3),
            "refreshes": self._refreshes,
            "model": {
                "kind": "mm1-exponential-tail",
                "ewma_alpha": self.ewma_alpha,
                "min_samples": self.min_samples,
                "regression_tolerance": self.regression_tolerance,
                "baseline_source": self._baseline_source,
            },
            "actuators": dict(self._actuators),
            "stages": doc_stages,
            "e2e": e2e,
            "bottleneck": self._bottleneck,
        }
        if overrides:
            base_e2e = dict(self._e2e)
            doc["whatif"] = {
                "requested": {k: v for k, v in overrides.items()
                              if v is not None},
                "base_predicted_p99_ms": base_e2e.get("predicted_p99_ms"),
                "predicted_p99_ms": e2e["predicted_p99_ms"],
                "delta_p99_ms": round(
                    e2e["predicted_p99_ms"]
                    - (base_e2e.get("predicted_p99_ms") or 0.0), 4),
            }
        return doc

    def snapshot(self) -> dict[str, Any]:
        """The ``/capacity`` document (:data:`CAPACITY_SCHEMA`) from the
        fitted state — no profiler access, safe from any thread."""
        with self._mu:
            return self._document_locked()

    def whatif(self, workers: int | None = None, batch: int | None = None,
               deadline_ms: float | None = None,
               max_inflight: int | None = None) -> dict[str, Any]:
        """Evaluate an actuator move against the fitted model WITHOUT
        touching the live system: the same capacity document, with every
        prediction recomputed under the overrides plus a ``whatif``
        section carrying the predicted-p99 delta."""
        overrides = {"workers": workers, "batch": batch,
                     "deadline_ms": deadline_ms,
                     "max_inflight": max_inflight}
        with self._mu:
            return self._document_locked(overrides)

    def breach_summary(self) -> dict[str, Any]:
        """Compact capacity state for incident bundles (schema v3): the
        bottleneck, its headroom, and predicted-vs-observed at breach."""
        with self._mu:
            out: dict[str, Any] = {
                "bottleneck": self._bottleneck,
                "e2e": dict(self._e2e),
                "window_s": round(self._window_s, 3),
                "regressions": {
                    s: n for s, n in sorted(self._regressions.items()) if n
                },
            }
        return out

    # -- supervised-service surface ----------------------------------------
    def reset(self) -> None:
        self._stop.clear()

    def stop(self) -> None:
        self._stop.set()

    def run(self, interval_s: float = 2.0) -> None:
        while not self._stop.wait(interval_s):
            self.refresh()


def _num(doc: Mapping[str, Any], key: str) -> bool:
    v = doc.get(key)
    return isinstance(v, (int, float)) and math.isfinite(v)


def validate_capacity(doc: Any) -> list[str]:
    """Schema check for a capacity document -> list of problems ([] =
    valid). Hand-rolled like ``validate_profile``: the CI smoke gates on
    NAMED failures, not a boolean."""
    errs: list[str] = []
    if not isinstance(doc, Mapping):
        return ["document: not a mapping"]
    if doc.get("schema") != CAPACITY_SCHEMA:
        errs.append(f"schema: expected {CAPACITY_SCHEMA!r}, "
                    f"got {doc.get('schema')!r}")
    if not _num(doc, "generated_unix"):
        errs.append("generated_unix: missing")
    if not isinstance(doc.get("actuators"), Mapping):
        errs.append("actuators: missing mapping")
    stages = doc.get("stages")
    if not isinstance(stages, Mapping):
        return errs + ["stages: missing"]
    for name, entry in stages.items():
        if not isinstance(entry, Mapping):
            errs.append(f"stages.{name}: not a mapping")
            continue
        if entry.get("layer") not in ("queue", "service", "dispatch"):
            errs.append(f"stages.{name}.layer: invalid")
        for k in ("arrival_batches_per_s", "mean_service_ms",
                  "utilization", "headroom_ratio"):
            if not _num(entry, k):
                errs.append(f"stages.{name}.{k}: missing/non-finite")
    e2e = doc.get("e2e")
    if not isinstance(e2e, Mapping):
        errs.append("e2e: missing mapping")
    else:
        for k in ("predicted_p50_ms", "predicted_p99_ms"):
            if not _num(e2e, k):
                errs.append(f"e2e.{k}: missing/non-finite")
    bn = doc.get("bottleneck")
    if bn is not None:
        if not isinstance(bn, Mapping) or not isinstance(
                bn.get("stage"), str):
            errs.append("bottleneck: must carry a stage name when present")
        elif bn["stage"] not in stages:
            errs.append(f"bottleneck.stage: {bn['stage']!r} not in stages")
    wi = doc.get("whatif")
    if wi is not None:
        if not isinstance(wi, Mapping) or not isinstance(
                wi.get("requested"), Mapping):
            errs.append("whatif: must carry the requested overrides")
        elif not _num(wi, "predicted_p99_ms"):
            errs.append("whatif.predicted_p99_ms: missing")
    return errs
