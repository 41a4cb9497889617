"""Declarative SLOs: burn-rate evaluation + a per-layer latency-budget ledger.

The port's copy of ccfd_tpu/observability/slo.py. The transport floor
(CCFD_SLO_TRANSPORT_FLOOR_MS) keeps the reference's default as a static
budget layer; it is not a figure measured on the card.

The overload plane (PR 6) reacts to latency; nothing yet states the
OBJECTIVE it defends. This module closes that gap with the SRE canon's
machinery, sized for this pipeline:

- :class:`SLOSpec` — a declarative objective, loadable from the platform
  CR's ``slo:`` block (or built from the ``CCFD_SLO_*`` env defaults):
  latency SLOs ("99% of decisions under 50 ms", judged from the existing
  latency histograms via interpolated ``count_le``) and error-rate SLOs
  (good = total − errors from counters). Specs name the SLO the alerts
  and gauges carry (``e2e-p99``, ``rest-p99``, ``error-rate``).

- :class:`SLOEngine` — multi-window burn-rate evaluation (Google SRE
  workbook shape): per spec, good/bad event deltas accumulate into a time
  ring; each window's **burn rate** is its bad-fraction divided by the
  error budget (1 − objective), exported as
  ``ccfd_slo_burn_rate{slo,window}``. A breach trips when EVERY fast
  window — all but the last, by default the 5 m short window confirming
  the 1 h window — exceeds ``fast_burn`` — edge-triggered into
  ``ccfd_slo_breach_total{slo}`` so one incident counts once — and
  ``ccfd_slo_error_budget_remaining{slo}`` tracks the budget left over
  the slow (6 h) window. Window lengths are configurable (the CI smoke
  shrinks them to seconds); defaults are the canonical 5m/1h fast pair +
  6h slow window.

- :class:`BudgetLedger` — the per-layer latency budget for the NativeFront
  REST path ROADMAP item 1 needs before the ≥50k tx/s on-device target
  can be decomposed: the r04 ``rest_latency_floor`` transport floor
  (0.072 ms p99, REST_SWEEP; ``CCFD_SLO_TRANSPORT_FLOOR_MS``) as a static
  layer, measured batcher wait and device dispatch from the
  :class:`~ccfd_tpu_torch.observability.profile.StageProfiler`, and an H2D
  layer that reads the MEASURED transfer digest from the device
  telemetry plane (observability/device.py) when it is armed — the
  pre-telemetry explicit-zero reservation remains the fallback so the
  ledger's shape is stable either way. Each layer gets a slice of the
  SLO target; ``ccfd_slo_budget_spent_ratio{slo,layer}`` says which
  layer is eating the budget.

The engine runs as a default-on supervised service under the operator
(CR ``slo:`` block, ``CCFD_SLO=0`` kill switch) and is driven inline by
a harness.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Mapping, Sequence

from ccfd_tpu_torch.metrics.prom import Histogram, Registry

# canonical multi-window ladder: (seconds, burn threshold). The first two
# are the FAST pair (short window confirms long — the workbook's 14.4x
# page condition); the last is the slow budget-consumption window.
DEFAULT_WINDOWS = ((300.0, 14.4), (3600.0, 14.4), (21600.0, 1.0))


def window_name(seconds: float) -> str:
    if seconds >= 3600 and seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    if seconds >= 60 and seconds % 60 == 0:
        return f"{int(seconds // 60)}m"
    return f"{seconds:g}s"


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    ``kind="latency"``: ``metric`` names a latency histogram (seconds);
    good events are observations at/below ``target_ms``. ``objective`` is
    the good fraction promised (0.99 -> 1% error budget).

    ``kind="error_rate"``: ``metric`` names the total-events counter and
    ``error_metric`` the failures counter (both summed across label
    sets); the objective is ``1 - max_error_rate``.
    """

    name: str
    kind: str = "latency"                 # "latency" | "error_rate"
    metric: str = ""
    target_ms: float = 50.0
    objective: float = 0.99
    error_metric: str = ""

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - float(self.objective))

    @staticmethod
    def from_mapping(m: Mapping[str, Any]) -> "SLOSpec":
        """CR ``slo.specs[]`` entry -> spec. Unknown keys are rejected at
        load time (a typo'd guardrail must not silently vanish)."""
        known = {f.name for f in dataclasses.fields(SLOSpec)}
        extra = set(m) - known - {"max_error_rate"}
        if extra:
            raise ValueError(f"slo spec {m.get('name')!r}: "
                             f"unknown keys {sorted(extra)}")
        kw = {k: m[k] for k in known if k in m}
        if "max_error_rate" in m:  # sugar for error-rate objectives
            kw["objective"] = 1.0 - float(m["max_error_rate"])
            kw.setdefault("kind", "error_rate")
        if not kw.get("name"):
            raise ValueError("slo spec needs a name")
        return SLOSpec(**kw)


class _Source:
    """Resolves a spec's (good, bad) cumulative totals from registries.
    Resolution is lazy and re-tried each read: component registries gain
    their metrics as traffic starts, after the engine is built."""

    def __init__(self, spec: SLOSpec,
                 registries: Mapping[str, Registry]):
        self.spec = spec
        self._registries = registries
        self._metric = None
        self._error_metric = None

    def _resolve(self, name: str):
        for reg in self._registries.values():
            m = reg.get(name)
            if m is not None:
                return m
        return None

    def totals(self) -> tuple[float, float]:
        """-> cumulative (good, bad) event counts since process start."""
        spec = self.spec
        if self._metric is None:
            self._metric = self._resolve(spec.metric)
        if self._metric is None:
            return 0.0, 0.0
        if spec.kind == "latency":
            if not isinstance(self._metric, Histogram):
                return 0.0, 0.0
            # aggregate across label sets: the serving latency series is
            # labeled by endpoint, and the objective covers all of them
            total = float(self._metric.total_count())
            good = float(self._metric.total_count_le(spec.target_ms / 1e3))
            return good, max(0.0, total - good)
        # error_rate: counters summed across label sets
        if self._error_metric is None:
            self._error_metric = self._resolve(spec.error_metric)
        total = float(self._metric.total())
        bad = (float(self._error_metric.total())
               if self._error_metric is not None else 0.0)
        return max(0.0, total - bad), bad


class _Tracker:
    """Per-spec window ring of (t, good_delta, bad_delta) samples.

    Samples closer together than ``bucket_s`` MERGE into the newest ring
    entry: the ring then holds at most ~slow_window/bucket_s entries
    regardless of how fast the engine ticks — without this, a short
    ``interval_s`` against the default 6 h slow window would silently age
    burned budget out of a fixed-size ring hours early."""

    __slots__ = ("source", "ring", "bucket_s", "last_good", "last_bad",
                 "breaching")

    def __init__(self, source: _Source, slow_window_s: float):
        self.source = source
        # <= 4096 live buckets per slow window; deque bound is a backstop
        self.bucket_s = max(1e-3, float(slow_window_s) / 4096.0)
        self.ring: collections.deque = collections.deque(maxlen=8192)
        self.last_good = 0.0
        self.last_bad = 0.0
        self.breaching = False

    def sample(self, now: float) -> None:
        good, bad = self.source.totals()
        dg, db = good - self.last_good, bad - self.last_bad
        self.last_good, self.last_bad = good, bad
        if dg < 0 or db < 0:  # registry replaced / counter reset
            dg = db = 0.0
        if not (dg or db):
            return
        if self.ring and now - self.ring[-1][0] < self.bucket_s:
            t, g, b = self.ring[-1]
            self.ring[-1] = (t, g + dg, b + db)
        else:
            self.ring.append((now, dg, db))

    def window_fractions(self, now: float,
                         seconds: float) -> tuple[float, float]:
        """-> (bad_fraction, events) over the trailing window."""
        cutoff = now - seconds
        good = bad = 0.0
        for t, dg, db in reversed(self.ring):
            if t < cutoff:
                break
            good += dg
            bad += db
        total = good + bad
        return (bad / total if total else 0.0), total


class SLOEngine:
    """Evaluates SLO specs on a tick; owns the burn/budget/breach metrics
    and (optionally) a :class:`BudgetLedger`. Thread-safe; run either as
    a supervised loop (:meth:`run`) or ticked inline (tools)."""

    def __init__(
        self,
        specs: Sequence[SLOSpec],
        registries: Mapping[str, Registry],
        registry: Registry | None = None,
        windows: Sequence[tuple[float, float]] = DEFAULT_WINDOWS,
        ledger: "BudgetLedger | None" = None,
        profiler=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if len(windows) < 2:
            raise ValueError("burn-rate evaluation needs at least one "
                             "fast window plus the slow budget window")
        self.specs = list(specs)
        self.windows = [(float(s), float(th)) for s, th in windows]
        self.ledger = ledger
        # breach-edge listeners (observability/incident.py FlightRecorder):
        # fn(slo_name, status_doc) fires once per ENTRY into the breaching
        # state, same edge semantics as ccfd_slo_breach_total
        self._breach_listeners: list[Callable[[str, dict], Any]] = []
        # the stage profiler whose ccfd_stage_latency_ms gauges this
        # engine's tick refreshes (the supervised tick is the sampling
        # clock for the SLO board's decomposition panels; /profile reads
        # and the exporter scrape refresh too)
        self.profiler = profiler
        self._clock = clock
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._trackers = {
            spec.name: _Tracker(_Source(spec, registries),
                                slow_window_s=self.windows[-1][0])
            for spec in self.specs
        }
        r = registry if registry is not None else Registry()
        self.registry = r
        self._g_burn = r.gauge(
            "ccfd_slo_burn_rate",
            "error-budget burn rate by SLO and window (1.0 = consuming "
            "exactly the budget; the fast pair alerts at its threshold)",
        )
        self._g_budget = r.gauge(
            "ccfd_slo_error_budget_remaining",
            "fraction of the SLO's error budget left over the slow window",
        )
        self._c_breach = r.counter(
            "ccfd_slo_breach_total",
            "fast-window burn-rate breaches by SLO (edge-triggered: one "
            "increment per entry into the breaching state)",
        )
        self._g_breaching = r.gauge(
            "ccfd_slo_breaching",
            "1 while the SLO's fast-window pair is above threshold",
        )
        self._c_listener_err = r.counter(
            "ccfd_slo_listener_errors_total",
            "breach-listener callbacks that raised: the breach evaluated, "
            "but its evidence capture (flight recorder, planner hook) "
            "did not run",
        )

    # -- construction helpers ---------------------------------------------
    @staticmethod
    def default_specs(cfg) -> list[SLOSpec]:
        """The stock objectives the operator arms when the CR declares
        none: end-to-end decision p-latency, REST request p-latency, and
        the process-start error rate."""
        return [
            SLOSpec("e2e-p99", kind="latency",
                    metric="router_decision_seconds",
                    target_ms=cfg.slo_e2e_target_ms,
                    objective=cfg.slo_objective),
            SLOSpec("rest-p99", kind="latency",
                    metric="seldon_api_executor_client_requests_seconds",
                    target_ms=cfg.slo_rest_target_ms,
                    objective=cfg.slo_objective),
            SLOSpec("error-rate", kind="error_rate",
                    metric="transaction_incoming_total",
                    error_metric="router_process_start_errors_total",
                    objective=1.0 - cfg.slo_max_error_rate),
        ]

    @staticmethod
    def windows_from_config(cfg,
                            override: Any = None) -> list[tuple[float, float]]:
        """``CCFD_SLO_WINDOWS``/CR ``windows`` ("300,3600,21600") +
        ``fast_burn`` -> the (seconds, threshold) ladder: every window but
        the last is a fast window at ``fast_burn``; the last is the slow
        budget window at 1.0."""
        raw = override if override is not None else cfg.slo_windows
        if isinstance(raw, str):
            secs = [float(s) for s in raw.split(",") if s.strip()]
        else:
            secs = [float(s) for s in raw]
        if len(secs) < 2:
            raise ValueError(f"slo windows need >= 2 entries, got {secs}")
        fast = float(cfg.slo_fast_burn)
        return [(s, fast) for s in secs[:-1]] + [(secs[-1], 1.0)]

    @staticmethod
    def from_config(cfg, registries: Mapping[str, Registry],
                    registry: Registry, profiler=None,
                    options: Mapping[str, Any] | None = None,
                    telemetry=None) -> "SLOEngine":
        """The operator/CLI construction path: CR ``slo:`` options overlay
        the ``CCFD_SLO_*`` env defaults; ``specs:`` replaces the stock
        objectives wholesale when declared. ``telemetry`` (the
        DeviceTelemetry plane) upgrades the ledger's ``h2d`` layer from
        the fixed reservation to the measured transfer digest."""
        opts = dict(options or {})
        raw_specs = opts.get("specs")
        specs = ([SLOSpec.from_mapping(s) for s in raw_specs]
                 if raw_specs else SLOEngine.default_specs(cfg))
        windows = SLOEngine.windows_from_config(cfg, opts.get("windows"))
        ledger = None
        if profiler is not None and any(s.name == "rest-p99" for s in specs):
            target = next(s.target_ms for s in specs
                          if s.name == "rest-p99")
            ledger = BudgetLedger.for_rest_path(
                cfg, profiler, registry, target_ms=target,
                budgets=opts.get("budget"), telemetry=telemetry)
        return SLOEngine(specs, registries, registry=registry,
                         windows=windows, ledger=ledger,
                         profiler=profiler)

    def add_breach_listener(self, fn: Callable[[str, dict], Any]) -> None:
        """``fn(slo_name, status_doc)`` fires on every breach EDGE (once
        per entry into breaching, again only after recovery + re-breach) —
        the incident flight recorder's trigger."""
        self._breach_listeners.append(fn)

    # -- evaluation --------------------------------------------------------
    def tick(self, now: float | None = None) -> dict[str, Any]:
        """One evaluation pass; returns the status document (the shape
        a report embeds next to the StageProfile)."""
        now = self._clock() if now is None else now
        if self.profiler is not None:
            self.profiler.refresh_gauges()
        out: dict[str, Any] = {"slos": {}, "windows": [
            {"window": window_name(s), "seconds": s, "threshold": th}
            for s, th in self.windows
        ]}
        fired: list[str] = []
        with self._mu:
            # every window but the last is a FAST alerting window (the
            # short ones confirm the long ones); the last is the slow
            # budget-trend window and never participates in breaching
            n_fast = len(self.windows) - 1
            for spec in self.specs:
                tr = self._trackers[spec.name]
                tr.sample(now)
                burns: dict[str, float] = {}
                fast_over = 0
                for i, (seconds, threshold) in enumerate(self.windows):
                    frac, events = tr.window_fractions(now, seconds)
                    burn = frac / spec.error_budget
                    wname = window_name(seconds)
                    burns[wname] = round(burn, 4)
                    self._g_burn.set(burn, labels={
                        "slo": spec.name, "window": wname})
                    if i < n_fast and events > 0 and burn >= threshold:
                        fast_over += 1
                # slow-window budget remaining
                slow_s, _ = self.windows[-1]
                slow_frac, _ = tr.window_fractions(now, slow_s)
                remaining = max(0.0, 1.0 - slow_frac / spec.error_budget)
                self._g_budget.set(remaining, labels={"slo": spec.name})
                breaching = fast_over == n_fast
                if breaching and not tr.breaching:
                    self._c_breach.inc(labels={"slo": spec.name})
                    fired.append(spec.name)
                tr.breaching = breaching
                self._g_breaching.set(
                    1.0 if breaching else 0.0, labels={"slo": spec.name})
                out["slos"][spec.name] = {
                    "kind": spec.kind,
                    "objective": spec.objective,
                    "target_ms": (spec.target_ms
                                  if spec.kind == "latency" else None),
                    "burn_rate": burns,
                    "error_budget_remaining": round(remaining, 4),
                    "breaching": breaching,
                    "breaches": int(self._c_breach.value(
                        {"slo": spec.name})),
                }
            if self.ledger is not None:
                out["budget_ledger"] = self.ledger.evaluate()
        # listeners run OUTSIDE the engine lock: the flight recorder reads
        # registries/profiler and must never deadlock a concurrent tick
        for name in fired:
            for fn in self._breach_listeners:
                try:
                    fn(name, out)
                except Exception:  # noqa: BLE001 - evidence capture must
                    self._c_listener_err.inc()  # never fail the evaluation
        return out

    def breaches(self, slo: str) -> int:
        return int(self._c_breach.value({"slo": slo}))

    def any_breaching(self) -> bool:
        """True while ANY objective sits in the breaching state (between a
        breach edge and its recovery tick) — the decision-audit plane's
        definition of "an incident is open": routed transactions stamped
        in this window carry the newest incident bundle's id."""
        with self._mu:
            return any(tr.breaching for tr in self._trackers.values())

    # -- supervised-service surface ---------------------------------------
    def reset(self) -> None:
        self._stop.clear()

    def stop(self) -> None:
        self._stop.set()

    def run(self, interval_s: float = 5.0) -> None:
        while not self._stop.wait(interval_s):
            self.tick()


class BudgetLedger:
    """Per-layer latency budget for one SLO's path (the REST path today).

    Layers are ``(name, budget_ms, fetch)`` where ``fetch()`` returns
    either a static spent value in ms (the measured transport floor, the
    H2D placeholder) or a live
    :class:`~ccfd_tpu_torch.observability.profile.LatencyDigest`. ``evaluate``
    exports ``ccfd_slo_budget_spent_ratio{slo,layer}`` (spent p99 /
    layer budget) and returns the ledger snapshot — whose per-layer
    ``count``/``sum_s`` let a harness attribute a latency DELTA to the
    layer that ate it (the smoke's ≥80%-to-dispatch assertion).
    """

    def __init__(self, slo: str, target_ms: float, registry: Registry,
                 layers: Sequence[tuple[str, float, Callable[[], Any]]]):
        self.slo = slo
        self.target_ms = float(target_ms)
        self.layers = list(layers)
        self._g_ratio = registry.gauge(
            "ccfd_slo_budget_spent_ratio",
            "measured p99 spend over the layer's latency-budget slice, "
            "by SLO and layer (>1 = the layer alone blows its slice)",
        )

    @staticmethod
    def for_rest_path(cfg, profiler, registry: Registry,
                      target_ms: float | None = None,
                      budgets: Mapping[str, float] | None = None,
                      telemetry=None) -> "BudgetLedger":
        """The REST-path ledger ROADMAP item 1 decomposes against:
        transport floor (static, the r04 ``rest_latency_floor`` number),
        batcher wait + device dispatch (measured via the profiler), and
        the H2D staging layer. Default budget slices: transport gets 2x
        its floor (min-clamped to 0.2 ms — the clamp binds at the shipped
        0.072 ms floor), H2D a fixed 0.5 ms slice, and the remainder
        splits 60/40 dispatch/batcher-wait; a CR ``budget:`` mapping
        overrides any slice.

        ``telemetry`` (observability/device.py DeviceTelemetry): when the
        device plane is armed, the ``h2d`` layer reads the MEASURED
        per-transfer digest from the scorer's instrumented staging path;
        without it the layer keeps the explicit-zero reservation so the
        ledger schema (and the planner's view) is stable either way."""
        target = float(target_ms if target_ms is not None
                       else cfg.slo_rest_target_ms)
        floor_ms = float(cfg.slo_transport_floor_ms)
        b = dict(budgets or {})
        transport_b = float(b.get("transport", max(2.0 * floor_ms, 0.2)))
        h2d_b = float(b.get("h2d", 0.5))
        remainder = max(target - transport_b - h2d_b, 1.0)
        dispatch_b = float(b.get("dispatch", 0.6 * remainder))
        wait_b = float(b.get("batcher_wait", 0.4 * remainder))

        def h2d_fetch():
            if telemetry is not None:
                # measured: each sample is one staging put on the scorer
                # dispatch path (ccfd_h2d_seconds' digest twin). NOTE:
                # this digest is PROCESS-WIDE — the operator arms one
                # telemetry plane and one scorer serves both the router
                # and REST lanes, so unlike the lane-scoped rest.batcher/
                # rest.dispatch digests it folds bus-lane puts in too.
                # Read it as an upper bound on the REST lane's per-put
                # staging cost until puts carry lane context.
                return telemetry.h2d_digest()
            # telemetry disarmed: the pre-telemetry reservation, an
            # explicit zero rather than an absence (regression-tested)
            return 0.0

        return BudgetLedger(
            "rest-p99", target, registry,
            layers=[
                ("transport", transport_b, lambda: floor_ms),
                ("batcher_wait", wait_b,
                 lambda: profiler.digest("rest.batcher", "queue")),
                ("dispatch", dispatch_b,
                 lambda: profiler.digest("rest.dispatch", "dispatch")),
                ("h2d", h2d_b, h2d_fetch),
            ])

    def evaluate(self) -> dict[str, Any]:
        layers: dict[str, Any] = {}
        spent_mean_sum = 0.0
        for name, budget_ms, fetch in self.layers:
            val = fetch()
            if val is None:
                entry = {"budget_ms": round(budget_ms, 4), "count": 0,
                         "sum_s": 0.0, "spent_p99_ms": 0.0,
                         "spent_mean_ms": 0.0, "ratio": 0.0}
            elif isinstance(val, (int, float)):
                entry = {"budget_ms": round(budget_ms, 4), "count": 0,
                         "sum_s": 0.0,
                         "spent_p99_ms": round(float(val), 4),
                         "spent_mean_ms": round(float(val), 4),
                         "ratio": round(float(val) / budget_ms, 4)
                         if budget_ms > 0 else 0.0,
                         "static": True}
            else:  # LatencyDigest
                d = val.to_dict()
                p99 = d.get("p99_ms", 0.0)
                entry = {
                    "budget_ms": round(budget_ms, 4),
                    "count": d["count"],
                    "sum_s": d.get("sum_s", 0.0),
                    "spent_p99_ms": p99,
                    "spent_mean_ms": d.get("mean_ms", 0.0),
                    "ratio": (round(p99 / budget_ms, 4)
                              if budget_ms > 0 else 0.0),
                }
            spent_mean_sum += entry["spent_mean_ms"]
            self._g_ratio.set(entry["ratio"],
                              labels={"slo": self.slo, "layer": name})
            layers[name] = entry
        return {
            "slo": self.slo,
            "target_ms": self.target_ms,
            "layers": layers,
            "spent_mean_sum_ms": round(spent_mean_sum, 4),
        }
