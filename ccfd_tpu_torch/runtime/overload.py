"""Overload control: adaptive admission and priority-aware shedding.

The port's copy of ccfd_tpu/runtime/overload.py. Four pieces, composed by
the router, the REST front and the ``router`` role:

- :class:`AdaptiveInflightBudget`: an AIMD concurrency limiter with the
  ``InflightBudget`` surface. A stage latency above ``target_s`` cuts the
  limit multiplicatively (one cut per cooldown), a window of in-budget
  observations grows it additively. One instance shared by every
  ``ParallelRouter`` worker keeps the bound global.
- :class:`DeadlinePolicy`: CoDel-style drop-from-front when a record's
  queue sojourn exceeds a target, scaled 1x/2x/4x for bulk/normal/critical.
- :class:`OverloadControl`: the router's admission plane (deadline sheds,
  budget victims picked lowest priority first and oldest first within a
  class, the ``ccfd_priority_inversions_total`` tripwire) and the dispatch
  watchdog, which bounds a scorer dispatch and lets its expiry fall into
  the router's counted degradation ladder.
- :class:`AdmissionGate`: request-atomic admission on the REST front with
  priority-tiered utilization ceilings (bulk refused at 50%, normal at 90%,
  critical at 100%), answered with 429 and a retry-after.

Priorities ride as data: a bus record's ``priority`` header, a REST
request's ``x-ccfd-priority`` header (``bulk`` / ``normal`` /
``critical``); anything else is normal. The bus deadline is off by default
(``CCFD_OVERLOAD_CODEL_TARGET_MS=0``). The bulk ceiling
(``set_bulk_ceiling`` on the router's plane and the REST gate, gauge
``ccfd_bulk_ceiling{stage}``) is the replay plane's actuator: the share of
a stage's adaptive budget bulk work may occupy. ``recorder`` (the incident
flight recorder, wired by the operator) snapshots the system into its ring
on every watchdog kill. ``AdaptiveInflightBudget.rescale_ceiling`` is the
fleet's admission actuator: each member's AIMD range under its equal share
of the fleet-wide ceiling (fleet/member.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Mapping

from ccfd_tpu_torch.router.router import InflightBudget

# priority classes, "bigger is more precious": shed ascending
PRIORITY_BULK, PRIORITY_NORMAL, PRIORITY_CRITICAL = 0, 1, 2
PRIORITY_NAMES = {PRIORITY_BULK: "bulk", PRIORITY_NORMAL: "normal",
                  PRIORITY_CRITICAL: "critical"}
_PRIORITY_BY_NAME = {
    "bulk": PRIORITY_BULK, "low": PRIORITY_BULK,
    "normal": PRIORITY_NORMAL, "default": PRIORITY_NORMAL,
    "critical": PRIORITY_CRITICAL, "high": PRIORITY_CRITICAL,
    "fraud": PRIORITY_CRITICAL, "canary": PRIORITY_CRITICAL,
    "shadow": PRIORITY_CRITICAL, "rescore": PRIORITY_BULK,
}


def parse_priority(value: Any, default: int = PRIORITY_NORMAL) -> int:
    """Header/payload value -> priority class: the class names and their
    aliases, bytes, bare ints; anything unparseable is ``default``."""
    if value is None:
        return default
    if isinstance(value, bytes):
        value = value.decode("latin-1", "replace")
    if isinstance(value, str):
        v = value.strip().lower()
        if v in _PRIORITY_BY_NAME:
            return _PRIORITY_BY_NAME[v]
        try:
            value = int(v)
        except ValueError:
            return default
    if isinstance(value, (int, float)):
        return min(PRIORITY_CRITICAL, max(PRIORITY_BULK, int(value)))
    return default


def headers_priority(headers: Any, default: int = PRIORITY_NORMAL) -> int:
    """Priority from a header carrier: a mapping or a ``[(key, value)]``
    list. Missing -> ``default``."""
    if not headers:
        return default
    if isinstance(headers, Mapping):
        return parse_priority(headers.get("priority"), default)
    try:
        for k, v in headers:
            kk = k.decode("latin-1") if isinstance(k, bytes) else k
            if kk == "priority":
                return parse_priority(v, default)
    except (TypeError, ValueError):
        return default
    return default


def record_priority(rec: Any, default: int = PRIORITY_NORMAL) -> int:
    return headers_priority(getattr(rec, "headers", None), default)


class AdaptiveInflightBudget(InflightBudget):
    """AIMD concurrency limiter with the InflightBudget surface: the limit
    grows by ``step`` after ``good_window`` in-budget observations and is
    cut to ``beta`` of itself (at most once per ``decrease_cooldown_s``)
    when an observation exceeds ``target_s``, within
    [``min_limit``, ``max_limit``]."""

    __slots__ = ("min_limit", "max_limit", "target_s", "beta", "step",
                 "good_window", "_good", "_cooldown_until", "_inc_next",
                 "increase_interval_s", "decrease_cooldown_s", "_clock")

    def __init__(
        self,
        limit: int,
        min_limit: int | None = None,
        max_limit: int | None = None,
        target_s: float = 0.05,
        beta: float = 0.7,
        step: int | None = None,
        good_window: int = 8,
        decrease_cooldown_s: float | None = None,
        increase_interval_s: float = 0.0,
        registry=None,
        stage: str = "router",
        clock: Callable[[], float] = time.monotonic,
    ):
        super().__init__(limit, registry=registry, stage=stage)
        self.min_limit = int(min_limit if min_limit is not None
                             else max(1, limit // 8))
        self.max_limit = int(max_limit if max_limit is not None
                             else 4 * limit)
        self.target_s = float(target_s)
        self.beta = float(beta)
        self.step = int(step if step is not None else max(1, limit // 16))
        self.good_window = int(good_window)
        self.increase_interval_s = float(increase_interval_s)
        # one decrease per ~stage round trip: a slow burst's many samples
        # cost one multiplicative cut, not limit -> min
        self.decrease_cooldown_s = float(
            decrease_cooldown_s if decrease_cooldown_s is not None
            else max(2.0 * self.target_s, 0.1))
        self._clock = clock
        self._good = 0
        self._cooldown_until = 0.0
        self._inc_next = 0.0

    def rescale_ceiling(self, max_limit: int, min_limit: int | None = None) -> None:
        """Re-bound the AIMD range live (the fleet's per-member admission
        actuator): the current limit clamps into the new range and AIMD
        moves it from there, so a sick member still sheds below its share."""
        with self._mu:
            self.max_limit = max(1, int(max_limit))
            if min_limit is not None:
                self.min_limit = max(1, int(min_limit))
            self.min_limit = min(self.min_limit, self.max_limit)
            self.limit = max(self.min_limit, min(self.limit, self.max_limit))
            self._set_gauges_locked()

    def observe(self, latency_s: float) -> None:
        """Feed one stage-latency sample; adjusts the limit AIMD-style."""
        now = self._clock()
        with self._mu:
            if latency_s > self.target_s:
                self._good = 0
                if now >= self._cooldown_until:
                    self.limit = max(self.min_limit,
                                     int(self.limit * self.beta))
                    self._cooldown_until = now + self.decrease_cooldown_s
                    self._set_gauges_locked()
                return
            self._good += 1
            if self._good >= self.good_window and now >= self._inc_next:
                self._good = 0
                self._inc_next = now + self.increase_interval_s
                if self.limit < self.max_limit:
                    self.limit = min(self.max_limit, self.limit + self.step)
                    self._set_gauges_locked()


class OverloadShed(RuntimeError):
    """Work refused or dropped by the overload plane. Carries the
    retry-after hint the REST fronts surface on a 429."""

    def __init__(self, msg: str, retry_after_s: float = 0.1):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class DeadlinePolicy:
    """Drop-from-front when sojourn exceeds ``target_s`` times the class's
    scale (bulk 1x, normal 2x, critical 4x)."""

    __slots__ = ("target_s", "scale")

    def __init__(self, target_s: float,
                 scale: tuple[float, float, float] = (1.0, 2.0, 4.0)):
        self.target_s = float(target_s)
        self.scale = scale

    def cutoff_s(self, priority: int) -> float:
        return self.target_s * self.scale[
            min(len(self.scale) - 1, max(0, priority))]

    def should_drop(self, sojourn_s: float, priority: int) -> bool:
        return sojourn_s > self.cutoff_s(priority)


def _shed_counter(registry):
    return registry.counter(
        "ccfd_shed_total",
        "rows shed by the overload plane, by priority class and stage "
        "(deadline = sojourn expiry; budget = in-flight bound victim "
        "selection; rest = REST admission 429s)")


def _admission_counter(registry):
    return registry.counter(
        "ccfd_admission_total",
        "admission decisions in rows by stage, priority and decision")


def _bulk_ceiling_gauge(registry):
    return registry.gauge(
        "ccfd_bulk_ceiling",
        "operator-settable bulk admission ceiling by stage: the fraction of "
        "the stage's adaptive budget bulk-class work (replay re-drives, "
        "backtests) may occupy; 1.0 = bounded only by priority shedding")


class OverloadControl:
    """The router's overload plane; one instance per router pool (every
    ParallelRouter worker shares it): the adaptive budget, the bus deadline
    policy, priority-aware victim selection and the dispatch watchdog."""

    def __init__(
        self,
        registry,
        budget: AdaptiveInflightBudget,
        codel: DeadlinePolicy | None = None,
        dispatch_deadline_ms: float = 0.0,
        dispatch_threads: int = 4,
        clock: Callable[[], float] = time.time,
    ):
        self.registry = registry
        self.budget = budget
        self.codel = codel
        self.dispatch_deadline_s = max(0.0, float(dispatch_deadline_ms)) / 1e3
        # the watchdog's pool is sized to the worker count: its deadline
        # covers queue wait, so a smaller pool would turn busy queueing
        # into spurious timeouts
        self.dispatch_threads = max(1, int(dispatch_threads))
        self._clock = clock  # wall clock: record timestamps are time.time()
        self._c_shed = _shed_counter(registry)
        self._c_admit = _admission_counter(registry)
        self._c_inversions = registry.counter(
            "ccfd_priority_inversions_total",
            "batches where a higher-priority row was shed while a "
            "lower-priority one was admitted (must stay 0)")
        self._c_dispatch_timeout = registry.counter(
            "ccfd_dispatch_timeout_total",
            "router scorer dispatches killed by the watchdog deadline")
        self._dispatcher = None
        self._mu = threading.Lock()
        # the bulk ceiling (the replay plane's pacing actuator): the share
        # of the adaptive limit bulk rows may occupy in one poll's
        # admission, so live traffic keeps the rest of the stage
        self._bulk_ceiling = 1.0
        self._g_bulk_ceiling = _bulk_ceiling_gauge(registry)
        self._g_bulk_ceiling.set(1.0, labels={"stage": "bus"})
        # the incident flight recorder (observability/incident.py): when the
        # operator wires one, every watchdog kill snapshots into its ring
        self.recorder = None

    @staticmethod
    def from_config(cfg, registry, max_batch: int = 4096, workers: int = 1,
                    on_card: bool = False) -> "OverloadControl | None":
        """The ``router`` role's construction; None when CCFD_OVERLOAD=0.
        ``on_card`` resolves the watchdog's auto deadline (-1): SELDON_TIMEOUT
        when the router scores on the card, off on the CPU, as the
        reference resolves it by backend."""
        if not cfg.overload_enabled:
            return None
        workers = max(1, int(workers))
        # the initial limit is the static default it replaces: 2 x max_batch
        # a worker (one batch in flight + one fresh poll)
        initial = 2 * max_batch * workers
        min_l = cfg.overload_min_inflight or max_batch
        max_l = cfg.overload_max_inflight or 4 * initial
        budget = AdaptiveInflightBudget(
            initial, min_limit=min_l, max_limit=max_l,
            target_s=cfg.overload_target_ms / 1e3,
            registry=registry, stage="router")
        codel = (DeadlinePolicy(cfg.overload_codel_target_ms / 1e3)
                 if cfg.overload_codel_target_ms > 0 else None)
        return OverloadControl(registry, budget, codel=codel,
                               dispatch_deadline_ms=cfg.watchdog_deadline_ms(on_card),
                               dispatch_threads=max(4, workers))

    # -- bus-record admission ---------------------------------------------
    def admit(self, records: list, prepaid: bool = False) -> tuple[list, int]:
        """One poll's records -> (survivors in arrival order, rows shed). On
        return the budget holds a reservation for exactly the survivors.

        ``prepaid=True`` is the router's poll path (the loop reserved before
        consuming; the shed rows' share is released here). Otherwise this
        reserves, and when the limit cannot cover the batch picks victims
        lowest priority first, oldest first within a class. Deadline sheds
        come first, then budget sheds."""
        n = len(records)
        if n == 0:
            return records, 0
        pris = [record_priority(r) for r in records]
        shed_by: dict[tuple[int, str], int] = {}
        keep_idx: Any = range(n)
        shed_rows = 0

        codel = self.codel
        if codel is not None:
            now = self._clock()
            # min() over the timestamps, not the head: a multi-partition
            # poll concatenates partitions, not timestamps
            if now - min(r.timestamp for r in records) > codel.target_s:
                kept: list[int] = []
                for i in keep_idx:
                    if codel.should_drop(now - records[i].timestamp, pris[i]):
                        key = (pris[i], "deadline")
                        shed_by[key] = shed_by.get(key, 0) + 1
                        shed_rows += 1
                    else:
                        kept.append(i)
                keep_idx = kept

        keep_idx = list(keep_idx)
        frac = self._bulk_ceiling
        if frac < 1.0 and keep_idx:
            # bulk occupancy capped at frac x the CURRENT adaptive limit: a
            # stage that slows under live load tightens the replay share
            cap = max(0, int(frac * self.budget.limit))
            kept = []
            bulk_kept = 0
            for i in keep_idx:
                if pris[i] == PRIORITY_BULK:
                    if bulk_kept >= cap:
                        key = (pris[i], "bulk_ceiling")
                        shed_by[key] = shed_by.get(key, 0) + 1
                        shed_rows += 1
                        continue
                    bulk_kept += 1
                kept.append(i)
            keep_idx = kept
        if prepaid:
            if shed_rows:
                self.budget.release(shed_rows)
        else:
            granted = self.budget.reserve(len(keep_idx))
            if granted < len(keep_idx):
                excess = len(keep_idx) - granted
                order = sorted(keep_idx, key=lambda i: (pris[i], i))
                victims = set(order[:excess])
                max_shed_p = max(pris[i] for i in victims)
                survivors = [i for i in keep_idx if i not in victims]
                if survivors and min(pris[i] for i in survivors) < max_shed_p:
                    self._c_inversions.inc()
                for i in victims:
                    key = (pris[i], "budget")
                    shed_by[key] = shed_by.get(key, 0) + 1
                shed_rows += excess
                keep_idx = survivors

        for (p, stage), count in shed_by.items():
            self._c_shed.inc(count, labels={
                "priority": PRIORITY_NAMES[p], "stage": stage})
            self._c_admit.inc(count, labels={
                "stage": "bus", "priority": PRIORITY_NAMES[p],
                "decision": "shed"})
        if keep_idx:
            admit_by: dict[int, int] = {}
            for i in keep_idx:
                admit_by[pris[i]] = admit_by.get(pris[i], 0) + 1
            for p, count in admit_by.items():
                self._c_admit.inc(count, labels={
                    "stage": "bus", "priority": PRIORITY_NAMES[p],
                    "decision": "admit"})
        if len(keep_idx) == n:
            return records, 0
        return [records[i] for i in keep_idx], shed_rows

    # -- the bulk ceiling (the replay plane's pacing actuator) -------------
    def set_bulk_ceiling(self, frac: float) -> None:
        """Clamp bulk-class bus admission to ``frac`` of the adaptive limit
        (0..1); 1.0 restores shed-order-only semantics."""
        frac = min(1.0, max(0.0, float(frac)))
        self._bulk_ceiling = frac
        self._g_bulk_ceiling.set(frac, labels={"stage": "bus"})

    @property
    def bulk_ceiling(self) -> float:
        return self._bulk_ceiling

    # -- stage feedback ----------------------------------------------------
    def observe_stage(self, latency_s: float) -> None:
        """Feed a scorer-stage latency sample into the AIMD budget."""
        self.budget.observe(latency_s)

    # -- dispatch watchdog -------------------------------------------------
    def bounded_dispatch(self, fn: Callable[[], Any],
                         deadline_s: float | None = None) -> Any:
        """Run a scorer dispatch under the watchdog deadline. On expiry it
        raises ``ScorerTimeout`` (the router's ladder records a scorer-edge
        failure and scores the batch on a counted lower tier), the timeout
        is counted, the deadline is fed to AIMD as a latency sample, and a
        wired flight recorder snapshots the system."""
        if deadline_s is None:
            deadline_s = self.dispatch_deadline_s
        if deadline_s <= 0:
            return fn()
        from ccfd_tpu_torch.serving.dispatch import DeviceDispatcher, ScorerTimeout

        if self._dispatcher is None:
            with self._mu:
                if self._dispatcher is None:
                    self._dispatcher = DeviceDispatcher(
                        max_threads=self.dispatch_threads,
                        name="ccfd-router-dispatch")
        try:
            return self._dispatcher.call(fn, deadline_s)
        except ScorerTimeout:
            self._c_dispatch_timeout.inc()
            self.budget.observe(deadline_s + self.budget.target_s)
            if self.recorder is not None:
                try:
                    self.recorder.note_dispatch_timeout()
                except Exception:  # noqa: BLE001 - evidence capture must never mask the timeout
                    pass
            raise


class AdmissionGate:
    """REST admission: request-atomic reserve against an adaptive serving
    budget with priority-tiered utilization ceilings. A lone oversize
    request always admits (``try_reserve``'s idle rule)."""

    UTIL_CEILING = {PRIORITY_BULK: 0.5, PRIORITY_NORMAL: 0.9,
                    PRIORITY_CRITICAL: 1.0}

    def __init__(self, budget: AdaptiveInflightBudget, registry,
                 stage: str = "rest", retry_after_s: float = 0.25):
        self.budget = budget
        self.stage = stage
        self.retry_after_s = float(retry_after_s)
        self._c_admit = _admission_counter(registry)
        self._c_shed = _shed_counter(registry)
        # per-instance ceilings, so the replay plane moves the bulk share
        # live without touching the class default
        self._ceilings = dict(self.UTIL_CEILING)
        self._g_bulk_ceiling = _bulk_ceiling_gauge(registry)
        self._g_bulk_ceiling.set(self._ceilings[PRIORITY_BULK], labels={"stage": self.stage})

    @staticmethod
    def from_config(cfg, registry, max_rows: int) -> "AdmissionGate | None":
        if not cfg.overload_enabled:
            return None
        budget = AdaptiveInflightBudget(
            4 * max_rows, min_limit=max_rows, max_limit=16 * max_rows,
            target_s=cfg.overload_serve_target_ms / 1e3,
            registry=registry, stage="serving")
        return AdmissionGate(budget, registry)

    def set_bulk_ceiling(self, frac: float) -> None:
        """Move the bulk utilization ceiling live (0..1): the serving half of
        the replay pacing knob."""
        frac = min(1.0, max(0.0, float(frac)))
        self._ceilings[PRIORITY_BULK] = frac
        self._g_bulk_ceiling.set(frac, labels={"stage": self.stage})

    @property
    def bulk_ceiling(self) -> float:
        return self._ceilings[PRIORITY_BULK]

    def try_admit(self, rows: int, priority: int = PRIORITY_NORMAL) -> bool:
        ok = self.budget.try_reserve(rows, ceiling=self._ceilings.get(priority, 0.9))
        name = PRIORITY_NAMES.get(priority, "normal")
        self._c_admit.inc(rows, labels={
            "stage": self.stage, "priority": name,
            "decision": "admit" if ok else "reject"})
        if not ok:
            self._c_shed.inc(rows, labels={"priority": name, "stage": self.stage})
        return ok

    def release(self, rows: int) -> None:
        self.budget.release(rows)

    def observe(self, latency_s: float) -> None:
        self.budget.observe(latency_s)
