"""SLO-breach incident flight recorder: the automatic post-mortem.

The port's copy of ccfd_tpu/observability/incident.py. A burn-rate page
says WHEN an objective failed; the evidence a responder needs (which stage
ate the latency, what the breakers and the overload plane were doing, what
the card looked like) lives in gauges that have moved on by the time
anyone looks. This module keeps it:

- :class:`FlightRecorder`: a bounded ring of periodic system snapshots
  (watched-counter totals and deltas, a compact per-stage p99 summary,
  breaker, overload, lifecycle and SLO gauge states, recent kept traces,
  the device document and the process RSS). It runs as a supervised
  service under the operator; a dispatch-watchdog kill snapshots at once
  (debounced), so watchdog post-mortems have flight data too.
- **Incident bundles**: the SLO engine's breach edge calls
  :meth:`FlightRecorder.on_breach`, which dumps ONE schema-validated
  (:data:`INCIDENT_SCHEMA` = ``ccfd.incident.v3``) bundle per entry into
  the breaching state: the trigger, the SLO status, the StageProfile
  document, the ring as it stood, a live snapshot, the device telemetry's
  view, the last decision-record summaries with the audit plane on
  (``observability/audit.py``) and the capacity model's breach-time
  verdict with the observatory on (``observability/capacity.py``). The
  heal supervisor's quarantines and the storage quarantines
  (``runtime/durability.py::set_recorder``) dump bundles through
  :meth:`FlightRecorder.incident` too. Bundles persist crash-safely
  (tmp+rename) under ``out_dir`` when configured, are bounded
  (``max_bundles``, oldest pruned), and are served by the exporter at
  ``/incidents`` and ``/incidents/<id>``.

Where the port's bundle differs from the reference's: the watched build
counter is ``ccfd_build_events_total`` (kernel and native-library builds,
``observability/profile.py``) where the reference watches
``ccfd_xla_compile_events_total``; the embedded device document is the
port's (``observability/device.py``: ``torch.cuda`` memory per card where
the reference lists TPU memory kinds). The schema and ``validate_incident``
are the reference's.

Edge semantics match the breach counter's: one bundle per ENTRY into the
breaching state; a recovery followed by a re-breach dumps again.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Mapping

from ccfd_tpu_torch.observability.profile import (
    validate_profile,
    write_json_crash_safe,
)

INCIDENT_SCHEMA = "ccfd.incident.v3"

# counters whose totals every snapshot records (and diffs against the
# previous snapshot): the accounting a responder reads first
WATCHED_COUNTERS = (
    "transaction_incoming_total",
    "transaction_outgoing_total",
    "router_shed_total",
    "router_score_errors_total",
    "router_degraded_total",
    "ccfd_shed_total",
    "ccfd_admission_total",
    "ccfd_dispatch_timeout_total",
    "ccfd_h2d_bytes_total",
    "ccfd_build_events_total",
    "ccfd_slo_breach_total",
    "seldon_api_executor_server_requests_total",
)

# gauge families captured as {labelset: value} state tables
WATCHED_GAUGES = (
    "ccfd_breaker_state",
    "ccfd_inflight_limit",
    "ccfd_inflight_used",
    "ccfd_lifecycle_stage",
    "ccfd_lifecycle_champion_version",
    "ccfd_slo_breaching",
    "ccfd_slo_burn_rate",
    "ccfd_slo_error_budget_remaining",
)


def _labelstr(key) -> str:
    return "|".join(f"{k}={v}" for k, v in key) or "all"


class FlightRecorder:
    """Bounded snapshot ring + incident bundle dumper; see the module
    docstring. Thread-safe: the supervised tick, the SLO engine's breach
    callback and the dispatch watchdog all feed it concurrently."""

    def __init__(
        self,
        registries: Mapping[str, Any],
        registry=None,
        profiler=None,
        telemetry=None,
        sink=None,
        ring: int = 64,
        out_dir: str | None = None,
        max_bundles: int = 16,
        timeout_debounce_s: float = 2.0,
        clock: Callable[[], float] = time.time,
        audit=None,
        capacity=None,
    ):
        self._registries = registries
        self.profiler = profiler
        self.telemetry = telemetry
        self.sink = sink
        # decision-audit plane (observability/audit.py): when wired,
        # every bundle embeds the last N decision-record summaries — the
        # transactions in flight across the breach window
        self.audit = audit
        # capacity observatory (observability/capacity.py): when wired,
        # every bundle embeds the queueing model's breach-time verdict —
        # bottleneck stage, headroom, predicted-vs-observed p99 (v3)
        self.capacity = capacity
        self.decisions_embedded = 16
        self._last_incident_id: str | None = None
        self.out_dir = out_dir or None
        self.max_bundles = max(1, int(max_bundles))
        self._clock = clock
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self.ring: collections.deque = collections.deque(
            maxlen=max(1, int(ring)))
        self._bundles: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._seq = 0
        self._prev_totals: dict[str, float] = {}
        # dispatch-timeout debounce: a wedged scorer trips EVERY worker's
        # watchdog at the deadline rate — snapshotting each trip would pay
        # a full evidence capture on the already-degraded path AND flush
        # the pre-incident history out of the bounded ring within seconds
        self.timeout_debounce_s = float(timeout_debounce_s)
        self._last_timeout_snap = -float("inf")
        self._c_snapshots = self._c_incidents = self._g_ring = None
        if registry is not None:
            self._c_snapshots = registry.counter(
                "ccfd_incident_snapshots_total",
                "flight-recorder ring snapshots by reason (periodic tick, "
                "dispatch_timeout trip, incident dump)",
            )
            self._c_incidents = registry.counter(
                "ccfd_incidents_total",
                "incident bundles dumped, by trigger type (edge-triggered "
                "with the SLO breach counter: one per entry into the "
                "breaching state)",
            )
            self._g_ring = registry.gauge(
                "ccfd_incident_ring_size",
                "snapshots currently held in the flight-recorder ring",
            )
        if self.out_dir:
            os.makedirs(self.out_dir, exist_ok=True)

    # -- evidence collection ------------------------------------------------
    def _totals(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for reg in self._registries.values():
            for name in WATCHED_COUNTERS:
                m = reg.get(name)
                if m is not None and hasattr(m, "total"):
                    out[name] = out.get(name, 0.0) + float(m.total())
        return out

    def _gauges(self) -> dict[str, dict[str, float]]:
        out: dict[str, dict[str, float]] = {}
        for reg in self._registries.values():
            for name in WATCHED_GAUGES:
                m = reg.get(name)
                if m is None or not hasattr(m, "items"):
                    continue
                table = out.setdefault(name, {})
                for key, val in m.items():
                    table[_labelstr(key)] = val
        return out

    def _stage_summary(self) -> dict[str, Any]:
        """Compact per-stage p99s for ring snapshots (the full digests
        ride only in the bundle's stage_profile)."""
        if self.profiler is None:
            return {}
        out: dict[str, Any] = {}
        try:
            doc = self.profiler.snapshot()
            for stage, entry in doc.get("stages", {}).items():
                comp = {
                    c: entry[c]["p99_ms"]
                    for c in ("queue", "service", "dispatch")
                    if isinstance(entry.get(c), dict)
                    and "p99_ms" in entry[c]
                }
                if comp:
                    comp["rows"] = entry.get("rows", 0)
                    out[stage] = comp
        except Exception:  # noqa: BLE001 - evidence, not a crash source
            pass
        return out

    def _traces_summary(self, limit: int = 8) -> list[dict[str, Any]]:
        if self.sink is None:
            return []
        try:
            return self.sink.traces()[:limit]
        except Exception:  # noqa: BLE001 - an empty traces section records the gap
            return []

    def _memory_summary(self) -> dict[str, Any]:
        from ccfd_tpu_torch.observability.memory import rss_bytes

        return {"rss_bytes": rss_bytes()}

    def snapshot(self, reason: str = "periodic") -> dict[str, Any]:
        """Collect one system snapshot and append it to the ring."""
        with self._mu:
            # totals are read INSIDE the lock: a periodic tick racing an
            # incident/timeout snapshot on another thread must not diff
            # against the other's baseline (negative deltas in the ring,
            # then double-counted increments on the next tick)
            totals = self._totals()
            deltas = {
                name: round(val - self._prev_totals.get(name, 0.0), 6)
                for name, val in totals.items()
            }
            self._prev_totals = totals
        snap: dict[str, Any] = {
            "ts_unix": self._clock(),
            "reason": reason,
            "counters": totals,
            "counter_deltas": deltas,
            "gauges": self._gauges(),
            "stages_p99_ms": self._stage_summary(),
            "traces": self._traces_summary(),
            "memory": self._memory_summary(),
        }
        if self.telemetry is not None:
            try:
                snap["device"] = self.telemetry.snapshot()
            except Exception:  # noqa: BLE001 - the empty device section ships in the bundle
                snap["device"] = {}
        with self._mu:
            self.ring.append(snap)
            if self._g_ring is not None:
                self._g_ring.set(float(len(self.ring)))
        if self._c_snapshots is not None:
            self._c_snapshots.inc(labels={"reason": reason})
        return snap

    def note_dispatch_timeout(self) -> None:
        """Dispatch-watchdog hook (runtime/overload.py): a killed dispatch
        snapshots the system state into the ring immediately, so watchdog
        kills are post-mortem-able without waiting for an SLO breach.
        Debounced (``timeout_debounce_s``): a timeout STORM takes one
        snapshot per window — the trips themselves stay fully counted in
        ``ccfd_dispatch_timeout_total``, and the snapshot's counters
        record the running total."""
        now = self._clock()
        with self._mu:
            if now - self._last_timeout_snap < self.timeout_debounce_s:
                return
            self._last_timeout_snap = now
        self.snapshot(reason="dispatch_timeout")

    # -- incident bundles ---------------------------------------------------
    def on_breach(self, slo: str, status: Mapping[str, Any]) -> dict:
        """SLOEngine breach-edge callback -> one bundle per breach entry."""
        return self.incident({"type": "slo_breach", "slo": slo},
                             slo_status=dict(status))

    def incident(self, trigger: Mapping[str, Any],
                 slo_status: Mapping[str, Any] | None = None) -> dict:
        live = self.snapshot(reason="incident")
        with self._mu:
            self._seq += 1
            seq = self._seq
            ring = list(self.ring)
        slug = str(trigger.get("slo") or trigger.get("type", "incident"))
        inc_id = f"inc-{seq:04d}-{slug}"
        doc: dict[str, Any] = {
            "schema": INCIDENT_SCHEMA,
            "id": inc_id,
            "generated_unix": self._clock(),
            "trigger": dict(trigger),
            "slo_status": dict(slo_status or {}),
            "snapshot": live,
            "ring": ring,
        }
        if self.profiler is not None:
            try:
                doc["stage_profile"] = self.profiler.snapshot()
            except Exception:  # noqa: BLE001 - the null stage_profile ships in the bundle
                doc["stage_profile"] = None
        if self.audit is not None:
            # which transactions were IN FLIGHT: the newest decision
            # records as they stood at the breach edge (schema v2)
            try:
                doc["decisions"] = self.audit.recent_summaries(
                    self.decisions_embedded)
            except Exception:  # noqa: BLE001 - evidence, never a crash
                doc["decisions"] = []
        if self.capacity is not None:
            # what the queueing model believed at the breach edge:
            # bottleneck stage + layer, headroom, predicted vs observed
            # p99 (schema v3)
            try:
                doc["capacity"] = self.capacity.breach_summary()
            except Exception:  # noqa: BLE001 - evidence, never a crash
                doc["capacity"] = None
        errs = validate_incident(doc)
        if errs:  # never ship an invalid bundle silently
            doc["validation_errors"] = errs[:10]
        path = None
        if self.out_dir:
            path = os.path.join(self.out_dir, f"{inc_id}.json")
            try:
                write_json_crash_safe(path, doc)
            except OSError:
                path = None
        if path:
            doc["path"] = path
        with self._mu:
            self._bundles[inc_id] = doc
            self._last_incident_id = inc_id
            while len(self._bundles) > self.max_bundles:
                old_id, old = self._bundles.popitem(last=False)
                old_path = old.get("path")
                if old_path:
                    for p in (old_path, old_path + ".sha256"):
                        try:
                            os.remove(p)
                        except OSError:
                            pass
        if self._c_incidents is not None:
            self._c_incidents.inc(
                labels={"trigger": str(trigger.get("type", "unknown"))})
        return doc

    def incidents(self) -> list[dict[str, Any]]:
        """Bundle summaries, newest first — the /incidents body."""
        with self._mu:
            docs = list(self._bundles.values())
        return [
            {
                "id": d["id"],
                "generated_unix": d["generated_unix"],
                "trigger": d["trigger"],
                "ring_depth": len(d.get("ring", [])),
                "path": d.get("path"),
            }
            for d in reversed(docs)
        ]

    def incident_doc(self, inc_id: str) -> dict[str, Any] | None:
        with self._mu:
            return self._bundles.get(inc_id)

    def last_incident_id(self) -> str | None:
        """Newest bundle's id — the decision-audit plane stamps it onto
        routed transactions while the SLO engine reports the breaching
        state still open (operator wiring)."""
        with self._mu:
            return self._last_incident_id

    # -- supervised-service surface ----------------------------------------
    def reset(self) -> None:
        self._stop.clear()

    def stop(self) -> None:
        self._stop.set()

    def run(self, interval_s: float = 5.0) -> None:
        while not self._stop.wait(interval_s):
            self.snapshot()


def _snapshot_errors(where: str, snap: Any) -> list[str]:
    if not isinstance(snap, Mapping):
        return [f"{where}: not a mapping"]
    errs = []
    if not isinstance(snap.get("ts_unix"), (int, float)):
        errs.append(f"{where}.ts_unix: missing")
    if not isinstance(snap.get("reason"), str):
        errs.append(f"{where}.reason: missing")
    for k in ("counters", "counter_deltas", "gauges"):
        if not isinstance(snap.get(k), Mapping):
            errs.append(f"{where}.{k}: missing")
    return errs


def validate_incident(doc: Any) -> list[str]:
    """Schema check for a ``ccfd.incident.v3`` bundle -> list of problems
    ([] = valid). Hand-rolled like ``validate_profile``, and reusing it
    for the embedded StageProfile: the smoke and the exporter contract
    both gate on NAMED failures. v2 added the optional ``decisions``
    embed (decision-record summaries from the breach window); v3 adds
    the optional ``capacity`` embed (the queueing model's breach-time
    verdict: bottleneck stage, headroom, predicted-vs-observed p99)."""
    errs: list[str] = []
    if not isinstance(doc, Mapping):
        return ["document: not a mapping"]
    if doc.get("schema") != INCIDENT_SCHEMA:
        errs.append(f"schema: expected {INCIDENT_SCHEMA!r}, "
                    f"got {doc.get('schema')!r}")
    if not isinstance(doc.get("id"), str) or not doc.get("id"):
        errs.append("id: missing")
    if not isinstance(doc.get("generated_unix"), (int, float)):
        errs.append("generated_unix: missing")
    trigger = doc.get("trigger")
    if not isinstance(trigger, Mapping) or not isinstance(
            trigger.get("type"), str):
        errs.append("trigger: missing mapping with a 'type'")
    ring = doc.get("ring")
    if not isinstance(ring, list):
        errs.append("ring: missing list")
    else:
        for i, snap in enumerate(ring):
            errs.extend(_snapshot_errors(f"ring[{i}]", snap))
    errs.extend(_snapshot_errors("snapshot", doc.get("snapshot")))
    if not isinstance(doc.get("slo_status"), Mapping):
        errs.append("slo_status: missing mapping")
    sp = doc.get("stage_profile")
    if sp is not None:
        errs.extend(f"stage_profile.{e}" for e in validate_profile(sp))
    decisions = doc.get("decisions")
    if decisions is not None:
        if not isinstance(decisions, list):
            errs.append("decisions: must be a list when present")
        else:
            for i, d in enumerate(decisions):
                if not isinstance(d, Mapping) or "seq" not in d:
                    errs.append(f"decisions[{i}]: not a decision-record "
                                "summary (mapping with 'seq')")
                    break
    capacity = doc.get("capacity")
    if capacity is not None:
        if not isinstance(capacity, Mapping):
            errs.append("capacity: must be a mapping when present")
        else:
            for k in ("bottleneck", "e2e", "regressions"):
                if k not in capacity:
                    errs.append(f"capacity.{k}: missing")
    return errs
