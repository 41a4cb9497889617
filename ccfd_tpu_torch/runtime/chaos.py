"""Seeded fault injection over a Supervisor: chaos testing for the pipeline.

The port's copy of ccfd_tpu/runtime/chaos.py. The reference system's
failure story is entirely platform-delegated (Kubernetes ``restartPolicy:
Always`` and rolling strategies). This module makes the recovery machinery
*testable*: a ``ChaosMonkey`` kills a randomly chosen supervised service on
a seeded schedule (``Supervisor.inject_failure``), and the assertions that
matter — the supervisor restarts it, consumers resume from committed
offsets, the pipeline keeps scoring — run in tests and on the card instead
of being discovered in production.

Beyond whole-service kills, the monkey drives **fault storms**: handed an
edge ``FaultPlan``, a ``DeviceFaultPlan`` and/or a ``StorageFaultPlan``
(runtime/faults.py) it toggles them active together for
``fault_duration_s`` every ``fault_interval_s``: a window where the named
edges run degraded, the card's dispatches hang or its copies fail, the disk
tears writes. That exercises the breakers, the router's degradation ladder,
the device heal supervisor (runtime/heal.py) and the durable-state plane
rather than the crash-restart machinery.

Determinism: victim choice derives from ``seed`` (``random.Random``, the
reference's draws), so a chaos run is replayable. Every injection lands in
``history`` and, with a registry, in ``chaos_injections_total{service}``;
fault windows land in ``fault_windows`` and ``chaos_fault_windows_total``.
"""

from __future__ import annotations

import random
import threading
import time

from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.runtime.supervisor import ServiceState, Supervisor


class ChaosMonkey:
    def __init__(
        self,
        supervisor: Supervisor,
        interval_s: float = 5.0,
        seed: int = 0,
        targets: list[str] | None = None,
        registry: Registry | None = None,
        fault_plan=None,
        device_fault_plan=None,
        storage_fault_plan=None,
        fault_interval_s: float | None = None,
        fault_duration_s: float = 2.0,
    ):
        self._sup = supervisor
        self.interval_s = interval_s
        self._rng = random.Random(seed)
        self._targets = list(targets) if targets is not None else None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.history: list[tuple[float, str]] = []  # (monotonic time, service)
        # fault storms: edge plan (runtime/faults.FaultPlan), device
        # plan (runtime/faults.DeviceFaultPlan) and/or storage plan
        # (runtime/faults.StorageFaultPlan) — all share one activation
        # surface. Storm-driven plans should be built active=False; the
        # monkey owns their duty cycle and toggles all in lockstep
        self._fault_plan = fault_plan
        self._device_fault_plan = device_fault_plan
        self._storage_fault_plan = storage_fault_plan
        self.fault_interval_s = fault_interval_s
        self.fault_duration_s = fault_duration_s
        self._fault_thread: threading.Thread | None = None
        self.fault_windows: list[tuple[float, float]] = []  # (start, end)
        self._c_injected = None
        self._c_fault_windows = None
        if registry is not None:
            self._c_injected = registry.counter(
                "chaos_injections_total", "injected service failures"
            )
            if (fault_plan is not None or device_fault_plan is not None
                    or storage_fault_plan is not None):
                self._c_fault_windows = registry.counter(
                    "chaos_fault_windows_total",
                    "fault-storm windows driven by the monkey",
                )

    def _eligible(self) -> list[str]:
        status = self._sup.status()
        names = self._targets if self._targets is not None else sorted(status)
        return [
            n
            for n in names
            if status.get(n, {}).get("state") == ServiceState.RUNNING.value
            # a Never-policy service (one-shot jobs like the producer)
            # can't be restarted: injecting there doesn't test recovery,
            # it just marks a healthy run FAILED and wedges readiness
            and status.get(n, {}).get("policy") != "Never"
        ]

    def kill_one(self) -> str | None:
        """Inject one failure now; returns the victim's name (or None if
        nothing was RUNNING to kill)."""
        victims = self._eligible()
        if not victims:
            return None
        name = self._rng.choice(victims)
        if not self._sup.inject_failure(name, reason="chaos-monkey"):
            return None
        self.history.append((time.monotonic(), name))
        if self._c_injected is not None:
            self._c_injected.inc(labels={"service": name})
        return name

    def fault_storm(self, duration_s: float | None = None) -> None:
        """Run one fault window now: activate the plan(s), hold for the
        duration (interruptible by stop), deactivate."""
        plans = [p for p in (self._fault_plan, self._device_fault_plan,
                              self._storage_fault_plan)
                 if p is not None]
        if not plans:
            return
        dur = self.fault_duration_s if duration_s is None else duration_s
        t0 = time.monotonic()
        for p in plans:
            p.activate()
        if self._c_fault_windows is not None:
            self._c_fault_windows.inc()
        try:
            self._stop.wait(dur)
        finally:
            for p in plans:
                p.deactivate()
            self.fault_windows.append((t0, time.monotonic()))

    def run(self) -> None:
        while not self._stop.is_set():
            if self._stop.wait(self.interval_s):
                return
            self.kill_one()

    def _run_faults(self) -> None:
        while not self._stop.is_set():
            if self._stop.wait(self.fault_interval_s):
                return
            self.fault_storm()

    def start(self) -> "ChaosMonkey":
        # re-arm BEFORE the thread exists: clearing inside run() would
        # race a stop() issued right after start() and erase it — the
        # same rule ManagedService.reset codifies for supervised services
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, daemon=True, name="ccfd-chaos"
        )
        self._thread.start()
        if ((self._fault_plan is not None
                or self._device_fault_plan is not None
                or self._storage_fault_plan is not None)
                and self.fault_interval_s):
            self._fault_thread = threading.Thread(
                target=self._run_faults, daemon=True, name="ccfd-chaos-net"
            )
            self._fault_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._fault_thread is not None:
            self._fault_thread.join(timeout=5.0)
            # a storm interrupted mid-window must not leave edges (or the
            # device seams) degraded
            for p in (self._fault_plan, self._device_fault_plan,
                      self._storage_fault_plan):
                if p is not None:
                    p.deactivate()
