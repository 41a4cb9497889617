"""Service supervision: the platform layer's failure-detection semantics.

The port's copy of ccfd_tpu/runtime/supervisor.py (the backoff schedule
is the reference's).

The reference delegates failure handling to Kubernetes: every pod runs with
``restartPolicy: Always`` (reference deploy/router.yaml:75), crash loops get
exponential backoff, and the run-book gates each step on readiness
(`oc get pods`, reference README.md:81-85,187-201). In-process, this module
is that layer: each pipeline service (router, notification, retrainer,
servers) runs under a ``Supervisor`` that detects thread death, restarts
per policy with capped exponential backoff (CrashLoopBackOff semantics),
and exposes liveness/readiness the way kubelet probes do.

This goes beyond the reference's *application* code (which has none of
this in-tree) but matches its *platform* capability, which is part of the
contract — a user deploying without k8s still gets restart-on-crash.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Callable


class RestartPolicy(enum.Enum):
    ALWAYS = "Always"        # reference router.yaml:75
    ON_FAILURE = "OnFailure"
    NEVER = "Never"


class ServiceState(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    CRASH_LOOP = "CrashLoopBackOff"
    FAILED = "Failed"
    STOPPED = "Stopped"


@dataclass
class ManagedService:
    """One supervised service: a blocking ``run`` + cooperative ``stop``."""

    name: str
    run: Callable[[], None]
    stop: Callable[[], None] = lambda: None
    ready: Callable[[], bool] = lambda: True
    policy: RestartPolicy = RestartPolicy.ALWAYS
    max_restarts: int | None = None  # None = unbounded (k8s semantics)
    # called by the supervisor BEFORE each (re)spawn, on the supervisor's
    # thread under its lock — the place to clear a stop flag so a restart
    # doesn't exit instantly. Services must NOT clear their own stop flag
    # inside run(): that races a concurrent stop() and can erase it.
    reset: Callable[[], None] = lambda: None

    # runtime state (managed by Supervisor)
    state: ServiceState = ServiceState.PENDING
    restarts: int = 0
    last_error: str = ""
    _thread: threading.Thread | None = field(default=None, repr=False)
    _next_start: float = 0.0
    _streak: int = 0  # consecutive crashes since last stable run (backoff input)
    _started_at: float = 0.0
    _chaos: str = ""  # non-empty: a clean exit counts as an injected FAILURE


class Supervisor:
    """Restart-on-crash with capped exponential backoff + readiness.

    ``backoff_initial_s`` doubles per consecutive crash up to
    ``backoff_cap_s`` (kubelet: 10s → 5min; defaults here are scaled down
    so in-process pipelines recover fast). A service that stays up longer
    than ``stable_after_s`` resets its backoff, like kubelet's 10-minute
    reset.
    """

    def __init__(
        self,
        backoff_initial_s: float = 0.1,
        backoff_cap_s: float = 5.0,
        stable_after_s: float = 10.0,
        poll_interval_s: float = 0.02,
    ):
        self._services: dict[str, ManagedService] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None
        self.backoff_initial_s = backoff_initial_s
        self.backoff_cap_s = backoff_cap_s
        self.stable_after_s = stable_after_s
        self.poll_interval_s = poll_interval_s

    # --- registration ----------------------------------------------------
    def add(self, svc: ManagedService) -> ManagedService:
        with self._lock:
            if svc.name in self._services:
                raise ValueError(f"duplicate service {svc.name!r}")
            self._services[svc.name] = svc
        return svc

    def add_thread_service(
        self,
        name: str,
        run: Callable[[], None],
        stop: Callable[[], None] = lambda: None,
        ready: Callable[[], bool] = lambda: True,
        policy: RestartPolicy = RestartPolicy.ALWAYS,
        max_restarts: int | None = None,
        reset: Callable[[], None] = lambda: None,
    ) -> ManagedService:
        return self.add(
            ManagedService(
                name=name, run=run, stop=stop, ready=ready,
                policy=policy, max_restarts=max_restarts, reset=reset,
            )
        )

    # --- lifecycle -------------------------------------------------------
    def _spawn(self, svc: ManagedService) -> None:
        def runner() -> None:
            try:
                svc.run()
            except Exception as e:  # noqa: BLE001 — supervision boundary
                with self._lock:
                    svc.last_error = f"{type(e).__name__}: {e}"
                    svc.state = ServiceState.FAILED
                    svc._chaos = ""
            else:
                with self._lock:
                    if svc._chaos:
                        # injected failure: the service was stopped BY the
                        # chaos surface, so its clean return is a simulated
                        # crash — FAILED engages ON_FAILURE restart policies
                        svc.last_error = f"injected: {svc._chaos}"
                        svc.state = ServiceState.FAILED
                        svc._chaos = ""
                    elif svc.state == ServiceState.RUNNING:
                        svc.state = ServiceState.SUCCEEDED

        try:
            svc.reset()  # re-arm stop flags BEFORE the thread exists: a
            # stop()/inject_failure arriving after this point is honored
            # because nothing clears the flag once the thread runs
        except Exception as e:  # noqa: BLE001 - a broken reset is a crash
            svc.last_error = f"reset failed: {type(e).__name__}: {e}"
            svc.state = ServiceState.FAILED
            return
        t = threading.Thread(target=runner, daemon=True, name=f"svc-{svc.name}")
        svc._thread = t
        svc.state = ServiceState.RUNNING
        svc._started_at = time.monotonic()
        t.start()

    def start_service(self, name: str) -> None:
        """Spawn one PENDING service now (for services added after start())."""
        with self._lock:
            svc = self._services[name]
            if svc.state == ServiceState.PENDING:
                self._spawn(svc)

    def start(self) -> "Supervisor":
        with self._lock:
            for svc in self._services.values():
                if svc.state == ServiceState.PENDING:
                    self._spawn(svc)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="ccfd-supervisor"
        )
        self._monitor.start()
        return self

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                services = list(self._services.values())
            for svc in services:
                with self._lock:
                    state = svc.state
                    if state in (ServiceState.FAILED, ServiceState.SUCCEEDED):
                        restart = svc.policy == RestartPolicy.ALWAYS or (
                            svc.policy == RestartPolicy.ON_FAILURE
                            and state == ServiceState.FAILED
                        )
                        if not restart or (
                            svc.max_restarts is not None
                            and svc.restarts >= svc.max_restarts
                        ):
                            continue
                        # kubelet-style: a run that stayed up resets backoff
                        if now - svc._started_at >= self.stable_after_s:
                            svc._streak = 0
                        backoff = min(
                            self.backoff_initial_s * (2 ** svc._streak),
                            self.backoff_cap_s,
                        )
                        svc._next_start = now + backoff
                        svc.state = ServiceState.CRASH_LOOP
                    elif state == ServiceState.CRASH_LOOP and now >= svc._next_start:
                        svc.restarts += 1
                        svc._streak += 1
                        self._spawn(svc)
            time.sleep(self.poll_interval_s)

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._monitor:
            self._monitor.join(timeout=timeout_s)
        with self._lock:
            services = list(self._services.values())
        for svc in services:
            try:
                svc.stop()
            except Exception:  # noqa: BLE001
                pass
            if svc._thread is not None:
                svc._thread.join(timeout=timeout_s)
            with self._lock:
                svc.state = ServiceState.STOPPED

    # --- failure injection ------------------------------------------------
    def inject_failure(self, name: str, reason: str = "chaos") -> bool:
        """Force-crash a RUNNING service: its loop is stopped and the exit
        recorded as FAILED (so ON_FAILURE policies restart too), then the
        normal crash-loop/backoff machinery takes over. This is the fault-
        injection surface the reference platform lacks entirely (SURVEY.md
        §5 'Failure detection: k8s-level only') — recovery behavior becomes
        testable instead of theoretical. Returns False if the service isn't
        currently RUNNING."""
        with self._lock:
            svc = self._services.get(name)
            if svc is None or svc.state != ServiceState.RUNNING:
                return False
            svc._chaos = reason
        try:
            svc.stop()
        except Exception:  # noqa: BLE001 - a broken stop() is itself a crash
            pass
        return True

    # --- probes ----------------------------------------------------------
    def status(self) -> dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "state": svc.state.value,
                    "restarts": svc.restarts,
                    "ready": self._ready_of(svc),
                    "last_error": svc.last_error,
                    "policy": svc.policy.value,
                }
                for name, svc in self._services.items()
            }

    def _ready_of(self, svc: ManagedService) -> bool:
        # a completed one-shot (NEVER/ON_FAILURE job that exited cleanly) is
        # "done", not "unready" — k8s Jobs don't degrade pod readiness either
        if svc.state == ServiceState.SUCCEEDED:
            return True
        if svc.state != ServiceState.RUNNING:
            return False
        try:
            return bool(svc.ready())
        except Exception:  # noqa: BLE001
            return False

    def alive(self) -> bool:
        """Liveness: the monitor loop is running (crashes get restarted)."""
        return (
            not self._stop.is_set()
            and self._monitor is not None
            and self._monitor.is_alive()
        )

    def ready(self) -> bool:
        """All services Running+ready — the run-book's `oc get pods` gate."""
        with self._lock:
            services = list(self._services.values())
        return all(self._ready_of(s) for s in services)

    def wait_ready(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ready():
                return True
            time.sleep(self.poll_interval_s)
        return self.ready()
