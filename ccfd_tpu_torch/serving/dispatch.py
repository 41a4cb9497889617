"""Deadline-bounded dispatch: the router's dispatch watchdog and the
Scorer's wedge deadline.

The port's copy of ``DeviceDispatcher``, ``ScorerTimeout`` and
``WedgeMonitor`` from ccfd_tpu/serving/dispatch.py. Work runs on a small
pool of sacrificial threads; the caller waits at most a deadline and gets
:class:`ScorerTimeout` on expiry. A wedged worker cannot be cancelled: it
is leaked (daemonized, its ticket abandoned), and the pool stops growing at
``max_threads``.

Two users: ``OverloadControl.bounded_dispatch``, where a timeout falls into
the router's counted degradation ladder, and the Scorer's dispatch
deadline (CCFD_DISPATCH_DEADLINE_MS, off unless set), where a timeout marks
the device wedged and ``score`` raises the timeout to its caller: 503 from
the REST server, a counted degraded tier in the router's ladder.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable


class ScorerTimeout(Exception):
    """A dispatch exceeded its deadline."""


class _Ticket:
    __slots__ = ("done", "result", "error", "abandoned")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None
        self.abandoned = False  # set by the waiter on timeout


class DeviceDispatcher:
    """Run callables on worker threads with a per-call deadline covering
    queue wait and execution. Workers spawn lazily up to ``max_threads``; a
    worker that picks up a ticket whose waiter gave up skips it."""

    def __init__(self, max_threads: int = 4, name: str = "ccfd-dispatch"):
        self.max_threads = int(max_threads)
        self._name = name
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._n_threads = 0
        self._n_idle = 0
        self._seq = 0

    def _spawn_locked(self) -> None:
        self._seq += 1
        t = threading.Thread(target=self._worker, name=f"{self._name}-{self._seq}",
                             daemon=True)
        self._n_threads += 1
        self._n_idle += 1
        t.start()

    def _worker(self) -> None:
        while True:
            ticket, fn = self._q.get()
            with self._lock:
                self._n_idle -= 1
            if ticket.abandoned:
                with self._lock:
                    self._n_idle += 1
                continue
            try:
                ticket.result = fn()
            # ccfd-lint: disable=counted-drops -- not a drop: ticket.error re-raises at the waiter in call()
            except BaseException as e:  # noqa: BLE001 - re-raised at the waiter
                ticket.error = e
            ticket.done.set()
            with self._lock:
                self._n_idle += 1

    def call(self, fn: Callable[[], Any], deadline_s: float) -> Any:
        """Run ``fn`` within ``deadline_s``; raises :class:`ScorerTimeout`."""
        with self._lock:
            if self._n_idle == 0 and self._n_threads < self.max_threads:
                self._spawn_locked()
        ticket = _Ticket()
        self._q.put((ticket, fn))
        if ticket.done.wait(timeout=deadline_s):
            if ticket.error is not None:
                raise ticket.error
            return ticket.result
        ticket.abandoned = True
        raise ScorerTimeout(f"device dispatch exceeded {deadline_s:.3f}s")


class WedgeMonitor:
    """Whether the device is believed wedged, with a prober that clears the
    mark once a cheap device round trip (``probe_fn``) completes within the
    deadline again, so serving returns to the card without manual action.
    The probe runs through the same :class:`DeviceDispatcher`, so a still
    wedged device costs at most one sacrificial thread a probe interval."""

    def __init__(
        self,
        dispatcher: DeviceDispatcher,
        probe_fn: Callable[[], Any],
        deadline_s: float,
        probe_interval_s: float = 10.0,
    ):
        self._dispatcher = dispatcher
        self._probe_fn = probe_fn
        self._deadline_s = float(deadline_s)
        self._probe_interval_s = float(probe_interval_s)
        self._lock = threading.Lock()
        self._wedged_since: float | None = None
        self._prober: threading.Thread | None = None

    @property
    def wedged(self) -> bool:
        with self._lock:
            return self._wedged_since is not None

    @property
    def wedged_for_s(self) -> float:
        with self._lock:
            if self._wedged_since is None:
                return 0.0
            return time.monotonic() - self._wedged_since

    def mark_wedged(self) -> None:
        with self._lock:
            first = self._wedged_since is None
            if first:
                self._wedged_since = time.monotonic()
            # _prober is None exactly when no prober loop will make another
            # pass: the loop only exits under this lock after nulling it
            start_prober = first and self._prober is None
            if start_prober:
                self._prober = threading.Thread(
                    target=self._probe_loop, name="ccfd-wedge-probe", daemon=True)
                self._prober.start()

    def _clear(self) -> None:
        with self._lock:
            self._wedged_since = None

    def _probe_loop(self) -> None:
        while True:
            with self._lock:
                if self._wedged_since is None:
                    # exit is atomic with nulling the handle: a concurrent
                    # mark_wedged either sees _prober set or spawns a new one
                    self._prober = None
                    return
            try:
                self._dispatcher.call(self._probe_fn, self._deadline_s)
            # ccfd-lint: disable=counted-drops -- a failing probe is the wedged steady state, already exported via the wedge gauge; per-interval logs would spam
            except Exception:  # noqa: BLE001 - a timeout or a failing probe is not recovery
                time.sleep(self._probe_interval_s)
                continue
            self._clear()
