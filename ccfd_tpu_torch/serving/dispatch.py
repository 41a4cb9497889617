"""Deadline-bounded dispatch: the router's dispatch watchdog.

The port's copy of ``DeviceDispatcher`` and ``ScorerTimeout`` from
ccfd_tpu/serving/dispatch.py. Work runs on a small pool of sacrificial
threads; the caller waits at most a deadline and gets :class:`ScorerTimeout`
on expiry. A wedged worker cannot be cancelled: it is leaked (daemonized,
its ticket abandoned), and the pool stops growing at ``max_threads``.

The port uses it only through ``OverloadControl.bounded_dispatch``, where a
timeout falls into the router's counted degradation ladder. The Scorer's
own wedge fallback (``WedgeMonitor``, CCFD_DISPATCH_DEADLINE_MS) is not
ported: it would let a request skip the kernel inside the Scorer.
"""

from __future__ import annotations

import queue
import threading
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
