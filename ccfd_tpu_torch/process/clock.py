"""Clock abstraction for the process engine's timers.

The port's copy of ccfd_tpu/process/clock.py. The fraud process races a
no-customer-reply *timer* against the customer-response *signal*; a
virtual clock makes that race deterministic under test:
``ManualClock.advance`` fires due timers synchronously on the calling
thread, while ``RealClock`` runs them on a daemon scheduler thread.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, Protocol


class TimerHandle:
    __slots__ = ("seq", "cancelled")

    def __init__(self, seq: int):
        self.seq = seq
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class Clock(Protocol):
    def now(self) -> float: ...

    def call_later(self, delay: float, fn: Callable[[], None]) -> TimerHandle: ...


class ManualClock:
    """Deterministic test clock; advance() runs due callbacks in time order."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._heap: list[tuple[float, int, TimerHandle, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def call_later(self, delay: float, fn: Callable[[], None]) -> TimerHandle:
        with self._lock:
            h = TimerHandle(next(self._seq))
            heapq.heappush(self._heap, (self._now + delay, h.seq, h, fn))
            return h

    def advance(self, dt: float) -> None:
        with self._lock:
            target = self._now + dt
        while True:
            with self._lock:
                if not self._heap or self._heap[0][0] > target:
                    self._now = target
                    return
                when, _, handle, fn = heapq.heappop(self._heap)
                self._now = max(self._now, when)
            if not handle.cancelled:
                fn()  # outside the lock: callbacks may schedule/cancel timers


class RealClock:
    """Wall-clock timers on a single daemon scheduler thread."""

    def __init__(self) -> None:
        import time

        self._time = time.monotonic
        self._heap: list[tuple[float, int, TimerHandle, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._running = False  # toggled under _cv; is_alive() would race idle-exit

    def now(self) -> float:
        return self._time()

    def _ensure_thread(self) -> None:
        # caller holds self._cv
        if not self._running:
            self._running = True
            threading.Thread(target=self._run, daemon=True).start()

    def call_later(self, delay: float, fn: Callable[[], None]) -> TimerHandle:
        with self._cv:
            h = TimerHandle(next(self._seq))
            heapq.heappush(self._heap, (self._time() + delay, h.seq, h, fn))
            self._ensure_thread()
            self._cv.notify()
            return h

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._heap:
                    self._cv.wait(timeout=1.0)
                    if not self._heap:
                        self._running = False  # idle exit, under the lock
                        return
                when, _, handle, fn = self._heap[0]
                delay = when - self._time()
                if delay > 0:
                    self._cv.wait(timeout=delay)
                    continue
                heapq.heappop(self._heap)
            if not handle.cancelled:
                try:
                    fn()
                except Exception:  # pragma: no cover - keep scheduler alive
                    import logging

                    logging.getLogger(__name__).exception("timer callback failed")
