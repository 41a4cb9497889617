"""Circuit breakers and retry backoff for the RPC edges.

The port's copy of ccfd_tpu/runtime/breaker.py. A sick endpoint behind a
plain client timeout (``SELDON_TIMEOUT``) is re-dialed at full rate and
every call eats the whole timeout; a per-edge breaker over a rolling
error+latency window refuses instantly once the edge is sick, and retries
back off exponentially with jitter under a deadline budget.

States: CLOSED (calls flow; outcomes recorded in a rolling window) -> OPEN
when the window's failure ratio crosses the threshold (calls refused at
once; the caller falls to its degraded tier) -> HALF_OPEN after a cooldown
(a bounded number of probes test the edge) -> CLOSED after consecutive
probe successes, or back to OPEN on a probe failure with the cooldown
doubled (+ jitter). Slow calls count as failures when
``latency_threshold_s`` is set.

With a registry a breaker exports ``ccfd_breaker_state{edge}`` (0 closed,
1 half-open, 2 open) and ``ccfd_breaker_transitions_total{edge,to}``.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Callable

# gauge values: bigger is sicker
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}


class CircuitOpenError(ConnectionError):
    """The breaker refused the call without touching the edge."""


class CircuitBreaker:
    """Thread-safe three-state breaker over a rolling outcome window.

    ``clock`` (monotonic seconds) and ``seed`` (the reopen jitter) are
    injectable, so state transitions are deterministic under test. One
    breaker guards one edge; callers use :meth:`call` or the ``allow()`` /
    ``record_success`` / ``record_failure`` triple."""

    def __init__(
        self,
        edge: str = "",
        window_s: float = 10.0,
        min_calls: int = 5,
        failure_ratio: float = 0.5,
        latency_threshold_s: float | None = None,
        cooldown_s: float = 1.0,
        cooldown_max_s: float = 30.0,
        half_open_max: int = 1,
        close_after: int = 2,
        seed: int = 0,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.edge = edge
        self.window_s = float(window_s)
        self.min_calls = int(min_calls)
        self.failure_ratio = float(failure_ratio)
        self.latency_threshold_s = latency_threshold_s
        self.cooldown_s = float(cooldown_s)
        self.cooldown_max_s = float(cooldown_max_s)
        self.half_open_max = int(half_open_max)
        self.close_after = int(close_after)
        self._clock = clock
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self._state = CLOSED
        self._window: deque[tuple[float, bool]] = deque()  # (ts, ok)
        self._open_until = 0.0
        self._consecutive_opens = 0
        self._probes_inflight = 0
        self._probe_successes = 0
        self.opens = 0  # lifetime open transitions
        self._g_state = None
        self._c_transitions = None
        if registry is not None:
            self._g_state = registry.gauge(
                "ccfd_breaker_state",
                "circuit state per edge: 0 closed, 1 half-open, 2 open")
            self._g_state.set(CLOSED, labels={"edge": edge})
            self._c_transitions = registry.counter(
                "ccfd_breaker_transitions_total",
                "breaker state transitions by edge and target state")

    # -- state machine (all under _mu) ------------------------------------
    def _set_state(self, state: int) -> None:
        if state == self._state:
            return
        self._state = state
        if self._g_state is not None:
            self._g_state.set(state, labels={"edge": self.edge})
        if self._c_transitions is not None:
            self._c_transitions.inc(
                labels={"edge": self.edge, "to": _STATE_NAMES[state]})

    def _evict(self, now: float) -> None:
        w = self._window
        floor = now - self.window_s
        while w and w[0][0] < floor:
            w.popleft()

    def _trip_open(self, now: float) -> None:
        self._consecutive_opens += 1
        self.opens += 1
        # exponential backoff + jitter on re-opens: a flapping edge is
        # probed at a decaying rate, and clients do not re-probe in lockstep
        base = min(self.cooldown_s * 2 ** (self._consecutive_opens - 1),
                   self.cooldown_max_s)
        self._open_until = now + base * (1.0 + 0.5 * self._rng.random())
        self._window.clear()
        self._probes_inflight = 0
        self._probe_successes = 0
        self._set_state(OPEN)

    def allow(self) -> bool:
        """May a call proceed now? OPEN past its cooldown admits up to
        ``half_open_max`` probes (and moves to HALF_OPEN)."""
        now = self._clock()
        with self._mu:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now < self._open_until:
                    return False
                self._set_state(HALF_OPEN)
                self._probes_inflight = 0
                self._probe_successes = 0
            if self._probes_inflight < self.half_open_max:
                self._probes_inflight += 1
                return True
            return False

    def record_success(self, latency_s: float = 0.0) -> None:
        slow = (self.latency_threshold_s is not None
                and latency_s > self.latency_threshold_s)
        now = self._clock()
        with self._mu:
            if self._state == HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)
                if slow:
                    self._trip_open(now)
                    return
                self._probe_successes += 1
                if self._probe_successes >= self.close_after:
                    self._consecutive_opens = 0
                    self._window.clear()
                    self._set_state(CLOSED)
                return
            self._record(now, ok=not slow)

    def record_failure(self, latency_s: float = 0.0) -> None:
        now = self._clock()
        with self._mu:
            if self._state == HALF_OPEN:
                self._trip_open(now)  # one failed probe: still sick
                return
            if self._state == OPEN:
                return
            self._record(now, ok=False)

    def _record(self, now: float, ok: bool) -> None:
        self._window.append((now, ok))
        self._evict(now)
        n = len(self._window)
        if n < self.min_calls:
            return
        failures = sum(1 for _, k in self._window if not k)
        if failures / n >= self.failure_ratio:
            self._trip_open(now)

    # -- conveniences ------------------------------------------------------
    @property
    def state(self) -> str:
        with self._mu:
            # surface the pending OPEN -> HALF_OPEN edge without a call
            if self._state == OPEN and self._clock() >= self._open_until:
                return _STATE_NAMES[HALF_OPEN]
            return _STATE_NAMES[self._state]

    def force_close(self) -> None:
        """Deliberate external close, for a caller holding stronger evidence
        than a half-open probe could gather (the heal ladder's warm
        re-promotion: N consecutive canaries with host parity). Clears the
        outcome window, the reopen backoff and any pending cooldown: from
        OPEN, ``record_success`` changes nothing, and the residual cooldown
        would both refuse the healed edge and read as fresh quarantine
        evidence."""
        with self._mu:
            self._window.clear()
            self._consecutive_opens = 0
            self._open_until = 0.0
            self._probes_inflight = 0
            self._probe_successes = 0
            self._set_state(CLOSED)

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Gate, time and record one call. Raises :class:`CircuitOpenError`
        when the breaker refuses."""
        if not self.allow():
            raise CircuitOpenError(f"circuit open for edge {self.edge!r}")
        t0 = self._clock()
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure(self._clock() - t0)
            raise
        self.record_success(self._clock() - t0)
        return out

    def guard(self, obj: Any, methods: Any = None) -> Any:
        """Proxy ``obj`` so the named public methods run through
        :meth:`call`."""
        return MethodProxy(obj, self.call,
                           frozenset(methods) if methods else None)


class MethodProxy:
    """Delegating proxy that routes the named public methods (all public
    callables when ``methods`` is None) through ``wrap_call(bound_method,
    *args, **kwargs)``; attributes, private and unlisted methods pass
    through untouched."""

    def __init__(self, inner: Any, wrap_call: Callable[..., Any],
                 methods: frozenset[str] | None):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_wrap_call", wrap_call)
        object.__setattr__(self, "_methods", methods)

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._inner, name)
        if (not name.startswith("_") and callable(attr)
                and (self._methods is None or name in self._methods)):
            wrap_call = self._wrap_call

            def guarded(*args: Any, **kwargs: Any) -> Any:
                return wrap_call(attr, *args, **kwargs)

            return guarded
        return attr

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(self._inner, name, value)


def backoff_s(attempt: int, base_s: float = 0.05, cap_s: float = 2.0,
              rng: random.Random | None = None) -> float:
    """Exponential backoff with jitter for retry ``attempt`` (0-based):
    uniform in [half, full] of ``base * 2^attempt``, capped."""
    full = min(base_s * (2 ** attempt), cap_s)
    r = (rng or random).random()
    return full * (0.5 + 0.5 * r)


def call_with_retries(
    fn: Callable[[], Any],
    retries: int,
    base_backoff_s: float = 0.05,
    max_backoff_s: float = 2.0,
    deadline_s: float | None = None,
    retry_on: tuple[type[BaseException], ...] = (ConnectionError, OSError),
    rng: random.Random | None = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> Any:
    """Bounded retries (attempts = ``retries`` + 1) under a total deadline
    budget: a retry whose backoff would land past ``deadline_s`` is not
    taken."""
    deadline = None if deadline_s is None else clock() + deadline_s
    last: BaseException | None = None
    for attempt in range(max(1, retries + 1)):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - retry loop by design
            last = e
            if attempt >= retries:
                break
            pause = backoff_s(attempt, base_backoff_s, max_backoff_s, rng)
            if deadline is not None and clock() + pause > deadline:
                break
            sleep(pause)
    assert last is not None
    raise last
