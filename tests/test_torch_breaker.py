"""The port's circuit breaker and retry helpers against the JAX package's.

Both breakers see the same scripted sequence of allow/success/failure/slow
calls under one fake clock and the same seed; their state, lifetime opens,
reopen deadline, gauge and transition counters must be equal at every step.
``backoff_s`` and ``call_with_retries`` must draw the same pauses from the
same seeded RNG and give up at the same attempt.
"""

import random

import pytest

from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.runtime import breaker as ref
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.runtime import breaker as port


class Clock:
    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _script(seed: int, n: int = 400):
    """(op, latency, advance) steps: allow / ok / fail, slow successes."""
    rng = random.Random(seed)
    for _ in range(n):
        op = rng.choice(("allow", "ok", "ok", "fail", "fail", "slow"))
        yield op, rng.uniform(0.0, 0.3), rng.choice((0.0, 0.05, 0.4, 1.5, 4.0))


def _drive(mod, registry, clock, seed, **kw):
    br = mod.CircuitBreaker(edge="scorer", registry=registry, clock=clock, seed=seed, **kw)
    trace = []
    for op, lat, adv in _script(seed):
        clock.t += adv
        if op == "allow":
            got = br.allow()
        elif op == "ok":
            got = br.record_success(lat)
        elif op == "slow":
            got = br.record_success(lat + 1.0)
        else:
            got = br.record_failure(lat)
        trace.append((op, got, br.state, br.opens, round(br._open_until, 12),
                      br._probes_inflight, br._probe_successes, len(br._window)))
    return br, trace


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, {"min_calls": 3, "failure_ratio": 0.5, "cooldown_s": 1.0}),
    (2, {"latency_threshold_s": 0.2, "half_open_max": 2, "close_after": 3}),
    (3, {"window_s": 2.0, "cooldown_s": 0.5, "cooldown_max_s": 3.0}),
])
def test_breaker_state_machine_matches_the_reference(seed, kw):
    rr, pr = RefRegistry(), Registry()
    _, want = _drive(ref, rr, Clock(), seed, **kw)
    _, got = _drive(port, pr, Clock(), seed, **kw)
    assert got == want
    assert any(step[2] == "open" for step in got)  # the script does trip it
    # ccfd_breaker_state and ccfd_breaker_transitions_total, as scraped
    assert pr.render() == rr.render()


def test_call_and_guard_match_the_reference():
    clock_r, clock_p = Clock(), Clock()
    brs = [ref.CircuitBreaker(edge="e", min_calls=2, clock=clock_r),
           port.CircuitBreaker(edge="e", min_calls=2, clock=clock_p)]
    outcomes = []
    for br, open_err in zip(brs, (ref.CircuitOpenError, port.CircuitOpenError)):

        class Edge:
            n = 0

            def hit(self, fail):
                self.n += 1
                if fail:
                    raise OSError("down")
                return self.n

            value = 7

        g = br.guard(Edge(), methods=("hit",))
        seen = []
        for fail in (False, True, True, False, True):
            try:
                seen.append(g.hit(fail))
            except open_err:
                seen.append("open")
            except OSError:
                seen.append("err")
        seen.append(g.value)
        outcomes.append((seen, br.state))
    assert outcomes[0] == outcomes[1]
    assert issubclass(port.CircuitOpenError, ConnectionError)


@pytest.mark.parametrize("attempt", range(8))
def test_backoff_draws_as_the_reference(attempt):
    for base, cap in ((0.05, 2.0), (0.2, 1.0)):
        a = ref.backoff_s(attempt, base, cap, random.Random(attempt))
        b = port.backoff_s(attempt, base, cap, random.Random(attempt))
        assert a == b
        assert min(base * 2 ** attempt, cap) * 0.5 <= b <= min(base * 2 ** attempt, cap)


@pytest.mark.parametrize("fails,retries,deadline", [
    (0, 2, None), (2, 2, None), (3, 2, None), (5, 4, 0.2), (9, 8, 1.0)])
def test_call_with_retries_matches_the_reference(fails, retries, deadline):
    results = []
    for mod in (ref, port):
        clock = Clock()
        sleeps: list[float] = []
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] <= fails:
                raise ConnectionError(f"attempt {calls[0]}")
            return calls[0]

        def sleep(s):
            sleeps.append(s)
            clock.t += s

        try:
            out = mod.call_with_retries(fn, retries, deadline_s=deadline,
                                        rng=random.Random(5), sleep=sleep, clock=clock)
        except ConnectionError as e:
            out = str(e)
        results.append((out, calls[0], sleeps))
    assert results[0] == results[1]
