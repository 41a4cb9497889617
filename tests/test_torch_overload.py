"""The port's overload plane against the JAX package's.

The same scripted latency samples under one fake clock move both AIMD
budgets to the same limits; the same polls (records with priority headers
and produce timestamps) give both ``OverloadControl.admit`` the same
survivors, the same shed counts by priority and stage and the same
inversion tripwire; both ``AdmissionGate``s admit and refuse the same
requests; the watchdog times out and counts alike; ``from_config`` builds
the same budget from the same environment.
"""

import random
import time
from typing import Any, NamedTuple

import pytest

from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.runtime import overload as ref
from ccfd_tpu.serving.dispatch import ScorerTimeout as RefTimeout
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.runtime import overload as port
from ccfd_tpu_torch.serving.dispatch import ScorerTimeout


class Clock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


class Rec(NamedTuple):
    timestamp: float
    headers: Any = None
    value: Any = None


def _counters(reg, names=("ccfd_shed_total", "ccfd_admission_total",
                          "ccfd_priority_inversions_total", "ccfd_inflight_limit",
                          "ccfd_inflight_used")):
    return [line for line in reg.render().splitlines()
            if line.split("{")[0].split(" ")[0] in names]


@pytest.mark.parametrize("seed", range(4))
def test_aimd_limits_match_the_reference(seed):
    rng = random.Random(seed)
    budgets = []
    for mod, reg in ((ref, RefRegistry()), (port, Registry())):
        clock = Clock()
        b = mod.AdaptiveInflightBudget(8192, min_limit=1024, target_s=0.05,
                                       registry=reg, clock=clock)
        budgets.append((b, clock, reg))
    trace = ([], [])
    for _ in range(600):
        lat = rng.choice((0.01, 0.02, 0.04, 0.08, 0.3))
        adv = rng.choice((0.0, 0.01, 0.05, 0.2))
        n = rng.randrange(0, 5000)
        for k, (b, clock, _) in enumerate(budgets):
            clock.t += adv
            b.observe(lat)
            got = b.reserve(n)
            ok = b.try_reserve(n // 3, ceiling=0.9)
            b.release(got // 2)
            trace[k].append((b.limit, got, ok, b.inflight, b.room()))
    assert trace[0] == trace[1]
    assert len({t[0] for t in trace[1]}) > 3  # the limit did move
    assert _counters(budgets[0][2]) == _counters(budgets[1][2])


def _records(rng, now, n):
    names = (None, {"priority": "bulk"}, {"priority": "normal"},
             {"priority": "critical"}, {"priority": "fraud"}, [("priority", b"rescore")],
             {"priority": "7"}, {"priority": "junk"})
    return [Rec(now - rng.choice((0.0, 0.01, 0.05, 0.2, 1.0)), rng.choice(names))
            for _ in range(n)]


@pytest.mark.parametrize("codel_ms,prepaid", [(0.0, False), (40.0, False),
                                               (40.0, True), (150.0, False)])
def test_admit_sheds_the_same_rows_as_the_reference(codel_ms, prepaid):
    rng_seed = int(codel_ms) + prepaid
    outs = []
    for mod in (ref, port):
        rng = random.Random(rng_seed)
        reg = RefRegistry() if mod is ref else Registry()
        clock = Clock(5000.0)
        budget = mod.AdaptiveInflightBudget(3000, min_limit=500, registry=reg, clock=clock)
        codel = mod.DeadlinePolicy(codel_ms / 1e3) if codel_ms else None
        ov = mod.OverloadControl(reg, budget, codel=codel, clock=clock)
        seen = []
        for _ in range(40):
            recs = _records(rng, clock.t, rng.randrange(1, 900))
            if prepaid:
                budget.reserve(len(recs))
            keep, shed = ov.admit(recs, prepaid=prepaid)
            seen.append(([recs.index(r) for r in keep], shed, budget.inflight))
            budget.release(rng.randrange(0, budget.inflight // 4 + 1))
            clock.t += 0.01
        outs.append((seen, _counters(reg)))
    assert outs[0] == outs[1]
    assert any(s[1] for s in outs[1][0])  # something was shed


def test_priority_parsing_matches_the_reference():
    for v in (None, "bulk", "LOW", " normal ", "critical", "high", "fraud", "canary",
              "shadow", "rescore", b"critical", "2", "-5", "9", 1.7, "x", object()):
        assert port.parse_priority(v) == ref.parse_priority(v)
    for h in (None, {}, {"priority": "bulk"}, [("priority", b"critical")],
              [(b"priority", "bulk")], [(1, 2, 3)], 5):
        assert port.headers_priority(h) == ref.headers_priority(h)
    assert port.PRIORITY_NAMES == ref.PRIORITY_NAMES


def test_admission_gate_matches_the_reference():
    outs = []
    for mod, reg, cfg in ((ref, RefRegistry(), RefConfig()), (port, Registry(), Config())):
        rng = random.Random(3)
        built = mod.AdmissionGate.from_config(cfg, mod is ref and RefRegistry() or Registry(),
                                              max_rows=1024).budget
        clock = Clock()  # the AIMD cooldowns on a fake clock: deterministic
        budget = mod.AdaptiveInflightBudget(
            built.limit, min_limit=built.min_limit, max_limit=built.max_limit,
            target_s=built.target_s, registry=reg, stage="serving", clock=clock)
        gate = mod.AdmissionGate(budget, reg)
        held, seen = [], []
        for _ in range(300):
            rows = rng.choice((1, 16, 300, 1024, 3000, 5000))
            pri = rng.choice((0, 1, 2))
            ok = gate.try_admit(rows, pri)
            seen.append(ok)
            if ok:
                held.append(rows)
            if held and rng.random() < 0.4:
                gate.release(held.pop(rng.randrange(len(held))))
            gate.observe(rng.choice((0.001, 0.01, 0.2)))
            clock.t += 0.02
        outs.append((seen, (built.limit, built.min_limit, built.max_limit, built.target_s),
                     gate.budget.limit, _counters(reg)))
    assert outs[0] == outs[1]
    assert not all(outs[1][0]) and any(outs[1][0])


def test_from_config_builds_the_same_plane():
    env = {"CCFD_OVERLOAD_TARGET_MS": "20", "CCFD_OVERLOAD_MIN_INFLIGHT": "2048",
           "CCFD_OVERLOAD_MAX_INFLIGHT": "50000", "CCFD_OVERLOAD_CODEL_TARGET_MS": "300",
           "CCFD_OVERLOAD_DISPATCH_DEADLINE_MS": "250"}
    for workers in (1, 3):
        a = ref.OverloadControl.from_config(RefConfig.from_env(env), RefRegistry(),
                                            max_batch=4096, workers=workers)
        b = port.OverloadControl.from_config(Config.from_env(env), Registry(),
                                             max_batch=4096, workers=workers)
        for f in ("limit", "min_limit", "max_limit", "target_s", "step", "beta",
                  "decrease_cooldown_s"):
            assert getattr(b.budget, f) == getattr(a.budget, f), f
        assert b.codel.target_s == a.codel.target_s
        assert (b.dispatch_deadline_s, b.dispatch_threads) == (
            a.dispatch_deadline_s, a.dispatch_threads)
    assert port.OverloadControl.from_config(Config.from_env({"CCFD_OVERLOAD": "0"}),
                                            Registry()) is None
    # the watchdog's auto deadline: off on the CPU (as the reference's cpu
    # backend), SELDON_TIMEOUT on the card
    auto = Config.from_env({})
    assert port.OverloadControl.from_config(auto, Registry()).dispatch_deadline_s == 0.0
    assert ref.OverloadControl.from_config(RefConfig.from_env({}),
                                           RefRegistry()).dispatch_deadline_s == 0.0
    assert port.OverloadControl.from_config(
        auto, Registry(), on_card=True).dispatch_deadline_s == 5.0


def test_watchdog_times_out_and_counts_as_the_reference():
    outs = []
    for mod, reg, timeout_t in ((ref, RefRegistry(), RefTimeout),
                                (port, Registry(), ScorerTimeout)):
        budget = mod.AdaptiveInflightBudget(8192, registry=reg, target_s=0.05)
        ov = mod.OverloadControl(reg, budget, dispatch_deadline_ms=50)
        got = [ov.bounded_dispatch(lambda: 41 + 1)]
        with pytest.raises(timeout_t):
            ov.bounded_dispatch(lambda: time.sleep(0.5))
        with pytest.raises(ValueError):
            ov.bounded_dispatch(lambda: (_ for _ in ()).throw(ValueError("bad")))
        got.append(budget.limit)
        outs.append((got, _counters(reg, ("ccfd_dispatch_timeout_total",
                                          "ccfd_inflight_limit"))))
    assert outs[0] == outs[1]
    assert outs[1][0] == [42, int(8192 * 0.7)]
