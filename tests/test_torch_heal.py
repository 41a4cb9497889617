"""The port's device heal supervisor and device fault plans
(ccfd_tpu_torch/runtime/heal.py, runtime/faults.py) against the
reference's (ccfd_tpu/runtime/heal.py, runtime/faults.py).

- **Device fault plans**: the same parse, errors, toggle and seeded
  ``put_fail`` draws (1,000 a seed); the seams: ``put_fail`` inside the
  staging copy counts in ``h2d_failures()`` and adds no bytes,
  ``compile_stall`` bills a synthetic build to the active label,
  ``device_oom`` overlays allocator pressure once per activation window,
  and the decision plane and the seq scorer carry the dispatch seam.
- **The supervisor, tick by tick**: both packages' ``DeviceSupervisor``
  over the same fake scorer (a seeded logistic model whose canary can be
  made to raise, hang, return NaN or a scrambled score), the same manual
  clock, the same fake telemetry and profiler and each package's own
  breaker, with the same seed: after every tick the state, ``status()``,
  the next heal time (the jittered backoff) and the lifetime counters are
  equal, for each scenario of the reference's test_heal.py that exists in
  the port (the flight-recorder bundles: test_torch_observatory.py).
- **The port on its own Scorer** (the CPU): hang, quarantine, warm
  re-promotion with no serving-label build, the canary on the router's
  watchdog, the seq scorer healing through its own seam; the router pinned
  to the host tier while quarantined.
- **The operator**: heal on by default with the gate wired (composed with
  the storage pin), the CCFD_HEAL=0 and CR kill switches, the device plan
  installed from the chaos block and uninstalled by ``down()``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.runtime import breaker as ref_breaker
from ccfd_tpu.runtime import faults as ref_faults
from ccfd_tpu.runtime import heal as ref_heal
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.runtime import breaker as port_breaker
from ccfd_tpu_torch.runtime import faults as port_faults
from ccfd_tpu_torch.runtime import heal as port_heal
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)


@pytest.fixture(autouse=True)
def _no_leaked_device_faults():
    yield
    ref_faults.install_device_faults(None)
    port_faults.install_device_faults(None)


# -- device fault plans --------------------------------------------------------


@pytest.mark.parametrize("text", ["device_hang:ms=123;put_fail:rate=0.5",
                                  "compile_stall:ms=7", "device_oom:ratio=0.95",
                                  "device_hang;device_oom;put_fail;compile_stall", ""])
def test_device_plans_parse_and_toggle_as_the_reference(text):
    out = []
    for faults in (ref_faults, port_faults):
        plan = faults.DeviceFaultPlan.from_string(text, active=False)
        specs = {k: (s.hang_ms, s.stall_ms, s.oom_ratio, s.rate) for k, s in plan.kinds.items()}
        inactive = [plan.spec(k) for k in plan.kinds]
        plan.activate()
        active = {k: plan.spec(k) is not None for k in plan.kinds}
        plan.deactivate()
        out.append((specs, inactive, active, plan.activations, plan.active))
    assert out[0] == out[1]
    assert port_faults.DEVICE_FAULT_KINDS == ref_faults.DEVICE_FAULT_KINDS


@pytest.mark.parametrize("text,match", [
    ("warp_core_breach", "unknown device fault"),
    ("device_hang:bogus=1", "unknown device-fault option"),
    ("device_hang:ms", "expected key=value"),
    ("put_fail:rate=1.5", "outside"),
    ("device_oom:ratio=-1", "outside"),
    ("device_hang:ms=-3", "must be >= 0"),
])
def test_bad_device_plans_fail_with_the_references_message(text, match):
    with pytest.raises(ValueError, match=match) as want:
        ref_faults.DeviceFaultPlan.from_string(text)
    with pytest.raises(ValueError, match=match) as got:
        port_faults.DeviceFaultPlan.from_string(text)
    assert str(got.value) == str(want.value)


def _put_draws(faults, seed: int, n: int) -> tuple:
    plan = faults.DeviceFaultPlan.from_string(
        "put_fail:rate=0.4;device_hang:ms=0;compile_stall:ms=0", seed=seed)
    faults.install_device_faults(plan)
    out = []
    for _ in range(n):
        try:
            faults.device_seam("put")
            out.append(False)
        except faults.InjectedFault as e:
            out.append(str(e))
        faults.device_seam("dispatch")
    faults.install_device_faults(None)
    return out, dict(plan.injected)


@pytest.mark.parametrize("seed", [0, 3, 77])
def test_put_fail_and_dispatch_seams_draw_the_same_1000_times(seed):
    got, want = _put_draws(port_faults, seed, 1000), _put_draws(ref_faults, seed, 1000)
    assert got == want
    assert 0 < got[1]["put_fail"] < 1000
    assert got[1]["device_hang"] == got[1]["compile_stall"] == 1000


def test_the_seams_are_free_without_an_active_plan():
    port_faults.install_device_faults(
        port_faults.DeviceFaultPlan.from_string("put_fail", active=False))
    port_faults.device_seam("put")  # inactive: nothing raises
    port_faults.install_device_faults(None)
    port_faults.device_seam("put")


def test_device_oom_overlay_counts_once_per_activation_window():
    counts = []
    for faults in (ref_faults, port_faults):
        plan = faults.DeviceFaultPlan.from_string("device_oom:ratio=0.97")
        faults.install_device_faults(plan)
        ratios = [faults.device_oom_overlay() for _ in range(5)]
        plan.deactivate()
        off = faults.device_oom_overlay()
        plan.activate()
        faults.device_oom_overlay()
        counts.append((ratios, off, dict(plan.injected)))
        faults.install_device_faults(None)
    assert counts[0] == counts[1] == ([0.97] * 5, None, {"device_oom": 2})


def test_device_oom_overlay_reports_pressure_through_telemetry():
    from ccfd_tpu_torch.observability.device import DeviceTelemetry

    before = DeviceTelemetry.device_memory()
    port_faults.install_device_faults(
        port_faults.DeviceFaultPlan.from_string("device_oom:ratio=0.97"))
    mem = DeviceTelemetry.device_memory()
    assert mem
    for kinds in mem.values():
        assert kinds["bytes_in_use"] / kinds["bytes_limit"] >= 0.96
    port_faults.install_device_faults(None)
    assert DeviceTelemetry.device_memory() == before


def _scorer(**kw):
    from ccfd_tpu_torch.serving.scorer import Scorer

    kw.setdefault("model_name", "mlp")
    kw.setdefault("batch_sizes", (16, 128))
    sc = Scorer(device="cpu", **kw)
    sc.warmup()
    return sc


def test_put_fail_raises_in_the_staging_copy_counts_and_adds_no_bytes():
    from ccfd_tpu_torch.observability.device import DeviceTelemetry

    reg = Registry()
    tele = DeviceTelemetry(registry=reg)
    sc = _scorer(telemetry=tele)
    x = np.zeros((300, sc.num_features), np.float32)
    sc.score_pipelined(x, depth=1)
    bytes0, fails0 = tele.h2d_bytes(), tele.h2d_failures()
    port_faults.install_device_faults(port_faults.DeviceFaultPlan.from_string("put_fail"))
    with pytest.raises(port_faults.InjectedFault):
        sc.score_pipelined(x, depth=1)
    assert tele.h2d_failures() == fails0 + 1
    assert tele.h2d_bytes() == bytes0  # a failed copy adds no H2D bytes
    assert reg.counter("ccfd_h2d_put_failures_total").value() == fails0 + 1
    port_faults.install_device_faults(None)
    assert sc.score_pipelined(x, depth=1).shape == (300,)


def test_compile_stall_bills_synthetic_builds_to_the_active_label():
    from ccfd_tpu_torch.observability import profile
    from ccfd_tpu_torch.observability.profile import StageProfiler, compile_stage

    reg = Registry()
    prof = StageProfiler(registry=reg)
    prof.arm_compile_listener()
    sc = _scorer()
    builds = profile.builds_total()
    before = prof.compile_counts().get("total", 0)
    port_faults.install_device_faults(
        port_faults.DeviceFaultPlan.from_string("compile_stall:ms=1"))
    with compile_stage("router.score"):
        sc.score_pipelined(np.zeros((200, sc.num_features), np.float32), depth=1)
    counts = prof.compile_counts()
    assert counts["total"] == before + 2  # one a dispatch: 128 + 72 rows
    assert counts["router.score"] == 2
    assert profile.builds_total() == builds  # not a compiler run
    assert reg.counter("ccfd_build_events_total").value() == 2


def test_the_decision_plane_and_the_seq_scorer_carry_the_dispatch_seam():
    from ccfd_tpu_torch.params import load_tree
    from ccfd_tpu_torch.platform.operator import SEQ_INIT
    from ccfd_tpu_torch.router.rules import default_rules
    from ccfd_tpu_torch.serving.fused import FusedDecisionScorer
    from ccfd_tpu_torch.observability.device import DeviceTelemetry
    from ccfd_tpu_torch.serving.history import SeqScorer

    sc = _scorer()
    plane = FusedDecisionScorer(sc, default_rules(0.5))
    tele = DeviceTelemetry(registry=Registry())
    seq = SeqScorer(load_tree(SEQ_INIT), length=4, batch_sizes=(16,),
                    compute_dtype="float32", device="cpu", telemetry=tele)
    plan = port_faults.DeviceFaultPlan.from_string("device_hang:ms=0")
    port_faults.install_device_faults(plan)
    plane.decide(np.zeros((200, 30), np.float32))  # 128 + 72 rows: two launches
    assert plan.injected["device_hang"] == 2
    seq.score(np.zeros((20, 30), np.float32), ids=list(range(20)))  # 16 + 4
    assert plan.injected["device_hang"] == 4
    # the seq history copies are the row scorer's timed staging copies
    # (observability/device.py timed_copy): two copies of (16, L, F) f32
    assert tele.h2d_count() == 2 and tele.h2d_bytes() == 2 * 16 * 4 * 30 * 4
    port_faults.install_device_faults(
        port_faults.DeviceFaultPlan.from_string("put_fail"))
    with pytest.raises(port_faults.InjectedFault):
        seq.score(np.zeros((4, 30), np.float32))
    assert tele.h2d_failures() == 1 and tele.h2d_bytes() == 2 * 16 * 4 * 30 * 4


# -- the breaker's force_close ------------------------------------------------------


def test_force_close_is_the_references():
    out = []
    for br_mod, reg in ((ref_breaker, RefRegistry()), (port_breaker, Registry())):
        clock = [0.0]
        br = br_mod.CircuitBreaker(edge="scorer", min_calls=1, failure_ratio=0.01,
                                   cooldown_s=30.0, cooldown_max_s=60.0, seed=4,
                                   registry=reg, clock=lambda: clock[0])
        br.record_failure()
        opened = (br.state, br.allow(), br.opens)
        br.force_close()
        closed = (br.state, br.allow(), br.opens)
        br.record_failure()  # a fresh window: one failure trips again
        again = (br.state, br._consecutive_opens, round(br._open_until, 9))
        out.append((opened, closed, again,
                    reg.counter("ccfd_breaker_transitions_total").value(
                        {"edge": "scorer", "to": "closed"})))
    assert out[0] == out[1]
    assert out[1][0][0] == "open" and out[1][1][:2] == ("closed", True)


# -- the supervisor, tick by tick against the reference ---------------------------


class FakeScorer:
    """A seeded logistic 'device' whose canary can be made to fail."""

    num_features = 30
    has_host_forward = True

    def __init__(self) -> None:
        rng = np.random.default_rng(5)
        self.params = {"w": (rng.standard_normal(30) / 6).astype(np.float32),
                       "b": np.float32(0.1)}
        self.mode = "ok"
        self.warm_fail = False
        self.swaps = self.warms = 0

    def _p(self, x):
        return (1.0 / (1.0 + np.exp(-(x @ self.params["w"] + self.params["b"])))
                ).astype(np.float32)

    def score_pipelined(self, x, depth=2):
        if self.mode == "raise":
            raise RuntimeError("device wedged")
        if self.mode == "hang":
            time.sleep(0.08)
        out = self._p(x)
        if self.mode == "nan":
            out[:] = np.nan
        if self.mode == "scramble":
            out = np.clip(out + 0.5, 0.0, 1.0)
        return out

    def host_score(self, x):
        return self._p(x)

    def warmup(self):
        if self.warm_fail:
            raise RuntimeError("warm boom")
        self.warms += 1

    def swap_params(self, params):
        self.params = {k: np.asarray(v, np.float32) for k, v in params.items()}
        self.swaps += 1


class FakeTelemetry:
    def __init__(self) -> None:
        self.mem: dict = {}
        self.failures = 0

    def device_memory(self):
        return {d: dict(k) for d, k in self.mem.items()}

    def h2d_failures(self):
        return self.failures


class FakeProfiler:
    def __init__(self) -> None:
        self.counts = {"total": 0}

    def compile_counts(self):
        return dict(self.counts)

    def bill(self, stage: str, n: int) -> None:
        self.counts[stage] = self.counts.get(stage, 0) + n
        self.counts["total"] += n


class Twin:
    """The reference's and the port's supervisor over identical fakes and
    one manual clock; ``tick()`` ticks both and holds them equal."""

    def __init__(self, breaker: bool = False, breaker_kw: dict | None = None, **kw):
        self.clock = [0.0]
        kw.setdefault("canary_deadline_ms", 40.0)
        kw.setdefault("suspect_strikes", 2)
        kw.setdefault("probation_canaries", 2)
        kw.setdefault("backoff_base_s", 1.0)
        kw.setdefault("backoff_cap_s", 16.0)
        kw.setdefault("seed", 3)
        self.sides = {}
        for name, heal, br_mod, reg in (("ref", ref_heal, ref_breaker, RefRegistry()),
                                        ("port", port_heal, port_breaker, Registry())):
            sc, tele, prof = FakeScorer(), FakeTelemetry(), FakeProfiler()
            br = None
            if breaker:
                br = br_mod.CircuitBreaker(edge="scorer", seed=1, clock=lambda: self.clock[0],
                                           **(breaker_kw or {}))
            sup = heal.DeviceSupervisor(sc, registry=reg, breaker=br, telemetry=tele,
                                        profiler=prof, clock=lambda: self.clock[0], **kw)
            self.sides[name] = {"sup": sup, "sc": sc, "tele": tele, "prof": prof,
                                "br": br, "reg": reg}
        self.ticks = 0

    def each(self, fn) -> None:
        for side in self.sides.values():
            fn(side)

    def set(self, **attrs) -> None:
        for side in self.sides.values():
            for k, v in attrs.items():
                setattr(side["sc"], k, v)

    def advance(self, dt: float) -> None:
        self.clock[0] += dt

    def to_next_heal(self) -> None:
        self.clock[0] = self.sides["port"]["sup"]._next_heal_at + 0.001

    @staticmethod
    def snap(side) -> tuple:
        sup, sc, reg = side["sup"], side["sc"], side["reg"]
        counters = {
            name: {lab: reg.counter(name).value(dict([lab])) for lab in labels}
            for name, labels in (
                ("ccfd_heal_attempts_total", [("rung", r) for r in ref_heal.RUNGS]),
                ("ccfd_heal_canary_total", [("outcome", o) for o in ("pass", "fail")]),
                ("ccfd_heal_transitions_total",
                 [("to", s) for s in ref_heal.STATE_NAMES.values()]))
        }
        br = side["br"]
        return (sup.status(), round(sup._next_heal_at, 9), sup.device_allowed(),
                sc.swaps, sc.warms, counters, br.state if br is not None else None)

    def tick(self) -> str:
        states = {n: s["sup"].tick() for n, s in self.sides.items()}
        snaps = {n: self.snap(s) for n, s in self.sides.items()}
        self.ticks += 1
        assert states["port"] == states["ref"], (self.ticks, states)
        assert snaps["port"] == snaps["ref"], (self.ticks, snaps)
        return states["port"]

    @property
    def status(self) -> dict:
        return self.sides["port"]["sup"].status()


def _heal(twin: Twin, limit: int = 30) -> list:
    """Tick (jumping the clock to each heal attempt) until healthy."""
    seen = []
    for _ in range(limit):
        twin.to_next_heal()
        seen.append(twin.tick())
        if seen[-1] == "healthy":
            return seen
    raise AssertionError(f"did not heal: {seen}")


def scenario_healthy_stays_healthy(t: Twin):
    for _ in range(3):
        t.advance(1.0)
        assert t.tick() == "healthy"


def scenario_hang_strikes_to_suspect_then_quarantine_and_heals(t: Twin):
    t.set(mode="hang")
    assert t.tick() == "suspect"
    assert t.tick() == "quarantined"
    assert t.status["quarantines"] == 1
    t.set(mode="ok")
    assert _heal(t)[-3:] == ["probation", "probation", "healthy"]
    assert t.status["repromotions"] == 1


def scenario_suspect_recovers_on_a_transient_blip(t: Twin):
    t.set(mode="raise")
    assert t.tick() == "suspect"
    t.set(mode="ok")
    assert t.tick() == "healthy"
    assert t.status["quarantines"] == 0


def scenario_nan_canary_is_a_strike(t: Twin):
    t.set(mode="nan")
    t.tick()
    assert t.tick() == "quarantined"
    assert any("invalid response" in r for r in t.status["reasons"])


def scenario_oom_pressure_quarantines(t: Twin):
    t.each(lambda s: s["tele"].mem.update(
        {"cpu:0": {"bytes_in_use": 99, "bytes_limit": 100}}))
    t.tick()
    assert t.tick() == "quarantined"
    assert any("device_oom" in r for r in t.status["reasons"])


def scenario_put_failures_strike_and_the_baseline_is_live(t: Twin):
    t.each(lambda s: setattr(s["tele"], "failures", 3))
    assert t.tick() == "suspect"
    assert any("put_fail: 3" in r for r in t.status["reasons"])
    assert t.tick() == "healthy"  # no new failures since the last tick


def scenario_compile_storm_quarantines(t: Twin):
    assert t.tick() == "healthy"  # the baseline snapshot
    t.advance(5.0)
    t.each(lambda s: s["prof"].bill("router.score", 10))  # 2/s >= 2/s
    t.tick()
    t.advance(1.0)
    t.each(lambda s: s["prof"].bill("untagged", 5))
    assert t.tick() == "quarantined"
    assert any("compile_storm" in r for r in t.status["reasons"])


def scenario_warm_labelled_builds_are_not_a_storm(t: Twin):
    assert t.tick() == "healthy"
    t.advance(5.0)
    t.each(lambda s: [s["prof"].bill(lab, 50) for lab in
                      ("heal.warm", "heal.canary", "scorer.warmup", "fused.warm")])
    assert t.tick() == "healthy"


def scenario_ladder_escalates_rungs_with_backoff(t: Twin):
    t.set(mode="raise")
    t.tick()
    assert t.tick() == "quarantined"
    rungs = []
    for _ in range(6):
        t.advance(0.01)
        t.tick()  # before the backoff: no attempt
        t.to_next_heal()
        t.tick()
        rungs.append(t.status["rung"])
    assert rungs[:3] == ["reinit", "respawn", "respawn"]
    assert t.sides["port"]["sc"].swaps >= 1  # the respawn rung re-published
    t.set(mode="ok")
    _heal(t)


def scenario_probation_needs_n_canaries_and_a_failure_requarantines(t: Twin):
    t.set(mode="raise")
    t.tick()
    t.tick()
    t.set(mode="ok")
    t.to_next_heal()
    assert t.tick() == "probation"
    assert t.sides["port"]["sc"].warms == 1  # the warm step ran on entry
    assert t.tick() == "probation"  # 1 of 2
    t.set(mode="raise")
    assert t.tick() == "quarantined"
    assert t.status["quarantines"] == 2 and t.status["rung"] == "reinit"
    t.set(mode="ok")
    _heal(t)


def scenario_parity_blocks_a_scrambled_device(t: Twin):
    t.set(mode="raise")
    t.tick()
    t.tick()
    t.set(mode="scramble")
    t.to_next_heal()
    assert t.tick() == "probation"  # the plain canary passes
    assert t.tick() == "quarantined"  # the parity canary does not
    assert any("parity" in r for r in t.status["reasons"])
    t.set(mode="ok")
    _heal(t)


def scenario_flap_hysteresis_deepens_the_backoff(t: Twin):
    waits = []
    for _ in range(2):
        t.set(mode="raise")
        t.tick()
        t.tick()
        waits.append(t.sides["port"]["sup"]._next_heal_at - t.clock[0])
        t.set(mode="ok")
        _heal(t)
        t.advance(1.0)  # re-quarantined right after the promote: a flap
    assert t.status["flap_streak"] == 1
    # base 1 s: the first ladder starts in [0.5, 1], the flap's one deeper
    assert waits[0] <= 1.0 <= waits[1]


def scenario_warm_failure_escalates_instead_of_looping_rung0(t: Twin):
    t.set(mode="raise")
    t.tick()
    t.tick()
    t.set(mode="ok", warm_fail=True)
    rungs = set()
    for _ in range(8):
        t.to_next_heal()
        t.tick()
        rungs.add(t.status["rung"])
    assert {"reinit", "respawn"} <= rungs
    t.set(warm_fail=False)
    _heal(t)


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_healthy_stays_healthy,
    scenario_hang_strikes_to_suspect_then_quarantine_and_heals,
    scenario_suspect_recovers_on_a_transient_blip,
    scenario_nan_canary_is_a_strike,
    scenario_oom_pressure_quarantines,
    scenario_put_failures_strike_and_the_baseline_is_live,
    scenario_compile_storm_quarantines,
    scenario_warm_labelled_builds_are_not_a_storm,
    scenario_ladder_escalates_rungs_with_backoff,
    scenario_probation_needs_n_canaries_and_a_failure_requarantines,
    scenario_parity_blocks_a_scrambled_device,
    scenario_flap_hysteresis_deepens_the_backoff,
    scenario_warm_failure_escalates_instead_of_looping_rung0,
)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_the_supervisor_walks_the_references_states_tick_by_tick(name):
    twin = Twin()
    SCENARIOS[name](twin)
    assert twin.ticks >= 2


def test_a_stale_put_failure_history_is_not_a_strike():
    tele = FakeTelemetry()
    tele.failures = 2  # history that predates the supervisor
    for heal in (ref_heal, port_heal):
        sup = heal.DeviceSupervisor(FakeScorer(), telemetry=tele, seed=0)
        assert sup._prev_put_failures == 2
        assert sup.tick() == "healthy"


def test_breaker_signal_and_the_warm_flip_force_closes_it():
    twin = Twin(breaker=True, breaker_kw={"min_calls": 1, "failure_ratio": 0.01,
                                          "cooldown_s": 30.0, "cooldown_max_s": 60.0},
                suspect_strikes=1, probation_canaries=1)
    twin.each(lambda s: s["br"].record_failure())
    assert twin.tick() == "quarantined"
    assert any("breaker" in r for r in twin.status["reasons"])
    _heal(twin)
    assert twin.sides["port"]["br"].state == "closed"
    twin.advance(1.0)
    assert twin.tick() == "healthy"  # no strike from a residual cooldown


def test_labels_and_the_non_serving_stages():
    assert port_heal.STATE_NAMES == ref_heal.STATE_NAMES
    assert port_heal.RUNGS == ref_heal.RUNGS
    assert ref_heal.NON_SERVING_COMPILE_STAGES <= port_heal.NON_SERVING_COMPILE_STAGES
    assert port_heal.NON_SERVING_COMPILE_STAGES - ref_heal.NON_SERVING_COMPILE_STAGES == {
        "scorer.warm"}  # the port's row-scorer warmup label
    assert port_heal.default_device_label("cpu") == "cpu:0"
    assert port_heal.default_device_label() == ref_heal.default_device_label() == "cpu:0"


# -- the port's supervisor on its own Scorer (CPU) -------------------------------


def _sup(scorer, **kw):
    kw.setdefault("canary_deadline_ms", 150.0)
    kw.setdefault("suspect_strikes", 2)
    kw.setdefault("probation_canaries", 2)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_cap_s", 0.05)
    return port_heal.DeviceSupervisor(scorer, **kw)


def _heal_until(sup, state, ticks=40, sleep_s=0.05):
    for _ in range(ticks):
        if sup.tick() == state:
            return True
        time.sleep(sleep_s)
    return sup.state == state


def _hang(ms=400):
    port_faults.install_device_faults(
        port_faults.DeviceFaultPlan.from_string(f"device_hang:ms={ms}"))


def test_the_port_scorer_hangs_quarantines_and_heals_warm():
    from ccfd_tpu_torch.observability.profile import StageProfiler

    reg = Registry()
    prof = StageProfiler(registry=Registry())
    prof.arm_compile_listener()
    sc = _scorer()
    sup = _sup(sc, registry=reg, profiler=prof)
    assert sup.device == "cpu:0" and sup.tick() == "healthy"
    assert 'state="healthy"} 1' in reg.render().replace('device="cpu:0",', "")
    _hang()
    assert sup.tick() == "suspect" and sup.device_allowed()
    assert sup.tick() == "quarantined" and not sup.device_allowed()
    port_faults.install_device_faults(None)
    assert _heal_until(sup, "healthy")
    assert sup.repromotions == 1 and sc.executable_grid()["warmed"] == [16, 128]
    serving = sum(v for s, v in prof.compile_counts().items()
                  if s not in port_heal.NON_SERVING_COMPILE_STAGES)
    assert serving == 0  # the re-promotion built nothing on a serving label


def test_the_reinit_rung_drops_the_scorers_device_state():
    sc = _scorer()
    sup = _sup(sc, suspect_strikes=1)
    sup._reinit()
    assert sc.executable_grid()["warmed"] == []
    sup._warm()
    assert sc.executable_grid()["warmed"] == [16, 128]
    before = sc.params["layers"][0]["w"]
    sup._respawn()
    assert sc.params["layers"][0]["w"] is not before  # fresh buffers
    np.testing.assert_array_equal(sc.params["layers"][0]["w"].numpy(), before.numpy())


def test_the_canary_rides_the_routers_watchdog_and_counts_timeouts():
    from ccfd_tpu_torch.runtime.overload import OverloadControl

    reg = Registry()
    ov = OverloadControl.from_config(Config(), reg, max_batch=256, workers=1)
    ov.dispatch_deadline_s = 30.0  # serving's deadline is generous, the canary's not
    sup = _sup(_scorer(), overload=ov, suspect_strikes=1, canary_deadline_ms=100.0)
    _hang(500)
    assert sup.tick() == "quarantined"
    assert reg.counter("ccfd_dispatch_timeout_total").value() >= 1
    assert sup.canary_failures == 1


def test_the_seq_scorer_heals_through_its_own_dispatch_seam():
    from ccfd_tpu_torch.params import load_tree
    from ccfd_tpu_torch.platform.operator import SEQ_INIT
    from ccfd_tpu_torch.serving.history import SeqScorer

    sc = SeqScorer(load_tree(SEQ_INIT), length=8, batch_sizes=(16, 64),
                   compute_dtype="float32", device="cpu")
    sc.warmup()
    sup = _sup(sc, suspect_strikes=1, probation_canaries=1, canary_deadline_ms=400.0)
    assert sup.tick() == "healthy"
    _hang(900)
    assert sup.tick() == "quarantined"
    port_faults.install_device_faults(None)
    assert _heal_until(sup, "healthy")
    assert sup.repromotions == 1


class _Gate:
    def __init__(self, allowed: bool, host: bool = True):
        self.allowed, self.host = allowed, host

    def device_allowed(self):
        return self.allowed

    def host_allowed(self):
        return self.host


def _router(score_fn, gate=None, breaker=None, workers=1):
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.process.fraud import build_engine
    from ccfd_tpu_torch.router.parallel import ParallelRouter
    from ccfd_tpu_torch.router.router import Router

    cfg = Config(confidence_threshold=1.0)
    broker = Broker(default_partitions=workers)
    reg = Registry()
    engine = build_engine(cfg, broker, reg, None)
    sc = _scorer()
    if workers == 1:
        r = Router(cfg, broker, score_fn, engine, reg, max_batch=256,
                   host_score_fn=sc.host_score, breaker=breaker, degrade=True,
                   heal_gate=gate)
    else:
        r = ParallelRouter(cfg, broker, score_fn, engine, reg, workers=workers,
                           host_score_fn=sc.host_score, degrade=True)
    return r, broker, reg, cfg


def test_quarantine_pins_the_router_to_the_host_tier_above_the_breaker():
    calls = [0]

    def device_score(x):
        calls[0] += 1
        return np.zeros((len(x),), np.float32)

    clock = [0.0]
    br = port_breaker.CircuitBreaker(edge="scorer", min_calls=1, failure_ratio=0.5,
                                     cooldown_s=0.1, seed=3, clock=lambda: clock[0])
    br.record_failure()
    clock[0] += 10.0  # past the cooldown: allow() would admit a probe
    gate = _Gate(False)
    r, broker, reg, cfg = _router(device_score, gate=gate, breaker=br)
    broker.produce_batch(cfg.kafka_topic, [b"0," * 29 + b"0"] * 32, list(range(32)))
    assert r.step() == 32
    assert calls[0] == 0 and br.state == "half_open"  # the probe slot did not leak
    assert reg.counter("router_degraded_total").value({"tier": "host"}) == 32
    gate.allowed = True
    br.force_close()
    broker.produce_batch(cfg.kafka_topic, [b"0," * 29 + b"0"] * 8, list(range(8)))
    assert r.step() == 8 and calls[0] == 1  # unpinned: the device serves again
    r.close()


def test_set_heal_gate_reaches_every_parallel_worker():
    sc = _scorer()
    r, broker, reg, cfg = _router(sc.score, workers=2)
    gate = _Gate(False)
    r.set_heal_gate(gate)
    assert all(w._heal_gate is gate for w in r.workers)
    broker.produce_batch(cfg.kafka_topic, [b"0," * 29 + b"0"] * 64, list(range(64)))
    assert r.step() == 64
    assert reg.counter("router_degraded_total").value({"tier": "host"}) == 64
    r.close()


def test_the_gate_pins_even_with_the_ladder_off():
    calls = [0]

    def score(x):
        calls[0] += 1
        return np.zeros(len(x), np.float32)

    r, *_ = _router(score, gate=_Gate(False))
    r._degrade = False
    out, fired = r._score_batch(np.zeros((4, 30), np.float32), [{}] * 4)
    assert calls[0] == 0 and out.shape == (4,) and fired is None
    r.close()


# -- the operator ------------------------------------------------------------------


def _platform_cr(heal=None, **blocks):
    spec = {
        "store": {"enabled": False}, "producer": {"enabled": False},
        "investigator": {"enabled": False}, "analytics": {"enabled": False},
        "retrain": {"enabled": False}, "lifecycle": {"enabled": False},
        "incident": {"enabled": False}, "capacity": {"enabled": False},
        "monitoring": {"enabled": True, "port": 0}, "health": {"enabled": False},
        "scorer": {"enabled": True, "model": "mlp"},
    }
    if heal is not None:
        spec["heal"] = heal
    spec.update(blocks)
    return {"spec": spec}


def _up(cr, env=None):
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    cfg = Config.from_env({"CCFD_BATCH_SIZES": "16,128", **(env or {})})
    return Platform(PlatformSpec.from_cr(cr, cfg=cfg), device="cpu").up(wait_ready_s=30)


def test_operator_heal_is_on_by_default_with_the_gate_wired():
    from ccfd_tpu_torch.runtime.durability import ComposedHealGate

    p = _up(_platform_cr())
    try:
        assert p.heal is not None
        gate = p.router._heal_gate
        assert isinstance(gate, ComposedHealGate)
        assert p.heal in gate.gates and p.storage_gate in gate.gates
        assert gate.device_allowed() and gate.host_allowed()
        assert p.supervisor.status()["heal"]["state"] == "Running"
        assert p.status()["heal"]["state"] == "healthy"
        assert "ccfd_device_health" in p.registries["heal"].render()
        assert p._health_verdict()["sources"]["device"]["healthy"]
        # quarantine shows in /healthz; the storage pin still blocks the host tier
        p.heal._set_state(port_heal.QUARANTINED)
        verdict = p._health_verdict()
        assert not verdict["sources"]["device"]["healthy"]
        assert not gate.device_allowed() and gate.host_allowed()
        p.storage_gate.pin("drill")
        assert not gate.host_allowed()
    finally:
        p.down()


def test_operator_heal_kill_switches():
    p = _up(_platform_cr(), env={"CCFD_HEAL": "0"})
    try:
        assert p.heal is None
        assert p.router._heal_gate is p.storage_gate  # the pin still binds
        assert "heal" not in p.supervisor.status()
    finally:
        p.down()
    p = _up(_platform_cr(heal={"enabled": False}))
    try:
        assert p.heal is None
    finally:
        p.down()


def test_operator_installs_the_device_plan_from_the_chaos_block():
    p = _up(_platform_cr(chaos={"enabled": True, "targets": [],
                                "device_faults": "device_hang:ms=50",
                                "interval_s": 3600.0}))
    try:
        assert p.device_fault_plan is not None and p.device_fault_plan.active
        assert port_faults.device_faults() is p.device_fault_plan
        assert p.device_fault_plan.kinds["device_hang"].hang_ms == 50.0
        assert p.chaos is not None and p.chaos._device_fault_plan is None
    finally:
        p.down()
    assert port_faults.device_faults() is None  # down() uninstalls


def test_a_storm_driven_device_plan_goes_to_the_monkey_an_env_plan_stays_active():
    p = _up(_platform_cr(chaos={"enabled": True, "targets": [],
                                "device_faults": "device_hang:ms=1",
                                "interval_s": 3600.0, "fault_interval_s": 3600.0}))
    try:
        plan = p.device_fault_plan
        assert plan is not None and not plan.active
        assert p.chaos._device_fault_plan is plan
        p.chaos.fault_storm(duration_s=0.01)
        assert plan.activations >= 1 and not plan.active
    finally:
        p.down()
    p = _up(_platform_cr(chaos={"enabled": True, "targets": [], "interval_s": 3600.0,
                                "fault_interval_s": 3600.0}),
            env={"CCFD_DEVICE_FAULTS": "device_hang:ms=1"})
    try:
        assert p.device_fault_plan is not None and p.device_fault_plan.active
        assert p.chaos._device_fault_plan is None
    finally:
        p.down()


def test_config_takes_the_heal_knobs_as_the_reference():
    from ccfd_tpu.config import Config as RefConfig

    env = {"CCFD_HEAL": "0", "CCFD_HEAL_INTERVAL_S": "1.5",
           "CCFD_HEAL_CANARY_DEADLINE_MS": "99", "CCFD_HEAL_SUSPECT_STRIKES": "5",
           "CCFD_HEAL_PROBATION_CANARIES": "7", "CCFD_HEAL_PARITY_TOL": "0.2",
           "CCFD_HEAL_OOM_RATIO": "0.5", "CCFD_HEAL_COMPILE_STORM_PER_S": "3",
           "CCFD_HEAL_BACKOFF_BASE_S": "0.1", "CCFD_HEAL_BACKOFF_CAP_S": "9",
           "CCFD_HEAL_FLAP_WINDOW_S": "12", "CCFD_DEVICE_FAULTS": "put_fail",
           "CCFD_STORAGE_FAULTS": "bitrot"}
    fields = [f for f in vars(RefConfig()) if f.startswith("heal_")] + [
        "device_faults_spec", "storage_faults_spec"]
    assert len(fields) == 13
    for e in (env, {}):
        got, want = Config.from_env(e), RefConfig.from_env(e)
        for f in fields:
            assert getattr(got, f) == getattr(want, f), f
    assert Config.from_env(env).unported() == []  # only the operator installs them


def test_heal_runs_as_a_supervised_loop_and_stops():
    sup = _sup(FakeScorer())
    t = threading.Thread(target=sup.run, args=(0.01,), daemon=True)
    t.start()
    time.sleep(0.1)
    sup.stop()
    t.join(timeout=5)
    assert not t.is_alive() and sup.state == "healthy"
