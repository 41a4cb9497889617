"""The port's chaos monkey (ccfd_tpu_torch/runtime/chaos.py) against the
reference's (ccfd_tpu/runtime/chaos.py).

- **The schedule**: the same seed over the same supervisor shape picks the
  same victims in the same order (``Supervisor.inject_failure``), skipping
  services that are not running or run once (``Never``), counted in
  ``chaos_injections_total{service}``.
- **The storms**: one window activates the edge, device and storage plans
  together and closes them together, counted in
  ``chaos_fault_windows_total``; the scheduled storm loop opens windows at
  ``fault_interval_s`` and ``stop()`` closes a window mid-flight; the
  window list and activation counts follow the reference's.
- **Recovery**: a router killed three times under a port ``Supervisor``
  restarts and drains every transaction; the operator with chaos on routes
  and starts every produced transaction once while the monkey kills the
  router and a device storm runs.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.runtime import chaos as ref_chaos
from ccfd_tpu.runtime import faults as ref_faults
from ccfd_tpu.runtime import supervisor as ref_supervisor
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.runtime import chaos as port_chaos
from ccfd_tpu_torch.runtime import faults as port_faults
from ccfd_tpu_torch.runtime import supervisor as port_supervisor
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)

SIDES = {"ref": (ref_chaos, ref_faults, ref_supervisor, RefRegistry),
         "port": (port_chaos, port_faults, port_supervisor, Registry)}


@pytest.fixture(autouse=True)
def _no_leaked_plans():
    yield
    for _c, faults, _s, _r in SIDES.values():
        faults.install_device_faults(None)
        faults.install_storage_faults(None)


class FakeSupervisor:
    """A status table of services: ``inject_failure`` records the kill and
    keeps the service running (a restart in zero time)."""

    def __init__(self, states: dict):
        self.states = dict(states)
        self.kills: list = []

    def status(self):
        return {n: {"state": st, "policy": pol} for n, (st, pol) in self.states.items()}

    def inject_failure(self, name, reason="chaos"):
        if self.states[name][0] != "Running":
            return False
        self.kills.append((name, reason))
        return True


SERVICES = {"router": ("Running", "Always"), "notify": ("Running", "Always"),
            "engine": ("Running", "OnFailure"), "heal": ("Running", "Always"),
            "producer": ("Running", "Never"), "slo": ("CrashLoopBackOff", "Always"),
            "audit": ("Running", "Always")}


@pytest.mark.parametrize("seed", [0, 11, 2024])
@pytest.mark.parametrize("targets", [None, ["router", "notify", "producer"]])
def test_the_same_seed_picks_the_same_victims(seed, targets):
    out = {}
    for side, (chaos, _f, _s, reg_cls) in SIDES.items():
        sup, reg = FakeSupervisor(SERVICES), reg_cls()
        m = chaos.ChaosMonkey(sup, seed=seed, targets=targets, registry=reg)
        picked = [m.kill_one() for _ in range(1000)]
        out[side] = (picked, sup.kills[:5], {
            s: reg.counter("chaos_injections_total").value({"service": s})
            for s in SERVICES})
    assert out["port"] == out["ref"]
    picked = set(out["port"][0])
    assert "producer" not in picked and "slo" not in picked  # Never / not running
    assert out["port"][1][0][1] == "chaos-monkey"


def test_no_eligible_victim_kills_nothing():
    for chaos, _f, _s, _r in SIDES.values():
        m = chaos.ChaosMonkey(FakeSupervisor({"producer": ("Running", "Never")}))
        assert m.kill_one() is None and m.history == []


def _plans(faults):
    return (faults.FaultPlan.from_string("scorer:error=0.5", active=False),
            faults.DeviceFaultPlan.from_string("device_hang:ms=1", active=False),
            faults.StorageFaultPlan.from_string("slow_disk:ms=1", active=False))


def test_one_storm_window_toggles_every_plan_in_lockstep():
    out = {}
    for side, (chaos, faults, _s, reg_cls) in SIDES.items():
        reg = reg_cls()
        edge, dev, sto = _plans(faults)
        m = chaos.ChaosMonkey(None, registry=reg, fault_plan=edge, device_fault_plan=dev,
                              storage_fault_plan=sto)
        seen = []

        def probe(m=m, plans=(edge, dev, sto), seen=seen):
            time.sleep(0.01)
            seen.append(tuple(p.active for p in plans))
        t = threading.Thread(target=probe)
        t.start()
        m.fault_storm(duration_s=0.05)
        t.join()
        out[side] = (seen, [p.activations for p in (edge, dev, sto)],
                     [p.active for p in (edge, dev, sto)], len(m.fault_windows),
                     reg.counter("chaos_fault_windows_total").value())
    assert out["port"] == out["ref"] == ([(True, True, True)], [1, 1, 1],
                                         [False, False, False], 1, 1)


def test_the_storm_schedule_runs_and_stop_closes_a_window_mid_flight():
    for chaos, faults, _s, reg_cls in SIDES.values():
        edge, dev, sto = _plans(faults)
        m = chaos.ChaosMonkey(FakeSupervisor({}), interval_s=3600.0, registry=reg_cls(),
                              device_fault_plan=dev, storage_fault_plan=sto,
                              fault_interval_s=0.02, fault_duration_s=0.05)
        m.start()
        deadline = time.monotonic() + 10
        while dev.activations < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        while not dev.active:
            time.sleep(0.002)
        m.stop()
        assert not dev.active and not sto.active  # closed mid-window
        assert dev.activations == sto.activations >= 3
        n = len(m.fault_windows)
        time.sleep(0.1)
        assert len(m.fault_windows) == n  # stopped means stopped
        assert all(b >= a for a, b in m.fault_windows)
        assert edge.activations == 0  # not handed to the monkey


def test_a_monkey_without_plans_runs_no_storm_thread():
    m = port_chaos.ChaosMonkey(FakeSupervisor({}), interval_s=3600.0, fault_interval_s=0.01)
    m.start()
    assert m._fault_thread is None
    m.fault_storm(0.01)  # nothing to toggle
    assert m.fault_windows == []
    m.stop()


def _wait(pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def test_the_router_survives_chaos_kills_under_the_ports_supervisor():
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
    from ccfd_tpu_torch.process.fraud import build_engine
    from ccfd_tpu_torch.router.router import Router

    cfg = Config(fraud_threshold=0.5)
    broker = Broker()
    reg_r, reg_c = Registry(), Registry()
    engine = build_engine(cfg, broker, Registry(), None)
    router = Router(cfg, broker, lambda x: np.zeros(len(x), np.float32), engine, reg_r,
                    max_batch=256)
    sup = port_supervisor.Supervisor(backoff_initial_s=0.01, backoff_cap_s=0.05)
    sup.add_thread_service("router", lambda: router.run(poll_timeout_s=0.02), router.stop,
                           reset=router.reset)
    sup.start()
    monkey = port_chaos.ChaosMonkey(sup, seed=7, targets=["router"], registry=reg_c)
    try:
        recs = [{FEATURE_NAMES[j]: float(j) for j in range(30)} | {"id": i, "Amount": 10.0}
                for i in range(200)]
        total = 0
        for round_i in range(3):
            broker.produce_batch(cfg.kafka_topic, recs)
            total += len(recs)
            assert _wait(lambda: router._c_in.value() >= total), round_i
            assert monkey.kill_one() == "router"
            assert _wait(lambda: sup.status()["router"]["restarts"] >= round_i + 1)
        broker.produce_batch(cfg.kafka_topic, recs[:50])
        assert _wait(lambda: router._c_in.value() >= total + 50)
        out = reg_r.counter("transaction_outgoing_total")
        assert _wait(lambda: out.value({"type": "standard"}) == total + 50)
        assert reg_c.counter("chaos_injections_total").value({"service": "router"}) == 3
    finally:
        monkey.stop()
        sup.stop()
        router.close()


def test_the_operator_starts_every_transaction_once_under_chaos(tmp_path):
    """Chaos on in the CR: the monkey kills the router on a seeded schedule
    and a device-hang storm runs; every produced transaction is started
    exactly once, and the audit ring holds one record a routed
    transaction."""
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    n = 600
    cr = {"spec": {
        "store": {"enabled": False}, "bus": {"partitions": 2},
        "scorer": {"enabled": True, "model": "mlp", "train_steps": 0},
        "engine": {"enabled": True}, "notify": {"enabled": True, "seed": 0},
        "router": {"enabled": True, "workers": 1}, "retrain": {"enabled": False},
        "producer": {"enabled": True, "transactions": n, "rate": 2000,
                     "wire_format": "dict"},
        "monitoring": {"enabled": True, "port": 0}, "health": {"enabled": False},
        "lifecycle": {"enabled": False}, "analytics": {"enabled": False},
        "incident": {"enabled": False}, "capacity": {"enabled": False},
        "heal": {"interval_s": 0.05, "canary_deadline_ms": 100.0, "suspect_strikes": 1,
                 "probation_canaries": 1, "backoff_base_s": 0.01, "backoff_cap_s": 0.05},
        "chaos": {"enabled": True, "interval_s": 0.1, "seed": 3, "targets": ["router"],
                  "device_faults": "device_hang:ms=300", "fault_interval_s": 0.1,
                  "fault_duration_s": 0.15},
    }}
    cfg = Config.from_env({"CCFD_BATCH_SIZES": "16,128"})
    p = Platform(PlatformSpec.from_cr(cr, cfg=cfg), device="cpu").up(wait_ready_s=30)
    try:
        assert p.wait_producer(timeout_s=30)
        assert p.wait_routed(timeout_s=30)
        assert _wait(lambda: len(p.chaos.history) >= 1 and p.device_fault_plan.activations >= 1)
        p.chaos.stop()
        assert p.wait_routed(timeout_s=30)
        reg = p.registries["router"]
        routed = reg.counter("transaction_outgoing_total").total()
        assert routed == n and reg.counter("transaction_incoming_total").value() == n
        assert p.engine.snapshot()["next_pid"] - 1 == n  # each started once
        assert p.audit.counts()["recorded"] == n
    finally:
        p.down()
    assert port_faults.device_faults() is None
