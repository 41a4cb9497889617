"""The port's edge fault injection (ccfd_tpu_torch/runtime/faults.py)
against the reference's (ccfd_tpu/runtime/faults.py): the same plan and
seed draw the same delays, errors and corruptions call for call; a bad
spec fails with the reference's message; the router role wraps exactly its
scorer and engine edges; and a router under a plan routes every row, its
faulted rows on the rules tier, as the reference's does."""

from __future__ import annotations

import socket

import numpy as np
import pytest

from ccfd_tpu.runtime import faults as ref_faults
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.runtime import faults as port_faults

PLAN = "scorer:latency=5,jitter=3,error=0.2,corrupt=0.1;engine:error=0.05"


def _trace(mod, spec: str, seed: int, edge: str, calls: int, sleeps: list,
           registry=None) -> list:
    """What each of ``calls`` calls through one edge's injector saw: the
    delay it slept, and whether it raised or came back corrupted."""
    inj = mod.FaultPlan.from_string(spec, seed=seed).injector(edge, registry)
    out = []
    for _ in range(calls):
        del sleeps[:]
        try:
            got = inj.run(lambda: np.ones(4, np.float32))
            outcome = "corrupt" if np.isnan(got).all() else "ok"
        except mod.InjectedFault as e:
            outcome = "error: " + str(e)
        out.append((round(sum(sleeps), 12), outcome))
    return out


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("edge", ["scorer", "engine"])
def test_the_same_plan_draws_the_same_faults(monkeypatch, seed, edge):
    import time

    sleeps: list = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    reg = Registry()
    got = _trace(port_faults, PLAN, seed, edge, 2000, sleeps, reg)
    want = _trace(ref_faults, PLAN, seed, edge, 2000, sleeps)
    assert got == want
    kinds = {o if o in ("ok", "corrupt") else "error" for _, o in got}
    assert kinds == ({"ok", "corrupt", "error"} if edge == "scorer" else {"ok", "error"})
    # every perturbation counted by edge and kind
    c = reg.counter("faults_injected_total")
    n_err = sum(o.startswith("error") for _, o in got)
    assert c.value({"edge": edge, "kind": "error"}) == n_err
    assert c.value({"edge": edge, "kind": "corrupt"}) == sum(o == "corrupt" for _, o in got)
    assert c.value({"edge": edge, "kind": "latency"}) == sum(d > 0 for d, _ in got)


def test_wildcard_blackhole_and_drip_draw_alike(monkeypatch):
    import time

    sleeps: list = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    spec = "*:drip=2,stall=10,blackhole=0;bus:blackhole,stall=3"
    for edge in ("bus", "store", "scorer"):
        assert (_trace(port_faults, spec, 3, edge, 300, sleeps)
                == _trace(ref_faults, spec, 3, edge, 300, sleeps))


def test_an_inactive_plan_does_nothing_and_resets_the_drip(monkeypatch):
    import time

    sleeps: list = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    for mod in (ref_faults, port_faults):
        plan = mod.FaultPlan.from_string("scorer:drip=4,error=1", active=False)
        inj = plan.injector("scorer")
        assert inj.run(lambda: 3) == 3 and not sleeps
        plan.activate()
        with pytest.raises(mod.InjectedFault):
            inj.run(lambda: 3)
        assert plan.activations == 1 and inj.injected == 1  # the first call: no drip yet
    assert mod.FaultPlan.from_string("").injector("scorer") is None


BAD = ["scorer", ":latency=5", "scorer:bogus=1", "scorer:error=2", "scorer:corrupt=1.5",
       "scorer:latency=-1", "scorer:error=abc", "scorer:jitter=-2;engine:error=0.1",
       "scorer:stall=-1"]


@pytest.mark.parametrize("spec", BAD)
def test_a_bad_spec_fails_with_the_references_message(spec):
    with pytest.raises(ValueError) as want:
        ref_faults.FaultPlan.from_string(spec)
    with pytest.raises(ValueError) as got:
        port_faults.FaultPlan.from_string(spec)
    assert str(got.value) == str(want.value)


def test_wrap_perturbs_only_the_named_methods():
    class Client:
        x = 5

        def start_process(self, d, v):
            return 1

        def definitions(self):
            return ("fraud",)

    inj = port_faults.FaultPlan.from_string("engine:error=1").injector("engine")
    proxy = inj.wrap(Client(), methods=("start_process",))
    assert proxy.definitions() == ("fraud",) and proxy.x == 5
    with pytest.raises(port_faults.InjectedFault):
        proxy.start_process("fraud", {})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def engine_url():
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.process.fraud import build_engine
    from ccfd_tpu_torch.process.server import EngineServer

    engine = build_engine(Config(), Broker(), Registry())
    srv = EngineServer(engine)
    port = srv.start("127.0.0.1", 0)
    yield f"http://127.0.0.1:{port}", engine
    srv.stop()


@pytest.mark.parametrize("seldon", [True, False], ids=["seldon-url", "local-scorer"])
def test_build_router_wraps_exactly_the_scorer_and_engine_edges(engine_url, seldon):
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.cli import build_router
    from ccfd_tpu_torch.process.client import EngineRestClient
    from ccfd_tpu_torch.runtime.breaker import MethodProxy

    url, _engine = engine_url
    env = {"KIE_SERVER_URL": url, "CCFD_TRACE_SAMPLE": "0", "CCFD_BATCH_SIZES": "16",
           "CCFD_FAULTS": "scorer:error=0.2;engine:latency=1;bus:error=0.5;store:blackhole"}
    if seldon:
        env["SELDON_URL"] = f"http://127.0.0.1:{_free_port()}"
    router, reg, _sink, _ = build_router(Config.from_env(env), device="cpu")
    assert isinstance(router.broker, Broker)  # the bus edge is not the router's to wrap
    assert isinstance(router.engine, MethodProxy)
    assert isinstance(router.engine._inner, EngineRestClient)
    assert router.engine._methods == frozenset(
        ("start_process", "start_process_batch", "signal"))
    if seldon:
        inj = router.score.__self__._faults
    else:
        inj = router.score  # the wrapped local score function
        with pytest.raises(port_faults.InjectedFault):
            for _ in range(50):  # error=0.2: one of 50 calls raises
                inj(np.zeros((4, 30), np.float32))
        inj = None
    if inj is not None:
        assert (inj.edge, inj.spec.error_rate) == ("scorer", 0.2)
    router.close()
    # without a plan nothing is wrapped
    env.pop("CCFD_FAULTS")
    router, *_ = build_router(Config.from_env(env), device="cpu")
    assert not isinstance(router.engine, MethodProxy)
    if seldon:
        assert router.score.__self__._faults is None
    router.close()


def test_router_under_a_plan_routes_every_row_as_the_reference(engine_url):
    """The router role on SELDON_URL (a CPU ``serve``) under CCFD_FAULTS,
    beside the reference's router wired as its cmd_router wires it, both
    scoring through the same server with the same plan: every row routed,
    the faulted rows on the rules tier, none on a host tier, and the same
    routes, tiers and fault counts on both sides."""
    from ccfd_tpu.bus.broker import Broker as RefBroker
    from ccfd_tpu.config import Config as RefConfig
    from ccfd_tpu.metrics.prom import Registry as RefRegistry
    from ccfd_tpu.process.client import EngineRestClient as RefEngineClient
    from ccfd_tpu.router.router import Router as RefRouter
    from ccfd_tpu.serving.client import SeldonClient as RefSeldonClient
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.cli import build_router, build_server
    from ccfd_tpu_torch.data.ccfd import iter_transactions
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
    from ccfd_tpu_torch.process.fraud import build_engine
    from ccfd_tpu_torch.process.server import EngineServer

    txs = list(iter_transactions(kaggle_surrogate(n=600, seed=29)))
    srv = build_server(Config.from_env({"CCFD_BATCH_SIZES": "16,128",
                                        "CCFD_NATIVE_FRONT": "0"}), device="cpu")
    sport = srv.start("127.0.0.1", 0)
    env = {"SELDON_URL": f"http://127.0.0.1:{sport}", "CCFD_TRACE_SAMPLE": "0",
           "CCFD_OVERLOAD": "0", "CCFD_CLIENT_RETRIES": "0", "SELDON_TIMEOUT": "5000",
           "CCFD_FAULTS": "scorer:error=0.1,corrupt=0.05;engine:latency=1,jitter=2"}
    servers, results = [srv], {}
    try:
        for side in ("ref", "port"):
            engine = build_engine(Config(), Broker(), Registry())
            esrv = EngineServer(engine)
            servers.append(esrv)
            e = {**env, "KIE_SERVER_URL": f"http://127.0.0.1:{esrv.start('127.0.0.1', 0)}"}
            if side == "port":
                cfg = Config.from_env(e)
                router, reg, _sink, _collectors = build_router(cfg)
            else:  # the reference's router role, as its cmd_router wires it
                cfg = RefConfig.from_env(e)
                reg = RefRegistry()
                plan = ref_faults.FaultPlan.from_string(cfg.faults_spec)
                client = RefEngineClient(cfg.kie_server_url,
                                         timeout_s=cfg.seldon_timeout_ms / 1000.0,
                                         retries=cfg.client_retries)
                client = plan.injector("engine", reg).wrap(
                    client, methods=("start_process", "start_process_batch", "signal"))
                router = RefRouter(cfg, RefBroker(),
                                   RefSeldonClient(cfg, faults=plan.injector("scorer", reg)).score,
                                   client, registry=reg, host_score_fn=None, degrade=True)
            for i in range(0, len(txs), 20):
                chunk = txs[i:i + 20]
                router.broker.produce_batch(cfg.kafka_topic, chunk, [t["id"] for t in chunk])
                while router.step():
                    pass
            routes = {inst.vars["transaction"]["id"]: (inst.definition.id,
                                                       float(inst.vars["proba"]))
                      for inst in engine.instances() if "transaction" in inst.vars}
            c = reg.counter
            results[side] = (
                routes,
                {t: c("router_degraded_total").value({"tier": t}) for t in ("host", "rules")},
                {t: c("transaction_outgoing_total").value({"type": t})
                 for t in ("fraud", "standard")},
                {(edge, kind): c("faults_injected_total").value({"edge": edge, "kind": kind})
                 for edge, kind in (("scorer", "error"), ("scorer", "corrupt"),
                                    ("engine", "latency"))},
                c("router_score_errors_total").value(),
                reg.counter("ccfd_breaker_transitions_total").value(
                    {"edge": "scorer", "to": "open"}))
    finally:
        for s in servers:
            s.stop()
    assert results["port"] == results["ref"]
    routes, tiers, out, injected, score_errors, opened = results["port"]
    assert len(routes) == len(txs) == sum(out.values())
    assert all(np.isfinite(p) for _, p in routes.values())  # no NaN reached the engine
    assert tiers["host"] == 0 and tiers["rules"] == score_errors > 0
    assert all(injected.values()) and opened == 0
