"""The port's degradation ladder against the JAX package's, on the CPU.

Both routers (``degrade=True``, overload control with a 50 ms dispatch
watchdog, a scorer-edge breaker on one fake clock) step through the same
records while one scripted scorer edge answers, raises, hangs past the
watchdog, and returns a reply of the wrong shape or with a NaN, and a
scripted host tier fails once (so a batch falls to the rules tier). Every
transaction must take the same process in both engines, and
``router_degraded_total{tier}``, ``router_score_errors_total``,
``router_host_score_errors_total``, ``ccfd_dispatch_timeout_total`` and the
breaker's transitions must be equal. The port Scorer's ``host_score`` (the
host tier) equals the reference Scorer's to 1e-6 in p.
"""

import time

import numpy as np
import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.process.clock import ManualClock as RefClock
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu.router import router as ref_router
from ccfd_tpu.runtime import breaker as ref_breaker
from ccfd_tpu.runtime import overload as ref_overload
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import Dataset, iter_transactions
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.process.clock import ManualClock
from ccfd_tpu_torch.process.fraud import build_engine
from ccfd_tpu_torch.router import router as port_router
from ccfd_tpu_torch.runtime import breaker as port_breaker
from ccfd_tpu_torch.runtime import overload as port_overload
from ccfd_tpu_torch.serving.scorer import Scorer
from tests.torch_helpers import mlp_tree

BATCH = 40
# the scorer edge, call by call: ok, raise, hang past the watchdog, wrong
# shape, NaN; the breaker opens on the failures and half-open probes follow
EDGE = ("ok", "ok", "raise", "raise", "ok", "hang", "short", "nan", "ok", "ok",
        "raise", "ok", "ok", "ok", "nan")  # then "ok" for good
HOST_FAILS_ON = {3}  # the host tier's 4th call raises: that batch goes to rules


class Clock:
    def __init__(self) -> None:
        self.t = 50.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def data():
    ds = kaggle_surrogate(n=1200, seed=21)
    tree = mlp_tree(ds.X, hidden=32, seed=5)
    return ds, tree


@pytest.fixture(scope="module")
def scorers(data):
    ds, tree = data
    ref = RefScorer(model_name="mlp", params=tree, batch_sizes=(16, 128),
                    host_tier_rows=0, use_fused=False)
    port = Scorer(model_name="mlp", params=tree, batch_sizes=(16, 128), device="cpu")
    return ref, port


def test_host_tier_matches_the_reference_host_score(data, scorers):
    ref, port = scorers
    assert port.has_host_forward and ref.has_host_forward
    x = data[0].X[:1000]
    np.testing.assert_allclose(port.host_score(x), ref.host_score(x), rtol=0, atol=1e-6)
    # a swap refreshes the host copy
    tree2 = mlp_tree(data[0].X, hidden=32, seed=9)
    port.swap_params(tree2)
    try:
        want = RefScorer(model_name="mlp", params=tree2, batch_sizes=(16,),
                         host_tier_rows=0, use_fused=False).host_score(x)
        np.testing.assert_allclose(port.host_score(x), want, rtol=0, atol=1e-6)
    finally:
        port.swap_params(data[1])


def _edge(host_score):
    """The scripted scorer edge; its 'ok' answer is the same function on
    both sides (the reference's host forward), so only the ladder differs."""
    calls = [0]

    def score(x):
        kind = EDGE[calls[0]] if calls[0] < len(EDGE) else "ok"
        calls[0] += 1
        if kind == "raise":
            raise ConnectionError("edge down")
        if kind == "hang":
            time.sleep(0.4)
        p = np.asarray(host_score(x), np.float32)
        if kind == "short":
            return p[:-1]
        if kind == "nan":
            p = p.copy()
            p[0] = np.nan
        return p

    return score, calls


def _host(host_score):
    calls = [0]

    def score(x):
        calls[0] += 1
        if calls[0] - 1 in HOST_FAILS_ON:
            raise RuntimeError("host forward failed")
        return host_score(x)

    return score


def _run(side, data, scorers, edge_fn):
    ds = Dataset(X=data[0].X, y=data[0].y)
    txs = list(iter_transactions(ds))
    if side == "ref":
        mods = (RefBroker, RefRegistry, RefClock, ref_build_engine, ref_router,
                ref_breaker, ref_overload, RefConfig)
        host = scorers[0].host_score
    else:
        mods = (Broker, Registry, ManualClock, build_engine, port_router, port_breaker,
                port_overload, Config)
        host = scorers[1].host_score
    broker_t, reg_t, clock_t, build, router_mod, br_mod, ov_mod, cfg_t = mods
    cfg = cfg_t(batch_deadline_ms=0.0)
    broker, reg, reg_k = broker_t(), reg_t(), reg_t()
    engine = build(cfg, broker, reg_k, clock_t())
    fake = Clock()
    breaker = br_mod.CircuitBreaker(edge="scorer", registry=reg, min_calls=3,
                                    failure_ratio=0.5, cooldown_s=1.0, clock=fake)
    budget = ov_mod.AdaptiveInflightBudget(8 * BATCH, min_limit=4 * BATCH,
                                           registry=reg, stage="router")
    overload = ov_mod.OverloadControl(reg, budget, dispatch_deadline_ms=50)
    score, calls = edge_fn(scorers[0].host_score)
    router = router_mod.Router(cfg, broker, score, engine, reg, max_batch=BATCH,
                               host_score_fn=_host(host), breaker=breaker, degrade=True,
                               overload=overload)
    for i in range(0, len(txs), BATCH):
        broker.produce_batch(cfg.kafka_topic, txs[i:i + BATCH],
                             [t["id"] for t in txs[i:i + BATCH]])
        fake.t += 1.7
        while router.step():
            pass
    routes = {inst.vars["transaction"]["id"]: inst.definition.id
              for inst in engine.instances() if "proba" in inst.vars}
    c = reg.counter
    counts = {
        "in": c("transaction_incoming_total").value(),
        "host": c("router_degraded_total").value({"tier": "host"}),
        "rules": c("router_degraded_total").value({"tier": "rules"}),
        "score_errors": c("router_score_errors_total").value(),
        "host_errors": c("router_host_score_errors_total").value(),
        "timeouts": c("ccfd_dispatch_timeout_total").value(),
        "shed": c("router_shed_total").value(),
        "fraud": c("transaction_outgoing_total").value({"type": "fraud"}),
        "standard": c("transaction_outgoing_total").value({"type": "standard"}),
        "to_open": c("ccfd_breaker_transitions_total").value({"edge": "scorer", "to": "open"}),
        "to_closed": c("ccfd_breaker_transitions_total").value(
            {"edge": "scorer", "to": "closed"}),
        "edge_calls": calls[0],
    }
    return routes, counts


def test_ladder_routes_and_counts_as_the_reference(data, scorers):
    want_routes, want = _run("ref", data, scorers, _edge)
    routes, got = _run("port", data, scorers, _edge)
    assert got == want
    assert routes == want_routes
    n = len(data[0].X)
    assert len(routes) == n and got["in"] == n and got["shed"] == 0
    assert got["fraud"] + got["standard"] == n and got["fraud"] and got["standard"]
    # every tier and failure kind ran
    assert got["host"] and got["rules"] == BATCH and got["host_errors"] == BATCH
    assert got["timeouts"] == 1 and got["score_errors"] and got["to_open"] and got["to_closed"]


def test_ladder_off_drops_and_raises_as_the_reference(data, scorers):
    """Without the ladder a scorer failure raises out of step() in both."""
    ds = data[0]
    for side, mods in (("ref", (RefBroker, RefRegistry, RefClock, ref_build_engine,
                                ref_router, RefConfig)),
                       ("port", (Broker, Registry, ManualClock, build_engine, port_router,
                                 Config))):
        broker_t, reg_t, clock_t, build, router_mod, cfg_t = mods
        cfg = cfg_t(batch_deadline_ms=0.0)
        broker = broker_t()
        engine = build(cfg, broker, reg_t(), clock_t())

        def boom(x):
            raise ConnectionError("edge down")

        router = router_mod.Router(cfg, broker, boom, engine, reg_t(), max_batch=BATCH)
        txs = list(iter_transactions(Dataset(X=ds.X[:10], y=ds.y[:10])))
        broker.produce_batch(cfg.kafka_topic, txs)
        with pytest.raises(ConnectionError):
            router.step()
        assert router.registry.counter("router_degraded_total").total() == 0, side
