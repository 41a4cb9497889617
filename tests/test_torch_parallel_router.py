"""The port's ParallelRouter against the JAX package's, on the CPU.

Three worker threads over the three partitions of the transaction topic,
sharing one coalescing batcher, budget, breaker and engine, in each
package, on the same records: every transaction is routed exactly once,
each partition's transactions start in their produce order (per process:
a batch starts each rule's group in one call), and the routes
(transaction id -> process) are equal. The group-wide pause holds every
worker: nothing is consumed while it holds, and all of it after resume.
"""

import binascii
import time

import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.process.clock import ManualClock as RefClock
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu.router.parallel import ParallelRouter as RefParallel
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import Dataset, iter_transactions
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.process.clock import ManualClock
from ccfd_tpu_torch.process.fraud import build_engine
from ccfd_tpu_torch.router.parallel import ParallelRouter
from tests.torch_helpers import mlp_tree

N = 3000


@pytest.fixture(scope="module")
def data():
    ds = kaggle_surrogate(n=N, seed=8)
    tree = mlp_tree(ds.X, hidden=32, seed=6)
    score = RefScorer(model_name="mlp", params=tree, batch_sizes=(16,), host_tier_rows=0,
                      use_fused=False).host_score
    return list(iter_transactions(Dataset(X=ds.X, y=ds.y))), score


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.01)
    return pred()


def _run(side, txs, score):
    if side == "ref":
        broker_t, reg_t, clock_t, build, par_t, cfg_t = (
            RefBroker, RefRegistry, RefClock, ref_build_engine, RefParallel, RefConfig)
    else:
        broker_t, reg_t, clock_t, build, par_t, cfg_t = (
            Broker, Registry, ManualClock, build_engine, ParallelRouter, Config)
    cfg = cfg_t(batch_deadline_ms=2.0, customer_reply_timeout_s=30.0)
    broker = broker_t()
    engine = build(cfg, broker, reg_t(), clock_t())
    reg = reg_t()
    router = par_t(cfg, broker, score, engine, registry=reg, workers=0, max_batch=256,
                   host_score_fn=score, degrade=True)
    assert router.n_workers == 3
    incoming = reg.counter("transaction_incoming_total")
    router.start(poll_timeout_s=0.01)
    try:
        half = N // 2
        broker.produce_batch(cfg.kafka_topic, txs[:half], [t["id"] for t in txs[:half]])
        assert _wait(lambda: incoming.value() >= half)
        assert router.pause(timeout_s=10.0)
        try:
            broker.produce_batch(cfg.kafka_topic, txs[half:], [t["id"] for t in txs[half:]])
            time.sleep(0.2)
            held = incoming.value()
        finally:
            router.resume()
        assert _wait(lambda: incoming.value() >= N)
        assert _wait(lambda: reg.counter("transaction_outgoing_total").total() >= N)
    finally:
        router.stop()
        time.sleep(0.1)
        router.close()
    pid_of = {}
    routes = {}
    for inst in engine.instances():
        if "proba" in inst.vars:
            tid = inst.vars["transaction"]["id"]
            assert tid not in routes, f"transaction {tid} routed twice"
            routes[tid] = inst.definition.id
            pid_of[tid] = inst.pid
    workers = [reg.counter("router_worker_batches_total").value({"worker": str(i)})
               for i in range(3)]
    coalesced = reg.counter("router_coalesced_dispatches_total").value()
    return routes, pid_of, held, workers, coalesced, reg


def test_parallel_router_routes_as_the_reference(data):
    txs, score = data
    want = _run("ref", txs, score)
    got = _run("port", txs, score)
    routes, pid_of, held, workers, coalesced, reg = got
    assert len(routes) == N and routes == want[0]
    assert sorted(routes.values()) == sorted(want[0].values())
    assert held == N // 2  # nothing consumed while the group was paused
    assert all(w > 0 for w in workers)
    assert 0 < coalesced <= sum(workers)
    assert reg.counter("router_shed_total").value() == 0
    assert reg.counter("router_degraded_total").total() == 0
    # within each partition, each process's starts follow the produce order
    # (a batch starts its fraud group and its standard group one call each)
    by_part: dict[tuple, list[int]] = {}
    for t in txs:
        part = binascii.crc32(str(t["id"]).encode()) % 3
        by_part.setdefault((part, routes[t["id"]]), []).append(pid_of[t["id"]])
    assert len(by_part) == 6
    for key, pids in by_part.items():
        assert pids == sorted(pids), key


def test_parallel_router_step_and_facade():
    """The synchronous step() across workers, the facade's engine and the
    shared budget bound (N workers share one max_inflight)."""
    ds = kaggle_surrogate(n=200, seed=1)
    txs = list(iter_transactions(Dataset(X=ds.X, y=ds.y)))
    cfg = Config(batch_deadline_ms=0.0)
    broker = Broker()
    engine = build_engine(cfg, broker, Registry(), ManualClock())
    score = lambda x: ds.y[: len(x)].astype("float32") * 0.0 + 0.1  # noqa: E731
    router = ParallelRouter(cfg, broker, score, engine, workers=2, max_batch=64,
                            max_inflight=100)
    assert router.engine is engine and router.max_inflight == 100
    assert all(w._budget is router._budget for w in router.workers)
    broker.produce_batch(cfg.kafka_topic, txs, [t["id"] for t in txs])
    total = 0
    while True:
        n = router.step()
        if not n:
            break
        total += n
    assert total == 200
    assert router.registry.counter("transaction_outgoing_total").value(
        {"type": "standard"}) == 200
    router.close()
