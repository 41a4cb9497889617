"""The port's decision pipeline against the JAX package's, on the CPU.

- ``decode_records`` on dict, CSV, mixed, poison-pill and embedded-newline
  batches: the same matrix, transaction dicts and malformed count.
- The pipeline producer -> bus -> router -> Scorer -> rules -> engine ->
  notification service, built once from each package on the same records
  and params (the reference's Scorer on its Pallas kernel in interpret
  mode; the port's ``cli.build_pipeline`` with ``device="cpu"``), driven by
  synchronous ``step()`` calls and a ``ManualClock``: the same process for
  every transaction id, equal business counters and equal KIE histogram
  counts, staged and with the decision plane, on both wires.
- ``python -m ccfd_tpu_torch demo --device cpu`` prints the summary.
"""

import dataclasses
import json
import types
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.notify.service import NotificationService as RefNotify
from ccfd_tpu.process.clock import ManualClock as RefClock
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu.process.prediction import ScorerPredictionService as RefPrediction
from ccfd_tpu.producer.producer import Producer as RefProducer
from ccfd_tpu.router import router as ref_router
from ccfd_tpu.router.rules import default_rules as ref_default_rules
from ccfd_tpu.serving.fused import FusedDecisionScorer as RefPlane
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu_torch.cli import build_pipeline, main
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES, Dataset, iter_transactions
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.process.clock import ManualClock
from ccfd_tpu_torch.router import router as port_router
from tests.torch_helpers import mlp_tree

BUCKETS = (16, 128)
N = 600


class Rec(NamedTuple):
    value: Any
    key: Any = None


def _csv(row) -> bytes:
    return ",".join(repr(float(v)) for v in row).encode()


@pytest.fixture(scope="module")
def data():
    ds = kaggle_surrogate(n=2000, seed=11)
    tree = mlp_tree(ds.X, hidden=64, seed=3)
    return Dataset(X=ds.X[:N], y=ds.y[:N]), tree


def _batches(X):
    txs = list(iter_transactions(Dataset(X=X[:40], y=np.zeros(40, np.int32))))
    broken = dict(txs[3])
    del broken["V7"]
    bad_value = dict(txs[4], V2="oops", Amount=None)
    return {
        "dict": [Rec(t, t["id"]) for t in txs],
        "csv": [Rec(_csv(X[i]), i) for i in range(40)],
        "csv_str": [Rec(_csv(X[i]).decode(), i) for i in range(5)],
        "mixed": [Rec(txs[0], 0), Rec(_csv(X[1]), 1), Rec(types.MappingProxyType(txs[2]), 2),
                  Rec(_csv(X[3]).decode(), 3), Rec(txs[4], 4)],
        "poison": [Rec(None), Rec(42), Rec([1, 2]), Rec(broken, 3), Rec(bad_value, 4),
                   Rec(b"1.0,2.0", 5), Rec(b"not,a,number" + b",0" * 27, 6), Rec(txs[5], 5)],
        "newline": [Rec(_csv(X[0]) + b"\n" + _csv(X[1]), 0), Rec(_csv(X[2]), 2),
                    Rec(b"\n" + _csv(X[3]), 3), Rec(txs[9], 9)],
        "empty": [],
    }


@pytest.mark.parametrize("which", ["dict", "csv", "csv_str", "mixed", "poison", "newline",
                                   "empty"])
def test_decode_records_matches_the_reference(data, which):
    recs = _batches(data[0].X)[which]
    want_x, want_txs, want_bad = ref_router.decode_records(recs)
    x, txs, bad = port_router.decode_records(recs)
    assert x.dtype == np.float32 and x.shape == (len(recs), len(FEATURE_NAMES))
    np.testing.assert_array_equal(x, want_x)
    assert [dict(t) for t in txs] == [dict(t) for t in want_txs]
    assert bad == want_bad


def test_decode_features_and_csv_edge_cases():
    x, bad = port_router.decode_features([{"Time": 1.0, "V1": 2.0, "Amount": 3.0}, {"V28": 9.0}])
    assert bad == 0 and x[0, 0] == 1.0 and x[0, 1] == 2.0 and x[0, 29] == 3.0 and x[1, 28] == 9.0
    out, bad = port_router.decode_csv(b"")
    assert out.shape == (0, 30) and bad == 0


def _ref_pipeline(cfg, ds, tree, wire, plane, ref_scorer):
    broker, clock = RefBroker(), RefClock()
    reg_r, reg_k, reg_n = RefRegistry(), RefRegistry(), RefRegistry()
    engine = ref_build_engine(cfg, broker, reg_k, clock,
                              prediction_service=RefPrediction(ref_scorer.score))
    rules = ref_default_rules(cfg.fraud_threshold)
    decision = None
    if plane:
        decision = RefPlane(ref_scorer, rules, registry=reg_r)
        decision.warmup()
    router = ref_router.Router(cfg, broker, ref_scorer.score, engine, reg_r, rules=rules,
                               decision_fn=decision)
    notify = RefNotify(cfg, broker, reg_n, seed=1)
    RefProducer(cfg, broker, ds).run(limit=N, wire_format=wire)
    return types.SimpleNamespace(router=router, notify=notify, clock=clock, engine=engine,
                                 reg_router=reg_r, reg_kie=reg_k, decision=decision)


def _drive(pipe, clock, cfg):
    pipe.router.step()
    pipe.notify.step()
    pipe.router.step()  # customer responses become signals
    clock.advance(cfg.customer_reply_timeout_s + 1.0)  # silent customers: the DMN


def _outcome(pipe, wire):
    rr, kie = pipe.reg_router, pipe.reg_kie
    out, notif_in, rule = (rr.counter("transaction_outgoing_total"),
                           rr.counter("notifications_incoming_total"),
                           rr.counter("router_rule_fired_total"))
    routes = {}
    for inst in pipe.engine.instances():
        tx = inst.vars.get("transaction", {})
        if "proba" in inst.vars:  # a routed transaction (not a test start)
            routes[tx.get("id")] = inst.definition.id
    return {
        "routes": routes,
        "counters": {
            "in": rr.counter("transaction_incoming_total").value(),
            "fraud": out.value({"type": "fraud"}),
            "standard": out.value({"type": "standard"}),
            "notifications": rr.counter("notifications_outgoing_total").value(),
            "approved": notif_in.value({"response": "approved"}),
            "non_approved": notif_in.value({"response": "non_approved"}),
            "rule_fraud": rule.value({"rule": "fraud"}),
            "rule_standard": rule.value({"rule": "standard"}),
            "score_errors": rr.counter("router_score_errors_total").value(),
            "decode_errors": rr.counter("transaction_decode_errors_total").value(),
        },
        "kie": {h: kie.histogram(h).count() for h in (
            "fraud_approved_amount", "fraud_rejected_amount", "fraud_approved_low_amount",
            "fraud_investigation_amount")},
        "open_tasks": len(pipe.engine.tasks()),
    }


@pytest.fixture(scope="module")
def ref_scorer(data):
    sc = RefScorer(model_name="mlp", params=data[1], batch_sizes=BUCKETS, host_tier_rows=0,
                   use_fused=True)  # the Pallas kernel, in interpret mode on the CPU
    sc.warmup()
    return sc


@pytest.mark.parametrize("plane", [False, True], ids=["staged", "plane"])
@pytest.mark.parametrize("wire", ["dict", "csv"])
def test_both_pipelines_route_every_transaction_alike(data, ref_scorer, wire, plane):
    ds, tree = data
    knobs = dict(customer_reply_timeout_s=30.0, batch_sizes=BUCKETS)
    ref_cfg = RefConfig(customer_reply_timeout_s=30.0, batch_sizes=BUCKETS)
    ref = _ref_pipeline(ref_cfg, ds, tree, wire, plane, ref_scorer)
    cfg = Config(fused_decision=plane, **knobs)
    port = build_pipeline(cfg, ds, device="cpu", params=tree, clock=ManualClock(), seed=1)
    assert (port.decision is not None) == plane
    assert port.producer.run(limit=N, wire_format=wire) == N
    _drive(ref, ref.clock, ref_cfg)
    _drive(port, port.engine.clock, cfg)
    want, got = _outcome(ref, wire), _outcome(port, wire)
    assert len(got["routes"]) == N
    assert got["routes"] == want["routes"]
    assert got["counters"] == want["counters"]
    assert got["kie"] == want["kie"]
    assert got["open_tasks"] == want["open_tasks"]
    # the pipeline reached both processes and every resolution
    c = got["counters"]
    assert c["in"] == N and c["fraud"] + c["standard"] == N and c["fraud"] and c["standard"]
    assert all(got["kie"].values())
    if plane:
        assert port.reg_router.counter("fused_decision_dispatches_total").value() == N
        assert port.decision.staged_fallbacks == 0


def test_pipeline_refuses_the_knobs_it_does_not_port(data):
    ds, tree = data
    # the fault plans (A6; only the operator installs them) and the
    # lifecycle's lineage store (A12) are ported: their entries now pair
    # the knob with one still refused
    for env in ({"CCFD_STORAGE_FAULTS": "bitrot", "CCFD_HOST_TIER_ROWS": "64"},
                {"CCFD_LIFECYCLE_DIR": "/tmp/lc", "CCFD_HOST_TIER_ROWS": "64"},
                {"CCFD_DEVICE_FAULTS": "oom", "CCFD_INLINE_ROWS": "64"}):
        with pytest.raises(NotImplementedError, match=list(env)[-1]):
            build_pipeline(Config.from_env(env), ds, device="cpu", params=tree)


def test_pipelined_run_loop_drops_and_counts_a_failing_batch(data):
    """A scorer failure in the run loop drops that batch, counted in
    router_score_errors_total; the loop keeps routing."""
    ds, tree = data
    pipe = build_pipeline(Config(batch_sizes=BUCKETS, batch_deadline_ms=0.0), ds,
                          device="cpu", params=tree)
    real = pipe.router.score
    calls = []

    def flaky(x):
        calls.append(len(x))
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return real(x)

    pipe.router.score = flaky
    pipe.producer.run(limit=100)
    pipe.start(poll_timeout_s=0.01)
    try:
        rr = pipe.reg_router
        import time

        deadline = time.monotonic() + 30
        # the loop counts a batch in before its scoring thread calls the
        # scorer: wait for both
        while time.monotonic() < deadline and (
                rr.counter("transaction_incoming_total").value() < 100 or not calls):
            time.sleep(0.01)
        first = calls[0]
        pipe.producer.run(limit=50)
        while time.monotonic() < deadline and (
                rr.counter("transaction_outgoing_total").total() < 150 - first):
            time.sleep(0.01)
    finally:
        pipe.stop()
    assert rr.counter("router_score_errors_total").value() == first
    assert rr.counter("transaction_outgoing_total").total() == 150 - first


def test_demo_prints_the_summary_on_the_cpu(capsys):
    assert main(["demo", "--device", "cpu", "--transactions", "300", "--reply-timeout", "0.2",
                 "--drain-s", "20"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(doc) == {"transactions", "fraud_routed", "standard_routed", "notifications",
                        "approved_amount_n", "rejected_amount_n", "low_amount_auto_n",
                        "investigations_n", "open_tasks", "retrain_swaps", "wall_s",
                        "backend"}
    assert doc["transactions"] == 300 and doc["backend"] == "cpu"
    assert doc["fraud_routed"] + doc["standard_routed"] == 300


def test_demo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["demo", "--transactions", "10"])


def test_config_reads_the_pipeline_knobs_as_the_reference():
    env = {"KAFKA_TOPIC": "tx", "CUSTOMER_NOTIFICATION_TOPIC": "out",
           "CUSTOMER_RESPONSE_TOPIC": "in", "topic": "prod", "FRAUD_THRESHOLD": "0.7",
           "CCFD_RULES": "r.json", "CCFD_REPLY_TIMEOUT_S": "5", "CCFD_LOW_AMOUNT": "100",
           "CCFD_LOW_PROBA": "0.6", "CONFIDENCE_THRESHOLD": "0.95",
           "CCFD_FUSED_DECISION": "1", "CCFD_FUSED_DECISION_STRICT": "true",
           "CCFD_LABELS_TOPIC": "labels"}
    got, want = Config.from_env(env), RefConfig.from_env(env)
    for f in ("kafka_topic", "customer_notification_topic", "customer_response_topic",
              "producer_topic", "fraud_threshold", "rules_file", "customer_reply_timeout_s",
              "low_amount_threshold", "low_proba_threshold", "confidence_threshold",
              "fused_decision", "fused_decision_strict", "labels_topic"):
        assert getattr(got, f) == getattr(want, f), f
    d_got, d_want = Config.from_env({}), RefConfig.from_env({})
    for f in ("kafka_topic", "fraud_threshold", "customer_reply_timeout_s",
              "fused_decision", "confidence_threshold", "low_amount_threshold"):
        assert getattr(d_got, f) == getattr(d_want, f), f
    assert dataclasses.replace(d_got).unported() == []


def test_metrics_copy_reads_and_renders_as_the_reference():
    from ccfd_tpu.metrics import prom as ref_prom
    from ccfd_tpu_torch.metrics import prom as port_prom

    assert port_prom.AMOUNT_BUCKETS == ref_prom.AMOUNT_BUCKETS
    regs = []
    for mod in (ref_prom, port_prom):
        r = mod.Registry()
        c = r.counter("transaction_outgoing_total", "starts")
        c.inc(3, labels={"type": "fraud"})
        c.inc(labels={"type": "standard"})
        h = r.histogram("fraud_approved_amount", "amounts", mod.AMOUNT_BUCKETS)
        for v in (0.5, 7.0, 99.0, 20_000.0):
            h.observe(v, exemplar={"trace_id": "t1"})
        d = r.histogram("router_decision_seconds", "latency")
        d.observe_many(np.linspace(0.0001, 3.0, 101))
        r.gauge("g", "gauge").set(2.5, labels={"stage": "router"})
        regs.append((r, c, h, d))
    (rr, rc, rh, rd), (pr, pc, ph, pd) = regs
    assert pc.value({"type": "fraud"}) == rc.value({"type": "fraud"}) == 3
    assert pc.total() == rc.total() == 4 and pc.value() == rc.value() == 0
    assert (ph.count(), ph.sum()) == (rh.count(), rh.sum())
    assert (pd.count(), pd.sum()) == (rd.count(), rd.sum())
    for q in (0.5, 0.9, 0.99):
        assert pd.quantile(q) == rd.quantile(q) and ph.quantile(q) == rh.quantile(q)
    assert sorted(ph.exemplars()) == sorted(rh._exemplars[()]) == [0, 2, 5, 12]
    assert pr.render() == rr.render()


def test_csv_bytes_round_trip_as_the_reference(data):
    from ccfd_tpu.data import ccfd as ref_ccfd
    from ccfd_tpu_torch.data import ccfd

    ds = Dataset(X=data[0].X[:50], y=np.arange(50, dtype=np.int32) % 2)
    blob = ccfd.to_csv_bytes(ds)
    assert blob == ref_ccfd.to_csv_bytes(ref_ccfd.Dataset(X=ds.X, y=ds.y))
    back, want = ccfd.load_csv_bytes(blob, limit=40), ref_ccfd.load_csv_bytes(blob, limit=40)
    np.testing.assert_array_equal(back.X, want.X)
    np.testing.assert_array_equal(back.y, want.y)
    np.testing.assert_array_equal(back.X, ds.X[:40])
    assert list(iter_transactions(back))[:3] == list(ref_ccfd.iter_transactions(want))[:3]
