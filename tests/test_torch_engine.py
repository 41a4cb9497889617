"""The port's process engine and fraud processes (ccfd_tpu_torch/process/)
against the JAX package's (ccfd_tpu/process/): both engines on a
``ManualClock``, driven by the same starts, signals, task completions and
clock advances, give the same instances, tasks, KIE amount histograms,
process counters and bus records."""

import numpy as np
import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.process.clock import ManualClock as RefClock
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.process import dmn
from ccfd_tpu_torch.process.clock import ManualClock, RealClock
from ccfd_tpu_torch.process.fraud import CUSTOMER_RESPONSE_SIGNAL, build_engine

HISTS = ("fraud_approved_amount", "fraud_rejected_amount", "fraud_approved_low_amount",
         "fraud_investigation_amount")
KNOBS = dict(customer_reply_timeout_s=30.0, low_amount_threshold=200.0,
             low_proba_threshold=0.75, confidence_threshold=0.9)


class Predict:
    """A seeded stand-in for the prediction service: proba from the
    transaction's Amount, so some tasks auto-complete and some stay open."""

    def predict(self, task):
        amount = float(task.vars["transaction"]["Amount"])
        p = min(amount / 1000.0, 1.0)
        return p >= 0.5, max(p, 1.0 - p)


def _drive(pkg: str) -> dict:
    if pkg == "ref":
        cfg, broker, reg, clock = RefConfig(**KNOBS), RefBroker(), RefRegistry(), RefClock()
        engine = ref_build_engine(cfg, broker, reg, clock, prediction_service=Predict())
    else:
        cfg, broker, reg, clock = Config(**KNOBS), Broker(), Registry(), ManualClock()
        engine = build_engine(cfg, broker, reg, clock, prediction_service=Predict())
    rng = np.random.default_rng(0)
    amounts = np.round(rng.lognormal(4.0, 1.5, size=120), 2).tolist()
    probas = rng.random(120).tolist()
    txs = [{"id": i, "Amount": a} for i, a in enumerate(amounts)]
    fraud = engine.start_process_batch(
        "fraud", [{"transaction": t, "proba": p, "customer_id": t["id"]}
                  for t, p in zip(txs[:80], probas[:80])], copy_vars=False)
    standard = engine.start_process_batch(
        "standard", [{"transaction": t, "proba": p} for t, p in zip(txs[80:], probas[80:])])
    single = engine.start_process("fraud", {"transaction": {"id": 999, "Amount": 50.0},
                                            "proba": 0.6})
    clock.advance(10.0)
    # replies to the first 40: approve the even ones, reject the odd ones
    consumed = [engine.signal(pid, CUSTOMER_RESPONSE_SIGNAL, {"approved": pid % 2 == 0})
                for pid in fraud[:40]]
    consumed.append(engine.signal(fraud[0], CUSTOMER_RESPONSE_SIGNAL, {}))  # no longer waiting
    consumed.append(engine.signal(standard[0], CUSTOMER_RESPONSE_SIGNAL, {}))
    clock.advance(25.0)  # the rest time out into the DMN
    open_tasks = sorted(engine.tasks(), key=lambda t: t.task_id)
    for t in open_tasks[::2]:
        engine.complete_task(t.task_id, bool(t.task_id % 3 == 0))
    with pytest.raises(ValueError):
        engine.complete_task(open_tasks[0].task_id, True)
    clock.advance(100.0)
    hist = {h: (reg.histogram(h).count(), reg.histogram(h).sum()) for h in HISTS}
    started = reg.counter("process_instances_started_total")
    completed = reg.counter("process_instances_completed_total")
    notes = broker.consumer("t", (cfg.customer_notification_topic,)).poll(10_000)
    labels = broker.consumer("t", (cfg.labels_topic,)).poll(10_000)
    return {
        "pids": (fraud, standard, single),
        "consumed": consumed,
        "instances": sorted((i.pid, i.definition.id, i.status, i.node, tuple(i.history),
                             i.vars.get("resolution"), i.vars.get("task_outcome"))
                            for i in engine.instances()),
        "tasks": [(t.task_id, t.pid, t.name, t.status, t.outcome, t.suggested_outcome,
                   t.prediction_confidence)
                  for t in sorted(engine.tasks("open") + engine.tasks("completed"),
                                  key=lambda t: t.task_id)],
        "hist": hist,
        "started": {p: started.value({"process": p}) for p in ("fraud", "standard")},
        "completed": {(p, s): completed.value({"process": p, "status": s})
                      for p in ("fraud", "standard") for s in ("completed", "cancelled")},
        "notifications": [(r.key, r.value["process_id"], r.value["customer_id"]) for r in notes],
        "labels": sorted((r.value["process_id"], r.value["label"], r.value["source"])
                         for r in labels),
        "definitions": engine.definitions(),
    }


def test_both_engines_take_the_same_path():
    want, got = _drive("ref"), _drive("port")
    for k in want:
        assert got[k] == want[k], k
    # every branch of the fraud process was taken
    assert all(n for n, _ in got["hist"].values())
    assert any(t[3] == "open" for t in got["tasks"])


def test_start_process_batch_isolates_a_poisoned_slot():
    engine = build_engine(Config(), Broker(), Registry(), ManualClock())
    pids = engine.start_process_batch("standard", [{"transaction": {}}, 7, {"transaction": {}}])
    assert pids[0] is not None and pids[1] is None and pids[2] is not None


def test_completed_instances_are_evicted_past_the_retention():
    from ccfd_tpu_torch.process.engine import Engine, EndNode, ProcessDefinition

    e = Engine(clock=ManualClock(), completed_retention=5)
    e.register(ProcessDefinition("p", "end", {"end": EndNode("end")}))
    pids = e.start_process_batch("p", [{} for _ in range(12)])
    assert sorted(i.pid for i in e.instances()) == pids[-5:]


def test_dmn_table_first_match_and_default():
    t = dmn.DecisionTable("t", [dmn.Rule({"a": ("<", 2), "b": ("in", (1, 2))}, "x"),
                                dmn.Rule({"a": lambda v: v > 10}, "y")], default="z")
    assert [t.evaluate({"a": a, "b": b}) for a, b in ((1, 1), (1, 3), (11, 0), (5, 5))] == [
        "x", "z", "y", "z"]


def test_real_clock_fires_timers_and_cancels():
    import threading

    clock = RealClock()
    fired = threading.Event()
    h = clock.call_later(10.0, lambda: fired.set())
    h.cancel()
    done = threading.Event()
    clock.call_later(0.01, done.set)
    assert done.wait(5.0) and not fired.is_set()
