"""The port's investigator simulation (process/investigator.py) against the
reference's: the same seeded ``default_rng`` draws give the same verdicts
on the same queue, with the same counter and gauge names and values; the
pre-fill trust rule, the rate limit, a dead engine mid-pass, and the
closed loop into the user-task model; the ``tasks`` and ``investigate``
commands against an ``engine`` role's REST.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu.process.investigator import InvestigatorService as RefInvestigator
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.process.fraud import build_engine
from ccfd_tpu_torch.process.investigator import InvestigatorService
from tests import torch_helpers  # noqa: F401  (one intra-op thread)

KW = dict(confidence_threshold=1.0, customer_reply_timeout_s=0.05)


def _flagged(engine, n: int):
    for i in range(n):
        engine.start_process("fraud", {"transaction": {"Amount": 500.0 + i, "id": i},
                                       "proba": 0.99, "customer_id": i})
    deadline = time.time() + 10
    while len(engine.tasks("open")) < n and time.time() < deadline:
        time.sleep(0.02)
    assert len(engine.tasks("open")) == n
    return engine


def _pair(n: int, ref_listener=None, listener=None):
    ref = _flagged(ref_build_engine(RefConfig(**KW), RefBroker(), RefRegistry(),
                                    task_listener=ref_listener), n)
    port = _flagged(build_engine(Config(**KW), Broker(), Registry(),
                                 task_listener=listener), n)
    return ref, port


def _outcomes(engine) -> list:
    return [(t.task_id, t.outcome) for t in sorted(engine.tasks("completed"),
                                                   key=lambda t: t.task_id)]


@pytest.mark.parametrize("seed,fraud_rate,batch", [(0, 0.05, 100), (3, 0.5, 100),
                                                   (7, 0.3, 5)])
def test_same_seed_same_verdicts_and_counters(seed, fraud_rate, batch):
    ref_engine, engine = _pair(24)
    ref = RefInvestigator(ref_engine, RefRegistry(), rate_per_s=0.0,
                          base_fraud_rate=fraud_rate, seed=seed, batch=batch)
    port = InvestigatorService(engine, Registry(), rate_per_s=0.0,
                               base_fraud_rate=fraud_rate, seed=seed, batch=batch)
    while True:
        a, b = ref.work_once(), port.work_once()
        assert a == b
        if a == 0:
            break
    assert port.completed == ref.completed == 24
    assert _outcomes(engine) == _outcomes(ref_engine)
    for name in ("investigator_tasks_completed_total",):
        for outcome in ("approved", "cancelled"):
            assert port.registry.counter(name).value({"outcome": outcome}) == \
                ref.registry.counter(name).value({"outcome": outcome})
    assert port.registry.gauge("investigator_queue_depth").value() == \
        ref.registry.gauge("investigator_queue_depth").value()


@pytest.mark.parametrize("conf,suggested", [(0.95, True), (0.95, False), (0.5, True),
                                            (None, None)])
def test_decide_trusts_a_confident_prefill(conf, suggested):
    task = {"task_id": 1, "prediction_confidence": conf, "suggested_outcome": suggested}
    ref = RefInvestigator(None, base_fraud_rate=0.5, seed=1)
    port = InvestigatorService(None, base_fraud_rate=0.5, seed=1)
    assert [port.decide(task) for _ in range(20)] == [ref.decide(task) for _ in range(20)]


def test_rate_limit_bounds_completions():
    _ref, engine = _pair(6)
    svc = InvestigatorService(engine, rate_per_s=20.0, base_fraud_rate=0.0)
    t0 = time.perf_counter()
    assert svc.work_once() == 6
    assert time.perf_counter() - t0 >= 5 / 20.0


def test_a_dead_engine_mid_pass_completes_nothing():
    _ref, engine = _pair(4)
    svc = InvestigatorService(engine, rate_per_s=0.0, base_fraud_rate=0.0)
    engine.shutdown()
    assert svc.work_once() == 0


def test_run_stop_reset_and_the_loop_into_the_usertask_model():
    from ccfd_tpu_torch.process.usertask_model import OnlineUserTaskModel

    model = OnlineUserTaskModel(min_examples=4, warmup=False, device="cpu")
    _ref, engine = _pair(6, listener=model.observe)
    svc = InvestigatorService(engine, rate_per_s=0.0, base_fraud_rate=0.5, seed=3)
    th = threading.Thread(target=svc.run, kwargs={"poll_timeout_s": 0.02})
    th.start()
    deadline = time.time() + 10
    while svc.completed < 6 and time.time() < deadline:
        time.sleep(0.02)
    svc.stop()
    th.join(5)
    assert svc.completed == 6 and model.n_examples == 6 and model.trained
    svc.reset()
    assert not svc._stop.is_set()


def test_tasks_and_investigate_commands_against_the_engine_role(capsys, monkeypatch):
    """``tasks`` lists the open tasks and completes one by the investigator's
    words; ``investigate`` drains the rest over the same REST."""
    from ccfd_tpu_torch.cli import main
    from ccfd_tpu_torch.process.server import EngineServer

    engine = _flagged(build_engine(Config(**KW), Broker(), Registry()), 5)
    srv = EngineServer(engine)
    port = srv.start("127.0.0.1", 0)
    url = f"http://127.0.0.1:{port}"
    try:
        assert main(["tasks", "--engine-url", url]) == 0
        listed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert listed["status"] == "open" and listed["count"] == 5
        first = listed["tasks"][0]["task_id"]
        assert main(["tasks", "--engine-url", url, "--complete", str(first),
                     "--outcome", "approved"]) == 0
        done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert done == {"completed": first, "outcome": "approved", "is_fraud": False}
        assert engine.task(first).outcome is False
        assert main(["tasks", "--engine-url", url, "--complete", str(first)]) == 2
        assert main(["tasks", "--engine-url", "inproc://engine"]) == 2

        # investigate: SIGTERM-free stop through the service's own loop
        from ccfd_tpu_torch.process import investigator as inv_mod

        services = []
        real = inv_mod.InvestigatorService

        class Recording(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                services.append(self)

            def run(self, poll_timeout_s: float = 0.2) -> None:
                while self.work_once() or len(self.engine.tasks("open")):
                    pass

        monkeypatch.setattr(inv_mod, "InvestigatorService", Recording)
        assert main(["investigate", "--engine-url", url, "--rate", "0",
                     "--metrics-port", "0", "--seed", "2"]) == 0
        assert services[0].completed == 4
        assert engine.tasks("open") == []
    finally:
        srv.stop()
