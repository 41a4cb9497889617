"""The port's user-task model (process/usertask_model.py) against the
reference's (ccfd_tpu/process/usertask_model.py), on the CPU.

- **Training.** One seeded stream of human completions into both models,
  the port starting from the reference's init (carried across with
  ``params.from_jax_model_params("usertask", ...)``, since the port cannot
  draw JAX's PRNG): after every fit the params agree within 1e-5 (f32
  throughout; only summation order differs) and ``predict`` within 1e-5 in
  confidence with the same outcome.
- **The engine's listener.** ``Engine(task_listener=)`` fires once per human
  ``complete_task``, after the audit flush, never on an auto-close; a
  listener's exception is swallowed; the same cold / trained / auto-close
  sequence as the reference's engine.
- **State files.** Each package loads the other's file (the reference's npz
  keys in the checksummed artifact) and serves the same params.
"""

import numpy as np
import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.process.clock import ManualClock as RefClock
from ccfd_tpu.process.engine import Task as RefTask
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu.process.usertask_model import OnlineUserTaskModel as RefModel
from ccfd_tpu.process.usertask_model import task_row as ref_task_row
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.params import from_jax_model_params
from ccfd_tpu_torch.process.clock import ManualClock
from ccfd_tpu_torch.process.engine import Task
from ccfd_tpu_torch.process.fraud import build_engine
from ccfd_tpu_torch.process.usertask_model import (
    NUM_TASK_FEATURES,
    PARAM_KEYS,
    OnlineUserTaskModel,
    task_row,
)
from tests import torch_helpers  # noqa: F401  (one intra-op thread)

TOL = 1e-5


def _task(cls, amount, v17, proba, outcome=None, task_id=1):
    t = cls(task_id=task_id, pid=task_id, name="fraud-investigation",
            vars={"transaction": {"Amount": amount, "V17": v17, "Time": 10.0 * task_id},
                  "proba": proba})
    if outcome is not None:
        t.status = "completed"
        t.outcome = outcome
    return t


def _stream(n, seed=3):
    rng = np.random.default_rng(seed)
    for i in range(n):
        amount = float(rng.uniform(0, 2000))
        v17 = float(rng.normal())
        proba = float(rng.uniform())
        # investigators: fraud iff a large amount or a very negative V17,
        # with 10% noise
        verdict = (amount > 1000 or v17 < -1.0) != (rng.uniform() < 0.1)
        yield i, amount, v17, proba, verdict


def _ref_params(m: RefModel) -> dict:
    return {k: np.asarray(v) for k, v in m._params.items()}


def _pair(**kw):
    ref = RefModel(warmup=False, **kw)
    port = OnlineUserTaskModel(warmup=False, device="cpu", **kw)
    port.set_params(from_jax_model_params("usertask", _ref_params(ref)))
    return ref, port


def _assert_params_close(ref: RefModel, port: OnlineUserTaskModel) -> None:
    got, want = port.params, _ref_params(ref)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)


def test_task_row_matches_the_reference():
    for vars_ in ({"transaction": {"Amount": 12.5, "V3": -1.0}, "proba": 0.25},
                  {"Amount": 77.0, "proba": 0.4}):
        t = Task(task_id=1, pid=1, name="x", vars=vars_)
        r = RefTask(task_id=1, pid=1, name="x", vars=vars_)
        np.testing.assert_array_equal(task_row(t), ref_task_row(r))
    assert task_row(t).shape == (1, NUM_TASK_FEATURES)


@pytest.mark.parametrize("min_examples,fit_every,n", [(32, 8, 120), (8, 4, 61)])
def test_same_stream_gives_the_references_params_and_predictions(min_examples, fit_every, n):
    ref, port = _pair(min_examples=min_examples, fit_every=fit_every)
    probes = [_task(Task, a, v, p, task_id=900 + j)
              for j, (a, v, p) in enumerate([(1900.0, 0.1, 0.5), (50.0, -2.0, 0.9),
                                             (700.0, 0.3, 0.2)])]
    ref_probes = [_task(RefTask, t.vars["transaction"]["Amount"],
                        t.vars["transaction"]["V17"], t.vars["proba"], task_id=t.task_id)
                  for t in probes]
    for i, amount, v17, proba, verdict in _stream(n):
        ref.observe(_task(RefTask, amount, v17, proba, verdict, i))
        port.observe(_task(Task, amount, v17, proba, verdict, i))
        assert port.trained == ref.trained and port.n_examples == ref.n_examples
        if ref.trained:  # after every fit (and between fits) the same params
            assert port.last_loss == pytest.approx(ref.last_loss, abs=TOL)
            _assert_params_close(ref, port)
        for t, rt in zip(probes, ref_probes):
            (o, c), (ro, rc) = port.predict(t), ref.predict(rt)
            if ro is None:
                assert o is None and c == 0.0
            else:
                assert c == pytest.approx(rc, abs=TOL)
                if abs(rc - 0.5) > TOL:
                    assert o == ro
    assert ref.trained and port.trained
    _assert_params_close(ref, port)


def test_cold_start_and_open_tasks():
    m = OnlineUserTaskModel(min_examples=8, warmup=False, device="cpu")
    assert m.predict(_task(Task, 5000.0, 0.0, 0.9)) == (None, 0.0)
    m.observe(_task(Task, 100.0, 0.0, 0.9))  # still open: not observed
    assert m.n_examples == 0 and not m.trained


def test_warmup_runs_every_bucket_and_joins():
    m = OnlineUserTaskModel(min_examples=4, buffer_size=16, device="cpu")
    m.warmup_join(timeout=30.0)
    assert not m._warmup_thread.is_alive()
    assert not m.trained  # the warm epochs never publish


def _engine_pair(confidence_threshold):
    kw = dict(customer_reply_timeout_s=1.0, low_amount_threshold=10.0,
              low_proba_threshold=0.01, confidence_threshold=confidence_threshold)
    ref_model, port_model = _pair(min_examples=16, fit_every=4)
    ref_clock, clock = RefClock(), ManualClock()
    ref_engine = ref_build_engine(RefConfig(**kw), RefBroker(), RefRegistry(), ref_clock,
                                  prediction_service=ref_model,
                                  task_listener=ref_model.observe)
    seen: list = []

    def listener(t):
        seen.append((t.task_id, t.status))
        port_model.observe(t)

    engine = build_engine(Config(**kw), Broker(), Registry(), clock,
                          prediction_service=port_model, task_listener=listener)
    return (ref_engine, ref_clock, ref_model), (engine, clock, port_model), seen


@pytest.mark.parametrize("threshold", [0.9, 1.1])
def test_engine_listener_fires_on_human_completions_only(threshold):
    """Both engines run one stream: cold tasks stay open and humans decide;
    once trained, clear cases auto-close (threshold 0.9) or only pre-fill
    (1.1). The port's listener fires once per human completion and never on
    an auto-close; statuses, suggestions and confidences equal the
    reference's."""
    (re_, rc, rm), (pe, pc, pm), seen = _engine_pair(threshold)
    humans = 0
    for i, amount, v17, proba, verdict in _stream(40, seed=5):
        tx = {"transaction": {"id": i, "Amount": amount, "V17": v17}, "proba": 0.99,
              "customer_id": i}
        rp, pp = re_.start_process("fraud", dict(tx)), pe.start_process("fraud", dict(tx))
        rc.advance(1.1)
        pc.advance(1.1)
        rt = [t for t in re_.tasks("open") if t.pid == rp]
        pt = [t for t in pe.tasks("open") if t.pid == pp]
        assert len(rt) == len(pt)
        ri, pi = re_.instance(rp), pe.instance(pp)
        assert pi.status == ri.status
        assert pi.vars.get("task_auto_completed") == ri.vars.get("task_auto_completed")
        if rt:
            assert pt[0].suggested_outcome == rt[0].suggested_outcome
            if rt[0].prediction_confidence is None:
                assert pt[0].prediction_confidence is None
            else:
                assert pt[0].prediction_confidence == pytest.approx(
                    rt[0].prediction_confidence, abs=TOL)
            re_.complete_task(rt[0].task_id, verdict)
            pe.complete_task(pt[0].task_id, verdict)
            humans += 1
            assert seen[-1] == (pt[0].task_id, "completed")
    assert len(seen) == humans == pm.n_examples == rm.n_examples
    assert pm.trained and rm.trained
    if threshold < 1.0:
        assert humans < 40  # some tasks auto-closed and were not observed


def test_a_failing_listener_does_not_fail_the_completion():
    cfg = Config(customer_reply_timeout_s=1.0, low_amount_threshold=10.0,
                 low_proba_threshold=0.01)
    clock = ManualClock()
    calls = []

    def boom(t):
        calls.append(t.task_id)
        raise RuntimeError("bad observer")

    engine = build_engine(cfg, Broker(), Registry(), clock, task_listener=boom)
    pid = engine.start_process("fraud", {"transaction": {"id": 1, "Amount": 500.0},
                                         "proba": 0.99, "customer_id": 1})
    clock.advance(1.1)
    (t,) = engine.tasks("open")
    engine.complete_task(t.task_id, True)
    assert calls == [t.task_id]
    assert engine.instance(pid).status == "cancelled"


def _trained_pair(tmp_path):
    ref, port = _pair(min_examples=16, fit_every=4)
    for i, amount, v17, proba, verdict in _stream(30, seed=9):
        ref.observe(_task(RefTask, amount, v17, proba, verdict, i))
        port.observe(_task(Task, amount, v17, proba, verdict, i))
    return ref, port


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_files_load_across_packages(tmp_path, writer):
    ref, port = _trained_pair(tmp_path)
    path = str(tmp_path / "usertask.npz")
    (ref if writer == "reference" else port).save(path)
    ref2 = RefModel(warmup=False)
    port2 = OnlineUserTaskModel(warmup=False, device="cpu")
    ref2.load(path)
    port2.load(path)
    for m in (ref2, port2):
        assert m.trained and m.n_examples == 30
    _assert_params_close(ref2, port2)
    src = ref if writer == "reference" else port
    want = _ref_params(src) if writer == "reference" else src.params
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(port2.params[k], want[k])
    probe = (1500.0, 0.0, 0.5)
    assert port2.predict(_task(Task, *probe))[1] == pytest.approx(
        ref2.predict(_task(RefTask, *probe))[1], abs=TOL)
    # a restored model keeps learning on both sides
    port2.observe(_task(Task, 30.0, 0.0, 0.5, False, 999))
    assert port2.n_examples == 31


def test_from_jax_model_params_carries_the_usertask_tree():
    ref = RefModel(seed=4, warmup=False)
    got = from_jax_model_params("usertask", _ref_params(ref))
    assert set(got) == set(PARAM_KEYS)
    assert all(v.dtype.is_floating_point for v in got.values())
    np.testing.assert_array_equal(got["w"].numpy(), _ref_params(ref)["w"])
