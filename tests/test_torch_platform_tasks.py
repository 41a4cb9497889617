"""The operator's new branches against the reference's operator, on the CPU:
``scorer.model: seq|seq_q8`` (the history-aware scorer through the
router, its histories in the crash-recovery cut) and the investigator with
``engine.usertask_model`` (the learned user-task model trained by the
investigator's decisions, saved and restored across a bounce).

Both operators run the reference's ``minimal_cr`` (tests/test_platform.py)
on a one-partition bus fed the same records, so each side routes the same
stream in the same order.

- seq (f32): the same router counters and the same history store (keys,
  depths and rows, bit for bit); every served probability within 1e-5 of
  the reference's. seq_q8 (bf16): the same store, and the routes equal
  except on rows whose reference probability lies within 2e-2 of
  FRAUD_THRESHOLD (the seq_q8 bar, tests/test_torch_seq.py).
- An engine failure mid-stream under ``crash_recovery``: after the restore
  and the replay the store equals that of the same records run without the
  failure (no double append), and every transaction starts once.
- investigator + usertask_model (logreg): the same completed tasks with the
  same outcomes and the same investigator counters; the user-task model
  (the port carrying the reference's init) trains on the same decisions to
  params within 1e-5; ``down()`` saves it and ``up()`` restores ``trained``
  and the params.
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.platform.operator import Platform as RefPlatform
from ccfd_tpu.platform.operator import PlatformSpec as RefSpec
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.platform.operator import REFUSED_COMPONENTS, Platform, PlatformSpec
from tests import torch_helpers
from tests.test_platform import minimal_cr

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import export_torch_seq_assets as assets  # noqa: E402

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)
# the blocks the tests' CRs switch off: the parts still refused and (since
# A9, A12 and A14) the lifecycle, the analytics, the replay, the incident
# and the capacity planes, which these tests do not drive
OFF = {name: {"enabled": False}
       for name in (*REFUSED_COMPONENTS, "lifecycle", "analytics", "replay", "incident",
                    "capacity")}
ENV = {"CCFD_BATCH_SIZES": "16,128,1024", "CCFD_NATIVE_FRONT": "0",
       "FRAUD_THRESHOLD": "0.4"}
N = 240
CUSTOMERS = 30


def _records(lo: int, hi: int, seed: int = 0) -> list[dict]:
    from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES, synthetic_dataset

    ds = synthetic_dataset(n=hi, fraud_rate=0.05, seed=seed)
    cust = np.random.default_rng(seed).integers(0, CUSTOMERS, size=hi)
    return [{**{f: float(ds.X[i, j]) for j, f in enumerate(FEATURE_NAMES)},
             "id": i, "customer_id": int(cust[i])} for i in range(lo, hi)]


def _wait(pred, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.02)


def _counters(p) -> dict:
    rr = p.registries["router"]
    out = rr.counter("transaction_outgoing_total")
    return {"incoming": rr.counter("transaction_incoming_total").value(),
            "fraud": out.value({"type": "fraud"}), "standard": out.value({"type": "standard"}),
            "degraded": rr.counter("router_degraded_total").total(),
            "score_errors": rr.counter("router_score_errors_total").value()}


def _store(p) -> list:
    return [(k, f, np.asarray(b).tobytes()) for k, b, f in p.scorer.store.snapshot()["customers"]]


def _seq_run(cls_platform, cls_spec, cls_cfg, model: str, dtype: str, records) -> dict:
    cr = minimal_cr(**OFF, bus={"partitions": 1},
                    scorer={"enabled": True, "model": model, "dtype": dtype,
                            "history_length": 8, "max_customers": 1000})
    kw = {"device": "cpu"} if cls_platform is Platform else {}
    p = cls_platform(cls_spec.from_cr(cr, cfg=cls_cfg.from_env(ENV)), **kw)
    p.up(wait_ready_s=60)
    try:
        cfg = p.cfg
        p.broker.produce_batch(cfg.kafka_topic, records)
        _wait(lambda: _counters(p)["fraud"] + _counters(p)["standard"] >= len(records))
        return {"counters": _counters(p), "store": _store(p),
                "grid": p.scorer.executable_grid()}
    finally:
        p.down()


def _replay_scores(model: str, dtype: str, records) -> tuple[np.ndarray, np.ndarray]:
    """The probabilities each side served, recomputed by a fresh scorer fed
    the same stream in the router's batches of one record at a time."""
    import jax

    from ccfd_tpu.serving.history import SeqScorer as RefSeqScorer
    from ccfd_tpu_torch.params import load_tree
    from ccfd_tpu_torch.platform.operator import SEQ_INIT
    from ccfd_tpu_torch.serving.history import SeqScorer

    ref_p = assets.reference_seq_params()
    port_p = load_tree(SEQ_INIT)
    if model == "seq_q8":
        from ccfd_tpu.ops.seq_quant import quantize_seq as ref_quantize
        from ccfd_tpu_torch.ops.seq_quant import quantize_seq

        ref_p, port_p = jax.tree.map(np.asarray, ref_quantize(ref_p)), quantize_seq(port_p)
    kw = dict(length=8, batch_sizes=(16, 128, 1024), compute_dtype=dtype)
    ref, port = RefSeqScorer(ref_p, **kw), SeqScorer(port_p, device="cpu", **kw)
    x = np.asarray([[r[k] for k in list(r)[:30]] for r in records], np.float32)
    return ref.score_with_ids(records, x), port.score_with_ids(records, x)


@pytest.mark.parametrize("model,dtype", [("seq", "float32"), ("seq_q8", "bfloat16")])
def test_seq_operator_matches_the_reference(model, dtype):
    records = _records(0, N)
    ref = _seq_run(RefPlatform, RefSpec, RefConfig, model, dtype, records)
    port = _seq_run(Platform, PlatformSpec, Config, model, dtype, records)
    assert port["store"] == ref["store"]
    assert len(port["store"]) == CUSTOMERS
    assert port["grid"]["model"] == model and port["grid"]["length"] == 8
    assert sum(e["dispatches"] for e in port["grid"]["grid"]) > 0
    pr, pp = _replay_scores(model, dtype, records)
    tol = 1e-5 if model == "seq" else 2e-2
    np.testing.assert_allclose(pp, pr, rtol=0, atol=tol)
    near = int((np.abs(pr - 0.4) <= tol).sum())
    pc, rc = port["counters"], ref["counters"]
    assert pc["incoming"] == rc["incoming"] == N
    assert pc["degraded"] == rc["degraded"] == 0 and pc["score_errors"] == 0
    assert abs(pc["fraud"] - rc["fraud"]) <= near
    assert pc["fraud"] and pc["standard"]


def _crash_cr(tmp):
    return minimal_cr(**OFF, bus={"partitions": 1, "log_dir": str(tmp / "buslog")},
                      scorer={"enabled": True, "model": "seq", "dtype": "float32",
                              "history_length": 8},
                      engine={"enabled": True, "crash_recovery": True,
                              "checkpoint_interval_s": 0.2,
                              "checkpoint_file": str(tmp / "cut.json")})


@pytest.mark.parametrize("crash", [False, True])
def test_histories_ride_the_crash_cut_without_a_double_append(tmp_path, crash):
    cfg = Config.from_env({**ENV, "FRAUD_THRESHOLD": "2.0"})  # all standard
    records = _records(0, N)
    p = Platform(PlatformSpec.from_cr(_crash_cr(tmp_path), cfg=cfg), device="cpu")
    p.up(wait_ready_s=60)
    try:
        assert "history" in p.recovery._extra_state
        incoming = p.registries["router"].counter("transaction_incoming_total")
        p.broker.produce_batch(cfg.kafka_topic, records[:N // 2])
        _wait(lambda: incoming.value() >= N // 2)
        if crash:
            _wait(lambda: p.recovery.checkpoints > 0)
            old = p.engine
            assert p.supervisor.inject_failure("engine", "test")
            _wait(lambda: p.recovery.restores == 1 and p.engine is not old)
        p.broker.produce_batch(cfg.kafka_topic, records[N // 2:])
        _wait(lambda: p.engine.snapshot()["next_pid"] - 1 == N)
        got = _store(p)
    finally:
        p.down()
    # the same records scored without the engine, in one pass
    from ccfd_tpu_torch.serving.history import HistoryStore

    want = HistoryStore(length=8)
    x = np.asarray([[r[k] for k in list(r)[:30]] for r in records], np.float32)
    _, tok = want.prepare([r["customer_id"] for r in records], x)
    want.commit(tok)
    assert got == [(k, f, np.asarray(b).tobytes())
                   for k, b, f in want.snapshot()["customers"]]


# -- the investigator and the user-task model ---------------------------------

def _ref_init(seed: int = 0) -> dict:
    from ccfd_tpu.process.usertask_model import OnlineUserTaskModel as RefModel

    m = RefModel(seed=seed, warmup=False)
    return {k: np.asarray(v) for k, v in m._params.items()}


@contextlib.contextmanager
def _port_model_from_the_reference_init():
    """The port's OnlineUserTaskModel starting from the reference's init
    (the port cannot draw JAX's PRNG)."""
    from ccfd_tpu_torch.params import from_jax_model_params
    from ccfd_tpu_torch.process import usertask_model as mod

    real = mod.OnlineUserTaskModel

    class Carried(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.set_params(from_jax_model_params("usertask", _ref_init()))

    mod.OnlineUserTaskModel = Carried
    try:
        yield
    finally:
        mod.OnlineUserTaskModel = real


def _tasks_cr(state_file: str) -> dict:
    return minimal_cr(**OFF, bus={"partitions": 1},
                      scorer={"enabled": True, "model": "logreg", "train_steps": 0},
                      engine={"enabled": True, "usertask_model": True,
                              "usertask_min_examples": 6, "usertask_state_file": state_file},
                      # trust nothing: verdicts are the seeded draws alone, in
                      # task order, whatever the model suggested meanwhile
                      investigator={"enabled": True, "rate_per_s": 0.0,
                                    "trust_threshold": 2.0, "base_fraud_rate": 0.3,
                                    "seed": 4})


TASK_ENV = {**ENV, "FRAUD_THRESHOLD": "0.0", "CCFD_REPLY_TIMEOUT_S": "0.05",
            "CCFD_LOW_AMOUNT": "0", "CCFD_LOW_PROBA": "0.0"}


def _tasks_run(cls_platform, cls_spec, cls_cfg, state_file: str, records) -> dict:
    kw = {"device": "cpu"} if cls_platform is Platform else {}
    p = cls_platform(cls_spec.from_cr(_tasks_cr(state_file), cfg=cls_cfg.from_env(TASK_ENV)),
                     **kw)
    p.up(wait_ready_s=60)
    try:
        p.broker.produce_batch(p.cfg.kafka_topic, records)
        _wait(lambda: _counters(p)["fraud"] >= len(records))
        # quiescent: every fraud instance has ended, so no reply timer can
        # still open a task after the queue looked empty
        _wait(lambda: p.investigator.completed > 0 and not p.engine.tasks("open")
              and not p.engine.instances("active"))
        _wait(lambda: p.usertask_model.n_examples == p.investigator.completed)
        inv = p.registries["investigator"].counter("investigator_tasks_completed_total")
        done = sorted((t.task_id, t.outcome) for t in p.engine.tasks("completed"))
        return {"done": done,
                "counts": {o: inv.value({"outcome": o}) for o in ("approved", "cancelled")},
                "trained": p.usertask_model.trained, "n": p.usertask_model.n_examples,
                "params": {k: np.asarray(v) for k, v in (
                    p.usertask_model._params.items() if cls_platform is RefPlatform
                    else p.usertask_model.params.items())}}
    finally:
        p.down()


def test_investigator_and_usertask_model_match_the_reference(tmp_path):
    """Both scorers serve the same seeded logreg (tests/test_torch_platform.py),
    so the tasks carry the same probabilities."""
    import jax.numpy as jnp
    import torch

    from ccfd_tpu.models import registry as ref_registry
    from ccfd_tpu_torch.models import registry as port_registry
    from tests.test_torch_platform import _seeded_logreg, _serving

    records = _records(0, 60, seed=2)
    x = np.asarray([[r[k] for k in list(r)[:30]] for r in records], np.float32)
    w, b = _seeded_logreg(x)
    with _serving(ref_registry, {"w": jnp.asarray(w), "b": jnp.asarray(b)}):
        ref = _tasks_run(RefPlatform, RefSpec, RefConfig, str(tmp_path / "ref.npz"), records)
    with _serving(port_registry, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}), \
            _port_model_from_the_reference_init():
        port = _tasks_run(Platform, PlatformSpec, Config, str(tmp_path / "port.npz"), records)
    assert port["done"] == ref["done"] and len(port["done"]) >= 6
    assert port["counts"] == ref["counts"]
    assert port["counts"]["approved"] and port["counts"]["cancelled"]
    assert port["trained"] and ref["trained"] and port["n"] == ref["n"]
    for k in port["params"]:
        np.testing.assert_allclose(port["params"][k], ref["params"][k], rtol=0, atol=1e-5)

    # down() saved the model; a bounce on the same file restores it
    from ccfd_tpu.process.usertask_model import OnlineUserTaskModel as RefModel

    p = Platform(PlatformSpec.from_cr(_tasks_cr(str(tmp_path / "port.npz")),
                                      cfg=Config.from_env(TASK_ENV)), device="cpu")
    p.up(wait_ready_s=60)
    try:
        assert p.usertask_model.trained and p.usertask_model.n_examples == port["n"]
        for k, v in p.usertask_model.params.items():
            np.testing.assert_array_equal(v, port["params"][k])
        assert p.investigator is not None
    finally:
        p.down()
    other = RefModel(warmup=False)
    other.load(str(tmp_path / "port.npz"))  # the reference loads the port's file
    assert other.trained and other.n_examples == port["n"]


def test_up_command_serves_seq_and_names_no_kernel(tmp_path, capsys, monkeypatch):
    """``up -f`` of the port's CR with ``scorer.model: seq`` (retrain and the
    lifecycle off, as the port requires): the ready line names the seq model and no hand
    kernel, every produced row is routed, the investigator runs."""
    import yaml

    from ccfd_tpu_torch.cli import main

    cr = yaml.safe_load((Path(__file__).resolve().parents[1] / "ccfd_tpu_torch" / "assets"
                         / "platform_cr.yaml").read_text())
    s = cr["spec"]
    s["scorer"].update(port=0, model="seq", history_length=8)
    s["monitoring"]["port"] = s["health"]["port"] = 0
    s["bus"]["log_dir"] = str(tmp_path / "buslog")
    s["engine"]["checkpoint_file"] = str(tmp_path / "cut.json")
    s["retrain"]["enabled"] = s["lifecycle"]["enabled"] = s["store"]["enabled"] = False
    s["producer"]["transactions"] = 300
    path = tmp_path / "cr.yaml"
    path.write_text(yaml.safe_dump(cr))
    monkeypatch.setenv("CCFD_BATCH_SIZES", "16,128")
    monkeypatch.chdir(tmp_path)
    assert main(["up", "-f", str(path), "--exit-after-producer", "--drain-s", "60",
                 "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "platform ready: scorer seq on cpu, kernel none (torch code)" in err
    assert "router drained" in err and "investigator" in err
