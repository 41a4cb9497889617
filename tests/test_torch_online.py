"""Port's OnlineTrainer (parallel/online.py) vs the JAX reference's
(ccfd_tpu/parallel/online.py): ports of the reference's own trainer tests
(tests/test_parallel.py), one round of both trainers on the same label
stream from the same params (float32, within 1e-5), the rebase hand-off,
the aliasing between trainer and Scorer in both directions, the daemon
loop, and the refusals of what is not ported.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.parallel import online as ref_online
from ccfd_tpu.parallel import train as ref_train
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES, synthetic_dataset
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.models import mlp
from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
from ccfd_tpu_torch.parallel.online import OnlineTrainer
from ccfd_tpu_torch.parallel.train import TrainConfig, trainable
from ccfd_tpu_torch.process.clock import ManualClock
from ccfd_tpu_torch.process.fraud import CUSTOMER_RESPONSE_SIGNAL, build_engine
from ccfd_tpu_torch.serving.scorer import Scorer
from tests.torch_helpers import mlp_tree

TC = TrainConfig(compute_dtype="float32", learning_rate=0.05)


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=64, fraud_rate=0.5, seed=8)


def _params(ds, hidden=64, seed=0):
    p = mlp.init(torch.Generator().manual_seed(seed), hidden=hidden)
    return mlp.set_normalizer(p, ds.X.mean(0), ds.X.std(0))


def _scorer(params, dtype="float32"):
    return Scorer(model_name="mlp", params=params, batch_sizes=(16, 64),
                  compute_dtype=dtype, device="cpu")


def _labels(broker, cfg, ds, n, start=0):
    for i in range(start, start + n):
        tx = {name: float(ds.X[i % ds.n, j]) for j, name in enumerate(FEATURE_NAMES)}
        broker.produce(cfg.labels_topic, {"transaction": tx, "label": int(ds.y[i % ds.n])})


def test_online_retrain_swaps_serving_params(tmp_path, ds):
    """Engine label events -> trainer -> scorer hot swap, end to end."""
    cfg = Config(retrain_min_labels=8, retrain_batch=32, customer_reply_timeout_s=30.0)
    broker = Broker()
    engine = build_engine(cfg, broker, Registry(), ManualClock())
    params = _params(ds)
    scorer = _scorer(params)
    before = scorer.score(ds.X[:16]).copy()
    trainer = OnlineTrainer(cfg, broker, scorer, params, tc=TC,
                            checkpoints=CheckpointManager(str(tmp_path)),
                            steps_per_round=2, seed=0)
    # resolve fraud processes to emit labels: half approved, half cancelled
    for i in range(16):
        pid = engine.start_process("fraud", {"transaction": {"id": i, "Amount": float(50 + i)},
                                             "proba": 0.9})
        engine.signal(pid, CUSTOMER_RESPONSE_SIGNAL, {"approved": i % 2 == 0})
    assert trainer.step() is True  # 16 labels >= min 8 -> trained
    after = scorer.score(ds.X[:16])
    assert not np.allclose(before, after)  # serving picked up new params
    r = trainer.registry
    assert r.counter("retrain_param_swaps_total").value() == 1
    assert r.counter("retrain_steps_total").value() == 2
    assert r.counter("retrain_labels_total").value({"class": "fraud"}) == 8
    assert r.counter("retrain_labels_total").value({"class": "legit"}) == 8
    assert np.isfinite(r.gauge("retrain_last_loss").value())
    assert trainer.checkpoints.latest_step() == 2
    trainer.close()


def test_online_trainer_ignores_partial_bad_labels(ds):
    cfg = Config(retrain_min_labels=4, retrain_batch=8)
    broker = Broker()
    scorer = _scorer(_params(ds))
    trainer = OnlineTrainer(cfg, broker, scorer, scorer.params, tc=TC, seed=0)
    broker.produce(cfg.labels_topic, {"transaction": {"Amount": 5.0}, "label": None})
    broker.produce(cfg.labels_topic, {"transaction": {"Amount": "x"}, "label": 1})
    broker.produce(cfg.labels_topic, {"transaction": {"Amount": 6.0}, "label": 1})
    trainer._ingest()
    assert len(trainer._X) == len(trainer._y) == 1  # bad records fully dropped
    assert trainer._X[0, FEATURE_NAMES.index("Amount")] == 6.0
    trainer.close()


def test_online_trainer_no_busy_loop_without_new_labels(ds):
    cfg = Config(retrain_min_labels=2, retrain_batch=4)
    broker = Broker()
    scorer = _scorer(_params(ds))
    trainer = OnlineTrainer(cfg, broker, scorer, scorer.params, tc=TC, steps_per_round=1,
                            seed=0)
    assert trainer.step() is False  # nothing buffered
    _labels(broker, cfg, ds, 4)
    assert trainer.step() is True   # new labels -> train
    assert trainer.step() is False  # same buffer, no new labels -> idle
    trainer.close()


def test_swap_params_does_not_alias_trainer_buffers(ds):
    scorer = _scorer(_params(ds))
    p = scorer.params
    scorer.swap_params(p)
    for a, b in zip(trainable(p), trainable(scorer.params)):
        assert a.data_ptr() != b.data_ptr()  # fresh buffers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_and_scorer_never_alias(ds, dtype):
    """The demo's wiring: a trainer built from the Scorer's live params.
    Training after a swap leaves the Scorer's answers unchanged until the
    next swap, and a swap shares no tensor with the trainer."""
    cfg = Config(retrain_min_labels=4, retrain_batch=16)
    broker = Broker()
    scorer = _scorer(_params(ds), dtype)  # bf16: B1's wrapper (its plain version here)
    live = scorer.params
    trainer = OnlineTrainer(cfg, broker, scorer, live, tc=TC, steps_per_round=2, seed=0)
    ptrs = {t.data_ptr() for t in trainable(live)}
    assert not ptrs & {t.data_ptr() for t in trainable(trainer.params)}
    x = ds.X[:16]
    _labels(broker, cfg, ds, 16)
    assert trainer.step() is True
    served = scorer.score(x).copy()
    published = {k: t.clone() for k, t in enumerate(trainable(trainer.params))}
    assert not {t.data_ptr() for t in trainable(scorer.params)} & {
        t.data_ptr() for t in trainable(trainer.params)}
    # more training, no swap: the served answers and params do not move
    for _ in range(3):
        trainer._state, _ = trainer._step_fn(trainer._state, torch.from_numpy(ds.X[:16]),
                                             torch.from_numpy(ds.y[:16].astype(np.float32)))
    np.testing.assert_array_equal(scorer.score(x), served)
    for k, t in enumerate(trainable(scorer.params)):
        assert torch.equal(t, published[k])
    # the next round publishes
    _labels(broker, cfg, ds, 8, start=16)
    assert trainer.step() is True
    assert not np.array_equal(scorer.score(x), served)
    trainer.close()


def test_one_round_matches_the_reference_trainer(ds):
    """The same label stream, seed and params through both trainers for one
    round (float32): the same sampled batches and updates."""
    tree = mlp_tree(ds.X, hidden=64, seed=6)
    tc_ref = ref_train.TrainConfig(compute_dtype="float32", learning_rate=0.05)
    rcfg = RefConfig(retrain_min_labels=16, retrain_batch=32)
    cfg = Config(retrain_min_labels=16, retrain_batch=32)
    rbroker, broker = RefBroker(), Broker()
    ref_scorer = RefScorer(model_name="mlp", params=jax.tree.map(jnp.asarray, tree),
                           batch_sizes=(16, 64), compute_dtype="float32")
    ref = ref_online.OnlineTrainer(rcfg, rbroker, ref_scorer, jax.tree.map(jnp.asarray, tree),
                                   tc=tc_ref, steps_per_round=3, seed=5)
    scorer = _scorer(tree)
    port = OnlineTrainer(cfg, broker, scorer, tree, tc=TC, steps_per_round=3, seed=5)
    _labels(rbroker, rcfg, ds, 48)
    _labels(broker, cfg, ds, 48)
    assert ref.step() is True and port.step() is True
    want = jax.tree.map(np.asarray, ref._state["params"])
    got = port.params
    for i, layer in enumerate(want["layers"]):
        for k, v in layer.items():
            np.testing.assert_allclose(got["layers"][i][k].numpy(), v, rtol=0, atol=1e-5,
                                       err_msg=f"layers/{i}/{k}")
    assert abs(ref.registry.gauge("retrain_last_loss").value()
               - port.registry.gauge("retrain_last_loss").value()) <= 1e-5
    # and the Scorers serve the published params alike
    np.testing.assert_allclose(scorer.score(ds.X), np.asarray(ref_scorer.score(ds.X)),
                               rtol=0, atol=1e-5)
    ref.close()
    port.close()


def test_rebase_applies_at_the_next_step(ds):
    cfg = Config(retrain_min_labels=4, retrain_batch=8)
    broker = Broker()
    scorer = _scorer(_params(ds, seed=1))
    trainer = OnlineTrainer(cfg, broker, scorer, scorer.params, tc=TC, seed=0)
    champion = _params(ds, seed=2)
    trainer.rebase(champion)
    # staged, not applied
    assert not torch.equal(trainer.params["layers"][0]["w"], champion["layers"][0]["w"])
    champion["layers"][0]["w"].add_(1.0)  # rebase copied: later edits do not leak
    assert trainer.step() is False  # no labels: no training, but the rebase lands
    assert torch.equal(trainer.params["layers"][0]["w"] + 1.0, champion["layers"][0]["w"])
    _labels(broker, cfg, ds, 8)
    assert trainer.step() is True
    trainer.close()


def test_daemon_trains_on_arriving_labels_and_stops(ds):
    cfg = Config(retrain_min_labels=4, retrain_batch=8)
    broker = Broker()
    scorer = _scorer(_params(ds))
    trainer = OnlineTrainer(cfg, broker, scorer, scorer.params, tc=TC, steps_per_round=1,
                            seed=0)
    t = trainer.start(interval_s=0.01)
    swaps = trainer.registry.counter("retrain_param_swaps_total")
    try:
        for part in range(2):
            _labels(broker, cfg, ds, 8, start=8 * part)
            deadline = time.monotonic() + 20
            while swaps.value() < part + 1 and time.monotonic() < deadline:
                time.sleep(0.01)
    finally:
        trainer.stop()
        t.join(timeout=20)
    assert not t.is_alive()
    assert swaps.value() == 2
    trainer.close()


def test_unported_options_are_refused_by_name(ds):
    """Named for the refusal before A15b: ``mesh=`` and ``partitioner=``
    are served since (the sharded step over logical CPU shards), so each
    builds a trainer whose round trains on the mesh and swaps the scorer;
    the lifecycle (lifecycle=) is tests/test_torch_lifecycle.py's."""
    from ccfd_tpu_torch.parallel.mesh import make_mesh, make_named_mesh
    from ccfd_tpu_torch.parallel.partition import DataParallelPartitioner
    from ccfd_tpu_torch.parallel.sharding import ShardedTensor

    cpu = [torch.device("cpu")] * 4
    cfg = Config(retrain_min_labels=8, retrain_batch=10)
    for kw in ({"mesh": make_mesh(cpu)},
               {"partitioner": DataParallelPartitioner(make_named_mesh(cpu))}):
        broker = Broker()
        scorer = _scorer(_params(ds))
        before = scorer.score(ds.X[:16])
        trainer = OnlineTrainer(cfg, broker, scorer, scorer.params,
                                tc=TrainConfig(compute_dtype="float32"), steps_per_round=2,
                                **kw)
        _labels(broker, cfg, ds, 32)
        assert trainer.step() is True
        assert isinstance(trainer._state["params"]["layers"][0]["w"], ShardedTensor)
        assert int(trainer._state["step"]) == 2
        assert not np.allclose(scorer.score(ds.X[:16]), before)
        trainer.close()


def test_config_reads_the_retrain_knobs_as_the_reference():
    env = {"CCFD_RETRAIN_BATCH": "64", "CCFD_RETRAIN_MIN_LABELS": "12"}
    for e in (env, {}):
        got, want = Config.from_env(e), RefConfig.from_env(e)
        assert (got.retrain_batch, got.retrain_min_labels) == (
            want.retrain_batch, want.retrain_min_labels)
    # the lifecycle's lineage store is ported: read as the reference reads it
    env = {"CCFD_LIFECYCLE_DIR": "/tmp/lc"}
    assert Config.from_env(env).lifecycle_dir == RefConfig.from_env(env).lifecycle_dir
    assert Config.from_env(env).unported() == []
