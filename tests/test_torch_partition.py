"""The port's partitioning layer (ccfd_tpu_torch/parallel/partition.py) and
every sharded path it drives, against the reference's
(tests/test_partition.py), on eight logical CPU shards.

The cases the port can hold: the regex rules, the shard/gather round trip,
the device-count-invariant fingerprint (equal to the reference's), the
row, q8 and SPMD Scorer parity, the sharded seq scorer, the donated train
step against one device, the trainer's batch rounding, a sharded lifecycle
promote then rollback, the PublishGate (re-entrancy, the timeout release,
swaps racing dispatching workers), the mesh as one health domain, and the
operator's mesh block. Tolerances are the reference tests': f32
data-parallel rtol 1e-5, atol 1e-6; bf16 and tp layouts rtol 2e-2, atol
2e-3; the train step rtol 5e-4.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

from ccfd_tpu.models import mlp as ref_mlp
from ccfd_tpu.parallel import partition as ref_part
from ccfd_tpu.parallel.mesh import make_named_mesh as ref_named_mesh
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.parallel.mesh import make_named_mesh
from ccfd_tpu_torch.parallel.partition import (
    DataParallelPartitioner,
    PublishGate,
    SPMDPartitioner,
    gather_params,
    match_partition_rules,
    mlp_rules,
    params_fingerprint,
    partitioner_from_config,
    seq_rules,
    tree_leaves,
    tree_paths,
)
from ccfd_tpu_torch.parallel.sharding import P, ShardedTensor
from ccfd_tpu_torch.serving.scorer import Scorer
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)
CPU8 = [torch.device("cpu")] * 8
F32 = dict(rtol=1e-5, atol=1e-6)
TP = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(scope="module")
def params(dataset):
    p = ref_mlp.init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, ref_mlp.set_normalizer(p, dataset.X.mean(0),
                                                           dataset.X.std(0)))


def _dp(n=8, **kw):
    return DataParallelPartitioner(make_named_mesh(CPU8[:n], **kw))


def _ref_dp(n=8, **kw):
    return ref_part.DataParallelPartitioner(ref_named_mesh(jax.devices()[:n], **kw))


# -- regex partition rules ---------------------------------------------------

def test_match_rules_scalar_and_single_element_leaves_skip_rules():
    tree = {"step": np.zeros(()), "one": np.zeros((1,)), "w": np.zeros((4, 4))}
    specs = match_partition_rules([("w", P("tp", None))], tree)
    assert specs["step"] == P() and specs["one"] == P()
    assert specs["w"] == P("tp", None)


def test_match_rules_uncovered_param_raises():
    with pytest.raises(ValueError, match="mystery"):
        match_partition_rules([("w", P())], {"w": np.zeros((2, 2)),
                                             "mystery": np.zeros((3, 3))})


def test_match_rules_first_match_wins_ordered():
    tree = {"layers": [{"w": np.zeros((4, 8))}, {"w": np.zeros((8, 8))}]}
    specs = match_partition_rules(
        [(r"layers/0/w", P(None, "tp")), (r"layers/\d+/w", P("tp", None))], tree)
    assert specs["layers"][0]["w"] == P(None, "tp")
    assert specs["layers"][1]["w"] == P("tp", None)


def test_rules_cover_optimizer_state_trees(params):
    """The train state's momentum traces are param-structured: one rule
    table covers them, the first layer's trace sharded like its param;
    the paths are the reference's."""
    opt_state = {"momentum": params}
    specs = match_partition_rules(mlp_rules(), opt_state)  # must not raise
    flat = dict(zip(tree_paths(opt_state), tree_leaves(specs)))
    w_specs = [s for path, s in flat.items() if path.endswith("layers/0/w")]
    assert w_specs and all(s == P(None, "tp") for s in w_specs)
    assert tree_paths(params) == ref_part.tree_paths(params)


def test_seq_rules_cover_the_history_model():
    from ccfd_tpu.models import seq as ref_seq

    sp = jax.tree.map(np.asarray, ref_seq.init(jax.random.PRNGKey(0)))
    specs = match_partition_rules(seq_rules(), sp)
    ref = ref_part.match_partition_rules(ref_part.seq_rules(), sp)
    flat = dict(zip(tree_paths(sp), tree_leaves(specs)))
    assert flat["blocks/0/qkv/w"] == P("fsdp", "tp")
    assert flat["blocks/0/proj/w"] == P("tp", None)
    assert flat["blocks/0/ln1/scale"] == P() and flat["head/w"] == P()
    ref_flat = dict(zip(ref_part.tree_paths(sp), jax.tree.leaves(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    assert {k: tuple(v) for k, v in flat.items()} == {k: tuple(v) for k, v in ref_flat.items()}


# -- mesh + partitioner surface ----------------------------------------------

def test_round_batch_covers_data_axis():
    part = _dp(8)
    assert part.data_size == 8 and part.n_devices == 8
    assert [part.round_batch(b) for b in (1, 8, 9)] == [8, 8, 16]
    assert [_ref_dp(8).round_batch(b) for b in (1, 8, 9)] == [8, 8, 16]


def test_partitioner_from_config_resolution():
    mesh = make_named_mesh(CPU8)
    assert isinstance(partitioner_from_config(mesh, "replicated"), DataParallelPartitioner)
    spmd = partitioner_from_config(mesh, "rules", model="seq")
    assert isinstance(spmd, SPMDPartitioner) and spmd.rules == seq_rules()
    with pytest.raises(ValueError, match="param_partition"):
        partitioner_from_config(mesh, "banana")
    with pytest.raises(ValueError, match="no axis"):
        DataParallelPartitioner(make_named_mesh(CPU8), data_axis="rows")


def test_shard_gather_roundtrip_is_byte_identical(params):
    for part in (_dp(8), SPMDPartitioner(make_named_mesh(CPU8, tp=2), mlp_rules())):
        sharded = part.shard_params(params)
        assert isinstance(sharded["layers"][0]["w"], ShardedTensor)
        back = part.gather(sharded)
        for a, b in zip(tree_leaves(params), tree_leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_fingerprint_invariant_across_device_counts_and_equal_to_the_reference(params):
    """The lineage hash is the same whole on one device or sharded over 2,
    4 and 8 shards or the tp layout, and it is the reference's digest."""
    want = params_fingerprint(params)
    assert want == ref_part.params_fingerprint(params)
    for n in (1, 2, 4, 8):
        assert params_fingerprint(_dp(n).shard_params(params)) == want
        assert ref_part.params_fingerprint(_ref_dp(n).shard_params(params)) == want
    spmd = SPMDPartitioner(make_named_mesh(CPU8, tp=2), mlp_rules())
    assert params_fingerprint(spmd.shard_params(params)) == want
    mutated = jax.tree.map(np.copy, params)
    mutated["layers"][0]["b"][0] += 1.0
    assert params_fingerprint(mutated) != want


# -- partitioner-driven serving parity ---------------------------------------

def test_scorer_partitioner_parity_row(dataset, params):
    ref = RefScorer(model_name="mlp", params=params, use_fused=False,
                    compute_dtype="float32", partitioner=_ref_dp(8)).score(dataset.X[:1000])
    s = Scorer("mlp", params=params, compute_dtype="float32", partitioner=_dp(8))
    assert all(b % 8 == 0 for b in s.batch_sizes) and s.partitioner is not None
    got = s.score(dataset.X[:1000])
    np.testing.assert_allclose(got, ref, **F32)
    single = Scorer("mlp", params=params, compute_dtype="float32", device="cpu")
    np.testing.assert_allclose(got, single.score(dataset.X[:1000]), **F32)


def test_scorer_partitioner_parity_q8(dataset, params):
    from ccfd_tpu.ops import quant

    q8 = jax.tree.map(np.asarray, quant.quantize_mlp(params))
    ref = RefScorer(model_name="mlp_q8", params=q8, use_fused=False).score(dataset.X[:512])
    s = Scorer("mlp_q8", params=q8, partitioner=_dp(8))
    assert s.kernel_name == "fused_mlp_q8"  # B2 on the f32 wire
    np.testing.assert_allclose(s.score(dataset.X[:512]), ref, **F32)


def test_scorer_spmd_rules_parity(dataset, params):
    """The rule-table layout over tp lands sharded and computes the same
    model as the reference's SPMD scorer."""
    part = SPMDPartitioner(make_named_mesh(CPU8, tp=2), mlp_rules())
    ref = RefScorer(model_name="mlp", params=params, use_fused=False, compute_dtype="float32",
                    partitioner=ref_part.SPMDPartitioner(
                        ref_named_mesh(jax.devices()[:8], tp=2),
                        ref_part.mlp_rules())).score(dataset.X[:512])
    s = Scorer("mlp", params=params, compute_dtype="float32", partitioner=part)
    assert s.params["layers"][0]["w"].spec == P(None, "tp")
    assert len(s.params["layers"][0]["w"].blocks) == 2
    np.testing.assert_allclose(s.score(dataset.X[:512]), ref, **TP)
    # bf16 through B1 with the rule layout: the kernel's weights replicate
    bf16 = Scorer("mlp", params=params, partitioner=part)
    assert bf16.fused
    np.testing.assert_allclose(bf16.score(dataset.X[:512]), ref, rtol=5e-2, atol=5e-3)


def _seq_tree(seed=1):
    from ccfd_tpu.models import seq as ref_seq

    return jax.tree.map(np.asarray, ref_seq.init(jax.random.PRNGKey(seed)))


def _seq_parity(part, ref_part_, n_rows=24):
    from ccfd_tpu.serving.history import SeqScorer as RefSeqScorer
    from ccfd_tpu_torch.params import from_jax_model_params
    from ccfd_tpu_torch.serving.history import SeqScorer

    tree = _seq_tree()
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(n_rows, 30)).astype(np.float32)
    ids = [f"c{i % 6}" for i in range(n_rows)]
    port = SeqScorer(from_jax_model_params("seq", tree), length=8, batch_sizes=(n_rows,),
                     compute_dtype="float32", max_customers=64, partitioner=part)
    ref = RefSeqScorer(tree, length=8, batch_sizes=(n_rows,), compute_dtype="float32",
                       max_customers=64, partitioner=ref_part_)
    for s in (port, ref):
        s.score(rows, ids)
    np.testing.assert_allclose(port.score(rows, ids), ref.score(rows, ids), **TP)
    return port


def test_seq_scorer_partitioner_parity():
    port = _seq_parity(_dp(8), _ref_dp(8))
    assert port.mesh is port.partitioner.mesh and port.batch_sizes == (24,)
    assert port.executable_grid()["mesh_devices"] == 8


def test_seq_scorer_rules_layout_lands_sharded_with_parity():
    part = SPMDPartitioner(make_named_mesh(CPU8, fsdp=2, tp=2), seq_rules())
    ref = ref_part.SPMDPartitioner(ref_named_mesh(jax.devices()[:8], fsdp=2, tp=2),
                                   ref_part.seq_rules())
    port = _seq_parity(part, ref, n_rows=16)
    qkv = port.params["blocks"][0]["qkv"]["w"]
    assert qkv.spec == P("fsdp", "tp") and len(qkv.blocks) == 4


def test_seq_q8_swap_under_rules_replicates_with_parity():
    """A promoted int8 seq_q8 tree has leaf names the rule table does not
    cover: the swap replicates it (with a warning) and keeps serving."""
    from ccfd_tpu_torch.ops.seq_quant import quantize_seq
    from ccfd_tpu_torch.params import from_jax_model_params
    from ccfd_tpu_torch.serving.history import SeqScorer

    part = SPMDPartitioner(make_named_mesh(CPU8, fsdp=2, tp=2), seq_rules())
    tree = from_jax_model_params("seq", _seq_tree())
    s = SeqScorer(tree, length=8, batch_sizes=(16,), compute_dtype="float32",
                  max_customers=64, partitioner=part)
    rows = np.random.default_rng(6).normal(size=(16, 30)).astype(np.float32)
    s.score(rows, list(range(16)))
    q8 = quantize_seq(tree, device="cpu")
    s.swap_params(q8)
    out = s.score(rows, list(range(16)))
    assert out.shape == (16,) and np.isfinite(out).all()
    assert s.executable_grid()["model"] == "seq_q8"
    single = SeqScorer(tree, length=8, batch_sizes=(16,), compute_dtype="float32",
                       max_customers=64, device="cpu")
    single.score(rows, list(range(16)))
    single.swap_params(q8)
    np.testing.assert_allclose(out, single.score(rows, list(range(16))), **TP)


# -- the sharded train step --------------------------------------------------

def test_partitioned_train_step_matches_single_device(dataset, params):
    from ccfd_tpu_torch.parallel.train import TrainConfig, init_state, make_train_step

    tc = TrainConfig(compute_dtype="float32", learning_rate=0.01)
    x = dataset.X[:256]
    y = dataset.y[:256].astype(np.float32)

    def run(partitioner):
        state = init_state(params, tc)
        step = make_train_step(tc, partitioner=partitioner)
        loss = None
        for _ in range(4):
            state, loss = step(state, x, y)
        return float(loss), gather_params(state["params"])

    loss1, p1 = run(None)
    loss8, p8 = run(_dp(8))
    assert np.isfinite(loss8)
    # dp=8 sums the shards' partial sums in another order than one device:
    # the reference test's reduction-order tolerances
    np.testing.assert_allclose(loss1, loss8, rtol=5e-4, atol=1e-6)
    for a, b in zip(tree_leaves(p1), tree_leaves(p8)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)
    # and the reference's own dp=8 step lands on the same loss
    from ccfd_tpu.parallel.train import TrainConfig as RefTC
    from ccfd_tpu.parallel.train import init_state as ref_init
    from ccfd_tpu.parallel.train import make_train_step as ref_make

    rtc = RefTC(compute_dtype="float32", learning_rate=0.01)
    rstate, rstep = ref_init(params, rtc), ref_make(rtc, partitioner=_ref_dp(8))
    for _ in range(4):
        rstate, rloss = rstep(rstate, x, y)
    np.testing.assert_allclose(loss8, float(rloss), rtol=5e-4, atol=1e-6)


def test_partitioned_train_state_lands_sharded(params):
    from ccfd_tpu_torch.parallel.train import TrainConfig, init_state, make_train_step

    tc = TrainConfig(compute_dtype="float32")
    part = SPMDPartitioner(make_named_mesh(CPU8, tp=2), mlp_rules())
    state = init_state(params, tc)
    step = make_train_step(tc, partitioner=part)
    state, _ = step(state, np.zeros((64, 30), np.float32), np.zeros((64,), np.float32))
    w = state["params"]["layers"][0]["w"]
    assert isinstance(w, ShardedTensor) and w.spec == P(None, "tp") and len(w.shards) == 8
    assert state["specs"]["opt_state"]["momentum"]["layers"][0]["w"] == P(None, "tp")
    assert state["specs"]["step"] == P()
    with pytest.raises(ValueError, match="round_batch"):
        step(state, np.zeros((62, 30), np.float32), np.zeros((62,), np.float32))


def test_online_trainer_rounds_batch_to_data_axis(dataset):
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.parallel.online import OnlineTrainer
    from ccfd_tpu_torch.parallel.train import TrainConfig

    cfg = Config(retrain_min_labels=8, retrain_batch=13)
    broker = Broker()
    scorer = Scorer("mlp", compute_dtype="float32", partitioner=_dp(8))
    trainer = OnlineTrainer(cfg, broker, scorer, scorer.params,
                            tc=TrainConfig(compute_dtype="float32"),
                            partitioner=scorer.partitioner, steps_per_round=1)
    seen = []
    step_fn = trainer._step_fn
    trainer._step_fn = lambda state, x, y: (seen.append(len(x)), step_fn(state, x, y))[1]
    for i in range(16):
        broker.produce(cfg.labels_topic, {
            "transaction": dict(zip(FEATURE_NAMES, map(float, dataset.X[i]))),
            "label": int(dataset.y[i])})
    assert trainer.step() is True  # 13 rounds UP to 16: every shard the same rows
    assert seen == [16] and int(trainer._state["step"]) == 1
    trainer.close()


# -- lifecycle under sharded params ------------------------------------------

def _sharded_lifecycle_stack(tmp_path, params):
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.lifecycle.controller import Guardrails, LifecycleController
    from ccfd_tpu_torch.lifecycle.evaluator import ShadowEvaluator
    from ccfd_tpu_torch.lifecycle.shadow import ShadowTap
    from ccfd_tpu_torch.lifecycle.versions import VersionStore
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager

    scorer = Scorer("mlp", params=params, batch_sizes=(16, 128, 1024, 4096),
                    compute_dtype="float32", partitioner=_dp(8))
    cfg = Config()
    broker = Broker()
    reg = Registry()
    store = VersionStore(str(tmp_path / "versions.json"))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep=8)
    shadow = ShadowTap(scorer, broker, cfg.shadow_topic, reg, max_rows_per_s=0)
    ev = ShadowEvaluator(cfg, broker, scorer, reg)
    g = Guardrails(min_labels=32, min_shadow_rows=256, canary_min_labels=16,
                   max_score_psi=5.0, min_submit_interval_s=0.0)
    ctl = LifecycleController(cfg, scorer, store=store, checkpoints=ckpt, shadow=shadow,
                              evaluator=ev, guardrails=g, registry=reg)
    return scorer, cfg, broker, store, shadow, ctl


def _improved(params, bias=0.01):
    p = {"norm": dict(params["norm"]), "layers": [dict(layer) for layer in params["layers"]]}
    p["layers"][-1] = {"w": p["layers"][-1]["w"],
                       "b": p["layers"][-1]["b"] + np.float32(bias)}
    return p


def test_lifecycle_promote_then_rollback_with_sharded_params(tmp_path, dataset, params):
    """shadow -> canary -> PROMOTE publishes sharded params (with the
    device-count-invariant checkpoint hash), then a second candidate's
    canary breach ROLLS BACK to the sharded champion; serving stays equal
    to the promoted tree throughout."""
    from ccfd_tpu_torch.lifecycle.controller import STAGE_CANARY, STAGE_IDLE

    scorer, cfg, broker, store, shadow, ctl = _sharded_lifecycle_stack(tmp_path, params)
    served = ctl.wrap_score(scorer.host_score)
    improved = _improved(params)
    v = ctl.submit_candidate(improved, label_watermark=10)
    assert store.get(v).checkpoint_hash == params_fingerprint(improved)

    def labels(rng):
        for j in rng.integers(0, len(dataset.X), size=16):
            broker.produce(cfg.labels_topic, {
                "transaction": dict(zip(FEATURE_NAMES, map(float, dataset.X[j]))),
                "label": int(dataset.y[j])})

    rng = np.random.default_rng(1)
    promoted = False
    for _ in range(24):
        served(dataset.X[rng.integers(0, len(dataset.X), size=256)])
        shadow.step()
        labels(rng)
        ctl.step()
        if ctl.stage == STAGE_IDLE and store.get(v).stage == "CHAMPION":
            promoted = True
            break
    assert promoted, "sharded candidate never promoted"
    w0 = scorer.params["layers"][0]["w"]
    assert isinstance(w0, ShardedTensor) and len(w0.shards) == 8
    expected = Scorer("mlp", params=improved, compute_dtype="float32",
                      device="cpu").score(dataset.X[:64])
    np.testing.assert_allclose(scorer.score(dataset.X[:64]), expected, rtol=1e-4, atol=1e-5)

    v2 = ctl.submit_candidate(_improved(params, bias=0.02), label_watermark=20)
    rng2 = np.random.default_rng(2)
    for _ in range(24):
        served(dataset.X[rng2.integers(0, len(dataset.X), size=256)])
        shadow.step()
        if ctl.stage != STAGE_CANARY:
            labels(rng2)
        ctl.step()
        if ctl.stage == STAGE_CANARY:
            break
    assert ctl.stage == STAGE_CANARY, "second candidate never hit canary"
    for _ in range(12):
        broker.produce(cfg.shadow_topic, {"version": v2, "champion": [0.05] * 256,
                                          "challenger": [0.99] * 256})
    ctl.step()
    assert store.get(v2).stage == "ROLLED_BACK"
    np.testing.assert_allclose(scorer.score(dataset.X[:64]), expected, rtol=1e-4, atol=1e-5)
    events = [e for e in store.audit_trail() if e["event"] == "rollback_restore"]
    assert events and events[-1]["detail"]["checkpoint_hash"] == store.get(v).checkpoint_hash
    assert ctl.serving_consistent()
    ctl.close()


# -- the publish gate --------------------------------------------------------

class _Barrier:
    def __init__(self, ok=True):
        self.ok = ok
        self.pauses = 0
        self.resumes = 0

    def pause(self, timeout_s=10.0):
        self.pauses += 1
        return self.ok

    def resume(self):
        self.resumes += 1


@pytest.mark.parametrize("gate_cls", [PublishGate, ref_part.PublishGate])
def test_publish_gate_pause_resume_and_reentrancy(gate_cls):
    b = _Barrier()
    gate = gate_cls(b)
    with gate:
        with gate:  # a respawn swapping inside an outer publish
            pass
    assert b.pauses == 1 and b.resumes == 1
    assert gate.publishes == 1 and gate.pause_timeouts == 0


@pytest.mark.parametrize("gate_cls", [PublishGate, ref_part.PublishGate])
def test_publish_gate_timeout_does_not_block_publish_and_releases_hold(gate_cls):
    from ccfd_tpu_torch.metrics.prom import Registry

    b = _Barrier(ok=False)
    if gate_cls is PublishGate:
        part = _dp(2)
        reg = Registry()
        part.set_barrier(b, registry=reg)
        gate = part.gate
    else:
        gate = gate_cls(b)
    with gate:
        pass
    assert gate.pause_timeouts == 1
    # the hold releases even without an ack
    assert b.resumes == 1
    if gate_cls is PublishGate:
        assert reg.counter("ccfd_mesh_publish_pause_timeouts_total").value() == 1
        assert reg.counter("ccfd_mesh_publishes_total").value() == 1


def test_swap_racing_dispatching_workers_is_quiescent(dataset, params):
    """ParallelRouter workers sharing one sharded scorer never interleave
    swap_params with an in-flight sharded dispatch: every swap takes the
    pool's pause barrier at a batch boundary."""
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.process.fraud import build_engine
    from ccfd_tpu_torch.router.parallel import ParallelRouter

    cfg = Config(confidence_threshold=1.0)
    broker = Broker(default_partitions=2)
    reg = Registry()
    engine = build_engine(cfg, broker, reg, None)
    part = _dp(8)
    scorer = Scorer("mlp", params=params, compute_dtype="float32", batch_sizes=(16, 128),
                    partitioner=part)
    scorer.warmup()
    pr = ParallelRouter(cfg, broker, scorer.score, engine, reg, workers=2, max_batch=64)
    part.set_barrier(pr)
    scorer.set_swap_gate(part.gate)
    t = pr.start(poll_timeout_s=0.01)
    stop = threading.Event()
    swap_errors: list[BaseException] = []

    def swapper():
        while not stop.is_set():
            try:
                scorer.swap_params(params)
            except BaseException as e:  # noqa: BLE001 - the regression under test
                swap_errors.append(e)
                return
            time.sleep(0.005)

    sw = threading.Thread(target=swapper, daemon=True)
    sw.start()
    try:
        n = 512
        broker.produce_batch(cfg.kafka_topic, [b"0," * 29 + b"0"] * n, list(range(n)))
        deadline = time.time() + 30
        c_in = reg.counter("transaction_incoming_total")
        while c_in.value() < n and time.time() < deadline:
            time.sleep(0.02)
        assert c_in.value() == n
    finally:
        stop.set()
        sw.join(timeout=5)
        pr.close()
        t.join(timeout=5)
    assert not swap_errors, swap_errors
    assert part.gate.publishes > 0
    assert part.gate.pause_timeouts == 0  # every pause was acknowledged
    assert reg.counter("transaction_outgoing_total").total() == n


# -- the mesh is ONE health domain --------------------------------------------

def test_mesh_supervised_as_one_health_domain(params):
    from ccfd_tpu.runtime.heal import mesh_domain_label as ref_label
    from ccfd_tpu_torch.runtime.heal import DeviceSupervisor, mesh_domain_label

    scorer = Scorer("mlp", params=params, batch_sizes=(16, 128), partitioner=_dp(8))
    scorer.warmup()
    sup = DeviceSupervisor(scorer, canary_deadline_ms=150.0)
    assert sup.domain == "mesh"
    assert sup.device == "mesh:cpux8" == mesh_domain_label(scorer.mesh)
    assert ref_label(ref_named_mesh(jax.devices()[:8])) == "mesh:cpux8"
    assert sup.status()["domain"] == "mesh"


def test_mesh_fault_quarantines_the_mesh_tier_not_a_shard(params):
    """A canary hang quarantines the whole mesh tier, and the router's
    ladder serves the host tier."""
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.process.fraud import build_engine
    from ccfd_tpu_torch.router.router import Router
    from ccfd_tpu_torch.runtime import faults
    from ccfd_tpu_torch.runtime.heal import DeviceSupervisor

    scorer = Scorer("mlp", params=params, batch_sizes=(16, 128), partitioner=_dp(8))
    scorer.warmup()
    sup = DeviceSupervisor(scorer, canary_deadline_ms=120.0, suspect_strikes=2,
                           backoff_base_s=5.0, backoff_cap_s=5.0)
    faults.install_device_faults(faults.DeviceFaultPlan.from_string("device_hang:ms=400"))
    try:
        for _ in range(4):
            if sup.tick() == "quarantined":
                break
        assert sup.state == "quarantined"
        assert sup.device.startswith("mesh:")
        assert not sup.device_allowed()
    finally:
        faults.install_device_faults(None)
    cfg = Config(confidence_threshold=1.0)
    broker = Broker(default_partitions=1)
    reg = Registry()
    engine = build_engine(cfg, broker, reg, None)
    r = Router(cfg, broker, scorer.score, engine, reg, max_batch=256,
               host_score_fn=scorer.host_score, degrade=True, heal_gate=sup)
    try:
        broker.produce_batch(cfg.kafka_topic, [b"0," * 29 + b"0"] * 32, list(range(32)))
        assert r.step() == 32
        assert reg.counter("router_degraded_total").value({"tier": "host"}) == 32
    finally:
        r.close()


# -- the operator's mesh block -------------------------------------------------

_OFF = {n: {"enabled": False} for n in ("producer", "monitoring", "health", "investigator",
                                        "notify")}


def test_operator_arms_mesh_partitioner_and_gate(tmp_path):
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    cr = {"spec": {**_OFF,
                   "mesh": {"enabled": True, "devices": 8},
                   "scorer": {"enabled": True, "model": "mlp"},
                   "bus": {"partitions": 2}, "router": {"workers": 2},
                   "retrain": {"enabled": True}, "engine": {"enabled": True},
                   "analytics": {"enabled": True,
                                 "reference_file": str(tmp_path / "ref.npz")},
                   "lifecycle": {"enabled": True, "state_dir": str(tmp_path / "lc")},
                   "heal": {"enabled": True}}}
    p = Platform(PlatformSpec.from_cr(cr, cfg=Config(batch_sizes=(16, 128, 1024))),
                 device="cpu").up()
    try:
        assert p.mesh is not None and p.partitioner is not None
        assert p.scorer.mesh is p.mesh and p.scorer.partitioner is p.partitioner
        assert p.partitioner.gate is not None and p.partitioner.gate.barrier is p.router
        assert p.scorer._swap_gate is p.partitioner.gate
        st = p.status()
        assert st["mesh"]["devices"] == 8 and st["mesh"]["axes"]["data"] == 8
        assert st["mesh"]["platform"] == "cpu" and st["heal"]["domain"] == "mesh"
        reg = p.registries["mesh"]
        assert reg.gauge("ccfd_mesh_devices").value() == 8.0
        assert reg.gauge("ccfd_mesh_axis_size").value({"axis": "data"}) == 8.0
        assert p.registries["analytics"].gauge("analytics_workers").value() == 8.0
    finally:
        p.down()


def test_operator_single_device_mesh_stays_unsharded():
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    off = {n: {"enabled": False} for n in ("router", "engine", "notify", "retrain",
                                           "producer", "monitoring", "health",
                                           "investigator", "analytics", "lifecycle", "heal")}
    cr = {"spec": {**off, "mesh": {"enabled": True, "devices": 1},
                   "scorer": {"enabled": True, "model": "mlp"}, "bus": {"partitions": 1}}}
    p = Platform(PlatformSpec.from_cr(cr, cfg=Config(batch_sizes=(16, 128))),
                 device="cpu").up()
    try:
        assert p.mesh is None and p.partitioner is None
        assert p.scorer.mesh is None and "mesh" not in p.status()
    finally:
        p.down()


# the deviations the operator refused until A17, each now served as the
# reference's operator serves it: a CPU platform's N logical shards, its
# devices: 0 unsharded, and the decision plane declining a mesh scorer
DEGRADED_MESHES = [
    ("devices=4", {"devices": 4}, {}, 4, None),
    ("devices=0", {"devices": 0}, {}, None, "serving unsharded"),
    ("fused_decision", {"devices": 4}, {"fused_decision": True}, 4, "mesh-sharded scorer"),
]


@pytest.mark.parametrize("mesh,scorer,shards,warning",
                         [c[1:] for c in DEGRADED_MESHES], ids=[c[0] for c in DEGRADED_MESHES])
def test_operator_degrades_what_it_cannot_serve(mesh, scorer, shards, warning):
    """Nothing of the mesh block is refused; the CPU platform comes up with
    ``shards`` logical shards (None: unsharded) and the decision plane over
    a mesh scorer serves the staged path, each with the reference's
    warning."""
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec
    from tests.torch_helpers import warnings_of

    cr = {"spec": {**_OFF, "mesh": mesh, "lifecycle": False, "retrain": False,
                   "analytics": False, "heal": False,
                   "scorer": {"enabled": True, "model": "mlp", **scorer},
                   "bus": {"partitions": 1}}}
    spec = PlatformSpec.from_cr(cr, cfg=Config(batch_sizes=(16, 128)))
    assert spec.refused() == []
    with warnings_of("ccfd_tpu_torch.platform.operator", "ccfd_tpu_torch.serving.fused") as said:
        p = Platform(spec, device="cpu").up()
    try:
        assert (p.mesh.size if p.mesh is not None else None) == shards
        assert p.fused_decision is None and p.router._decision_fn is None
        if warning is not None:
            assert any(warning in m for m in said), said
    finally:
        p.down()
