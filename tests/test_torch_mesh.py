"""The port's mesh, placement specs and multi-process helpers
(ccfd_tpu_torch/parallel/{mesh,sharding,multihost}.py) against the
reference's (tests/test_multihost.py, tests/test_parallel.py:29-70).

The port's mesh is eight logical CPU shards, as the reference's tests run on
eight virtual CPU devices (tests/conftest.py); the same numpy inputs and
params go through both, at the reference tests' tolerances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_helpers  # noqa: F401 - one intra-op thread

from ccfd_tpu.models import mlp as ref_mlp
from ccfd_tpu.parallel import multihost as ref_multihost
from ccfd_tpu.parallel.mesh import make_mesh as ref_make_mesh
from ccfd_tpu.parallel.sharding import mlp_param_spec as ref_mlp_param_spec
from ccfd_tpu.parallel.train import TrainConfig as RefTC
from ccfd_tpu.parallel.train import init_state as ref_init_state
from ccfd_tpu.parallel.train import make_train_step as ref_make_train_step
from ccfd_tpu_torch.data.ccfd import synthetic_dataset
from ccfd_tpu_torch.models import mlp
from ccfd_tpu_torch.params import from_jax_params
from ccfd_tpu_torch.parallel import multihost, sharding
from ccfd_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    make_named_mesh,
)
from ccfd_tpu_torch.parallel.partition import SpecLayout, match_partition_rules, mlp_rules
from ccfd_tpu_torch.parallel.sharding import P
from ccfd_tpu_torch.parallel.train import TrainConfig, fit_mlp, init_state, make_train_step

CPU8 = [torch.device("cpu")] * 8


def _ref_params(hidden: int, X: np.ndarray) -> dict:
    p = ref_mlp.init(jax.random.PRNGKey(0), hidden=hidden)
    p = ref_mlp.set_normalizer(p, X.mean(0), X.std(0))
    return jax.tree.map(np.asarray, p)


# -- mesh shapes (tests/test_parallel.py::test_mesh_shapes) ---------------------

def test_mesh_shapes():
    mesh = make_mesh(CPU8, model_parallel=2)
    ref = ref_make_mesh(model_parallel=2)
    assert mesh.devices.shape == ref.devices.shape == (4, 2)
    assert mesh.axis_names == ref.axis_names == ("data", "model")
    assert mesh.size == 8 and dict(mesh.shape) == dict(ref.shape)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(CPU8, model_parallel=3)
    with pytest.raises(ValueError):
        ref_make_mesh(model_parallel=3)


def test_named_mesh_shape_and_divisibility():
    mesh = make_named_mesh(CPU8, fsdp=2, tp=2)
    assert dict(mesh.shape) == {"data": 2, "fsdp": 2, "tp": 2}
    assert mesh.platform == "cpu" and mesh.flat == CPU8
    with pytest.raises(ValueError, match="not divisible"):
        make_named_mesh(CPU8, fsdp=3)


def test_default_devices_are_the_visible_cuda_devices(monkeypatch):
    """``devices=None`` means every visible CUDA device; without CUDA a mesh
    is asked for by its devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass the mesh's devices"):
        make_named_mesh()
    with pytest.raises(RuntimeError, match="pass the mesh's devices"):
        make_mesh(model_parallel=1)


def test_logical_shards_may_repeat_a_device():
    mesh = make_named_mesh([torch.device("cpu")] * 4)
    assert mesh.size == 4 and len(set(mesh.flat)) == 1
    assert mesh.stream(0) is None  # a CPU shard has no CUDA stream
    assert mesh.along(DATA_AXIS) == [(0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0)]


# -- placement specs ---------------------------------------------------------------

def test_mlp_param_spec_matches_the_reference_and_the_rules():
    """The hand-written megatron layout equals the reference's spec for spec,
    and equals ``mlp_rules`` over the legacy model axis."""
    ds = synthetic_dataset(n=256, seed=0)
    params = _ref_params(64, ds.X)
    mesh = make_mesh(CPU8, model_parallel=2)
    hand = sharding.mlp_param_spec(params, mesh)
    ref = ref_mlp_param_spec(params, ref_make_mesh(model_parallel=2))
    ruled = match_partition_rules(mlp_rules(SpecLayout(tp_axis="model")), params)
    for i, layer in enumerate(hand["layers"]):
        for k in ("w", "b"):
            assert tuple(layer[k].spec) == tuple(ref["layers"][i][k].spec), (i, k)
            assert layer[k].spec == ruled["layers"][i][k], (i, k)
    for k in ("mu", "sigma"):
        assert hand["norm"][k].spec == P() == ruled["norm"][k]


def test_shard_params_lays_blocks_out_and_gathers_back():
    ds = synthetic_dataset(n=256, seed=0)
    params = _ref_params(64, ds.X)
    mesh = make_mesh(CPU8, model_parallel=2)
    placed = sharding.shard_params(params, sharding.mlp_param_spec(params, mesh))
    w0 = placed["layers"][0]["w"]
    assert w0.spec == P(None, MODEL_AXIS) and len(w0.blocks) == 2
    assert tuple(w0.blocks[(0, 0)].shape) == (30, 32)
    assert len(w0.shards) == 8  # one a logical shard
    assert placed["layers"][1]["w"].spec == P(MODEL_AXIS, None)
    for i in range(3):
        for k in ("w", "b"):
            np.testing.assert_array_equal(placed["layers"][i][k].numpy(),
                                          params["layers"][i][k])
    with pytest.raises(ValueError, match="does not divide"):
        sharding.device_put(np.zeros((3, 5), np.float32),
                            sharding.NamedSharding(mesh, P(None, MODEL_AXIS)))
    batch = sharding.device_put(ds.X[:16], sharding.batch_spec(mesh))
    assert len(batch.blocks) == 4 and tuple(batch.blocks[(1, 0)].shape) == (4, 30)


# -- the sharded train step (tests/test_parallel.py:37-68) ----------------------

def test_sharded_train_step_matches_single_device():
    """The megatron-laid-out step over a (4, 2) mesh against the reference's
    single-device step from the same params and batches: the reference
    test's tolerances (loss 1e-3; weights rtol 1e-3, atol 1e-4)."""
    ds = synthetic_dataset(n=512, fraud_rate=0.3, seed=5)
    params = _ref_params(128, ds.X)
    y = ds.y.astype(np.float32)
    tc_kw = dict(compute_dtype="float32", learning_rate=0.05)

    ref_state = ref_init_state(params, RefTC(**tc_kw))
    ref_step = ref_make_train_step(RefTC(**tc_kw))
    for _ in range(5):
        ref_state, ref_loss = ref_step(ref_state, jnp.asarray(ds.X), jnp.asarray(y))
    ref_p = jax.tree.map(np.asarray, ref_state["params"])

    mesh = make_mesh(CPU8, model_parallel=2)
    state = init_state(from_jax_params(params), TrainConfig(**tc_kw))
    step = make_train_step(TrainConfig(**tc_kw), mesh=mesh)
    for _ in range(5):
        state, loss = step(state, ds.X, y)
    assert state["params"]["layers"][0]["w"].spec == P(None, MODEL_AXIS)
    assert np.isfinite(float(loss)) and abs(float(loss) - float(ref_loss)) < 1e-3
    for i in range(3):
        for k in ("w", "b"):
            np.testing.assert_allclose(state["params"]["layers"][i][k].numpy(),
                                       ref_p["layers"][i][k], rtol=1e-3, atol=1e-4)


def test_dp_only_mesh_runs():
    mesh = make_mesh(CPU8, model_parallel=1)
    ds = synthetic_dataset(n=256, seed=6)
    params = fit_mlp(ds.X, ds.y, hidden=128, steps=3,
                     tc=TrainConfig(compute_dtype="float32", learning_rate=0.05),
                     mesh=mesh, device="cpu")
    out = mlp.apply(params, torch.from_numpy(ds.X[:16]), torch.float32)
    assert tuple(out.shape) == (16,) and torch.isfinite(out).all()


# -- multihost in one process (tests/test_multihost.py) ---------------------------

class TestInitialize:
    def test_noop_without_env(self, monkeypatch):
        for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
            monkeypatch.delenv(var, raising=False)
        assert multihost.initialize() is False is ref_multihost.initialize()

    def test_noop_with_single_process(self, monkeypatch):
        monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
        monkeypatch.setenv("NUM_PROCESSES", "1")
        assert multihost.initialize() is False is ref_multihost.initialize()


class TestGlobalMesh:
    def test_shape_and_axes(self):
        mesh = multihost.make_global_mesh(model_parallel=2, devices=CPU8)
        ref = ref_multihost.make_global_mesh(model_parallel=2)
        assert mesh.axis_names == ref.axis_names == (DATA_AXIS, MODEL_AXIS)
        assert mesh.devices.shape == ref.devices.shape == (4, 2)
        assert mesh.process_count == 1 and mesh.process_of.sum() == 0

    def test_single_host_matches_make_mesh(self):
        a = multihost.make_global_mesh(model_parallel=2, devices=CPU8)
        b = make_mesh(CPU8, model_parallel=2)
        assert isinstance(a, Mesh) and a.flat == b.flat and a.shape == b.shape

    def test_indivisible_model_parallel_rejected(self):
        with pytest.raises(ValueError):
            multihost.make_global_mesh(model_parallel=3, devices=CPU8)
        with pytest.raises(ValueError):
            ref_multihost.make_global_mesh(model_parallel=3)

    def test_global_batch_size(self):
        mesh = multihost.make_global_mesh(model_parallel=1, devices=CPU8)
        ref = ref_multihost.make_global_mesh(model_parallel=1)
        assert (multihost.global_batch_size(mesh, 128)
                == ref_multihost.global_batch_size(ref, 128) == 128 * 8)


class TestLocalToGlobal:
    def test_local_rows_visible_globally(self):
        mesh = multihost.make_global_mesh(model_parallel=1, devices=CPU8)
        local = np.arange(8 * 30, dtype=np.float32).reshape(8, 30)
        batch = multihost.process_local_batch_to_global(mesh, local)
        ref = ref_multihost.process_local_batch_to_global(
            ref_multihost.make_global_mesh(model_parallel=1), local)
        assert batch.shape == tuple(ref.shape) == (8, 30)  # 1 process: global == local
        assert batch.offset == 0
        np.testing.assert_array_equal(batch.rows.numpy(), np.asarray(ref))
        # over the data axis: each shard holds one row, as each device does
        assert len(batch.shards) == len(ref.addressable_shards) == 8
        assert all(tuple(s.shape) == (1, 30) for s in batch.shards)

    def test_feeds_sharded_scoring_step(self):
        """The local part drives a sharded forward: each data shard scores
        its rows, equal to the reference's global forward on the same
        params."""
        mesh = multihost.make_global_mesh(model_parallel=1, devices=CPU8)
        params = jax.tree.map(np.asarray, ref_mlp.init(jax.random.PRNGKey(0)))
        local = np.random.default_rng(0).normal(size=(16, 30)).astype(np.float32)
        batch = multihost.process_local_batch_to_global(mesh, local)
        port = from_jax_params(params)
        with torch.no_grad():
            proba = torch.cat([torch.sigmoid(mlp.logits(port, s, torch.float32))
                               for s in batch.shards]).numpy()
        ref = np.asarray(jax.nn.sigmoid(ref_mlp.logits(params, jnp.asarray(local),
                                                       compute_dtype=jnp.float32)))
        np.testing.assert_allclose(proba, ref, rtol=1e-5, atol=1e-6)


# -- the single-controller shard_map (ops/shard_compat.py) ----------------------

def test_shard_map_collectives_match_the_references():
    """psum, ppermute and the tiled all_to_all over a 4-way axis give the
    reference's shard_map results on the same input, and every shard holds
    the same psum bits."""
    from jax.sharding import PartitionSpec as JP

    from ccfd_tpu.ops.shard_compat import shard_map as ref_shard_map
    from ccfd_tpu_torch.ops.shard_compat import shard_map

    x = np.random.default_rng(3).normal(size=(8, 12)).astype(np.float32)
    perm = [(i, (i + 1) % 4) for i in range(4)]

    def body(ax, xs):
        return (ax.psum(xs), ax.ppermute(xs, perm),
                ax.all_to_all(xs, split_axis=1, concat_axis=0))

    got = shard_map(body, mesh=make_mesh(CPU8, model_parallel=4), in_specs=(P("model", None),),
                    out_specs=(P("model", None),) * 3)(torch.from_numpy(x))

    def ref_body(xs):
        return (jax.lax.psum(xs, "model"), jax.lax.ppermute(xs, "model", perm),
                jax.lax.all_to_all(xs, "model", 1, 0, tiled=True))

    spec = JP("model", None)
    ref = ref_shard_map(ref_body, mesh=ref_make_mesh(model_parallel=4), in_specs=(spec,),
                        out_specs=(spec, spec, spec), check_vma=False)(jnp.asarray(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    psums = got[0].numpy().reshape(4, 2, 12)
    assert all(np.array_equal(psums[0], p) for p in psums)


def test_shard_map_a_failing_shard_fails_the_call_not_the_others():
    """A body that raises breaks the rendezvous: the other shards stop
    waiting and the caller gets the body's error, at once."""
    import time

    from ccfd_tpu_torch.ops.shard_compat import shard_map

    def body(ax, xs):
        if ax.index == 2:
            raise ValueError("shard 2 failed")
        return ax.psum(xs)

    fn = shard_map(body, mesh=make_mesh(CPU8, model_parallel=4), in_specs=(P("model"),),
                   out_specs=P())
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="shard 2 failed"):
        fn(torch.zeros(8))
    assert time.monotonic() - t0 < 10
