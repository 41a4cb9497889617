"""The port's mesh-sharded row Scorer against the reference's
``Scorer(mesh=)`` on the same params (tests/test_serving_mesh.py).

Eight logical CPU shards on the port's side, the conftest's eight virtual
CPU devices on the reference's. On the CPU the port's B1 runs its plain
version (bf16 products, f32 accumulation) where the reference runs its XLA
graph in bf16, hence the reference tests' bf16 tolerances.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch_helpers  # noqa: F401 - one intra-op thread

from ccfd_tpu.data.ccfd import synthetic_dataset
from ccfd_tpu.models import mlp as ref_mlp
from ccfd_tpu.parallel.mesh import make_mesh as ref_make_mesh
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu_torch.ops import fused_mlp
from ccfd_tpu_torch.parallel.mesh import make_mesh
from ccfd_tpu_torch.parallel.sharding import P, ShardedTensor
from ccfd_tpu_torch.serving.scorer import Scorer

CPU8 = [torch.device("cpu")] * 8
BF16 = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=4096, fraud_rate=0.05, seed=3)


def _params(ds, seed=0):
    p = ref_mlp.init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, ref_mlp.set_normalizer(p, ds.X.mean(0), ds.X.std(0)))


@pytest.fixture(scope="module")
def params(ds):
    return _params(ds)


def _ref(params, **kw):
    return RefScorer(model_name="mlp", params=params, use_fused=False, **kw)


def test_sharded_scoring_matches_single_device_and_the_reference(ds, params):
    mesh = make_mesh(CPU8)
    sharded = Scorer("mlp", params=params, mesh=mesh)
    assert sharded.mesh is mesh and sharded.fused and sharded.shards == 8
    got = sharded.score(ds.X[:1000])
    assert got.shape == (1000,)
    single = Scorer("mlp", params=params, device="cpu").score(ds.X[:1000])
    np.testing.assert_allclose(got, single, **BF16)
    ref = _ref(params, mesh=ref_make_mesh()).score(ds.X[:1000])
    np.testing.assert_allclose(got, ref, **BF16)


def test_bucket_sizes_round_up_to_data_axis(params):
    s = Scorer("mlp", params=params, mesh=make_mesh(CPU8), batch_sizes=(3, 10, 64))
    ref = _ref(params, mesh=ref_make_mesh(), batch_sizes=(3, 10, 64))
    assert s.batch_sizes == ref.batch_sizes == (8, 16, 64)
    out = s.score(np.zeros((5, 30), np.float32))
    assert out.shape == (5,)


def test_model_partition_matches_replicated_and_the_reference(ds, params):
    mesh = make_mesh(CPU8, model_parallel=2)
    rep = Scorer("mlp", params=params, mesh=mesh).score(ds.X[:512])
    mp = Scorer("mlp", params=params, mesh=mesh, param_partition="model")
    w0 = mp.params["layers"][0]["w"]
    assert isinstance(w0, ShardedTensor) and w0.spec == P(None, "model")
    got = mp.score(ds.X[:512])
    np.testing.assert_allclose(rep, got, **BF16)
    ref = _ref(params, mesh=ref_make_mesh(model_parallel=2),
               param_partition="model").score(ds.X[:512])
    np.testing.assert_allclose(got, ref, **BF16)
    with pytest.raises(ValueError, match="only for 'mlp'"):
        Scorer("logreg", mesh=mesh, param_partition="model")
    with pytest.raises(ValueError, match="param_partition"):
        Scorer("mlp", params=params, mesh=mesh, param_partition="banana")


def test_swap_params_on_mesh_changes_output(ds, params):
    mesh = make_mesh(CPU8)
    s = Scorer("mlp", params=params, mesh=mesh)
    before = s.score(ds.X[:256])
    p2 = _params(ds, seed=9)
    s.swap_params(p2)
    after = s.score(ds.X[:256])
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, Scorer("mlp", params=p2, mesh=mesh).score(ds.X[:256]),
                               **BF16)
    np.testing.assert_allclose(after, _ref(p2, mesh=ref_make_mesh()).score(ds.X[:256]),
                               **BF16)


def test_kernel_runs_once_a_shard_on_its_rows(ds, params, monkeypatch):
    """The kernel is single-device; on a mesh it runs once a data shard on
    that shard's rows with the whole (replicated) weights, and agrees with
    the reference's kernel composed through shard_map (interpret mode)."""
    calls = []
    real = fused_mlp.fused_mlp_score

    def counting(kp, x):
        calls.append((tuple(x.shape), x.device.type))
        return real(kp, x)

    monkeypatch.setattr(fused_mlp, "fused_mlp_score", counting)
    mesh = make_mesh(CPU8)
    s = Scorer("mlp", params=params, mesh=mesh, batch_sizes=(16, 128, 1024))
    got = s.score(ds.X[:256])
    assert calls == [((128, 30), "cpu")] * 8  # bucket 1024 over 8 shards
    grid = s.executable_grid()
    assert grid["dispatches"] == {"1024": 1} and grid["shard_launches"] == {"1024": 8}
    assert grid["mesh_devices"] == 8 and grid["mesh_axes"] == {"data": 8, "model": 1}
    ref = RefScorer(model_name="mlp", params=params, mesh=ref_make_mesh(), use_fused=True,
                    batch_sizes=(16, 128, 1024))
    assert ref.fused
    np.testing.assert_allclose(got, ref.score(ds.X[:256]), rtol=5e-2, atol=5e-3)


def test_pipelined_bulk_scoring_on_mesh(ds, params):
    s = Scorer("mlp", params=params, mesh=make_mesh(CPU8), batch_sizes=(128, 1024))
    out = s.score_pipelined(ds.X[:3000], depth=3)
    assert out.shape == (3000,)
    ref = _ref(params).score_pipelined(ds.X[:3000], depth=1)
    np.testing.assert_allclose(out, ref, **BF16)


def test_mesh_device_must_match_and_keeps_the_f32_wire(params):
    from ccfd_tpu.ops import quant as ref_quant

    mesh = make_mesh(CPU8)
    with pytest.raises(ValueError, match="shards lie on"):
        Scorer("mlp", params=params, mesh=mesh, device="cuda")
    q8 = Scorer("mlp_q8", params=jax.tree.map(np.asarray, ref_quant.quantize_mlp(params)),
                mesh=mesh)
    # the int8 wire (B3) stays single-device: a mesh serves B2
    assert not q8.int8_wire and q8.kernel_name == "fused_mlp_q8"
