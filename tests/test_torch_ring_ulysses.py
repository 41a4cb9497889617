"""Sequence parallelism in the port (ops/ring_attention.py, ops/ulysses.py,
and the sharded SeqScorer) against the reference's (tests/test_ulysses.py,
tests/test_partition.py's seq cases).

The same (B, H, L, D) inputs, made with numpy from a seed, go through the
reference's ring and Ulysses attention on the conftest's virtual CPU
devices and through the port's on logical CPU shards. Tolerances are the
reference tests': 1e-5 against dense attention in f32 (2e-5 where the
reference states it), 1e-2 in bf16, 2e-2/2e-3 for the sharded SeqScorer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_helpers  # noqa: F401 - one intra-op thread

from ccfd_tpu.models import seq as ref_seq
from ccfd_tpu.ops.ring_attention import reference_attention as ref_dense
from ccfd_tpu.ops.ring_attention import ring_attention as ref_ring
from ccfd_tpu.ops.ulysses import ulysses_attention as ref_ulysses
from ccfd_tpu.parallel.mesh import make_mesh as ref_make_mesh
from ccfd_tpu.parallel.mesh import make_named_mesh as ref_named_mesh
from ccfd_tpu.parallel.partition import DataParallelPartitioner as RefDP
from ccfd_tpu.serving.history import SeqScorer as RefSeqScorer
from ccfd_tpu_torch.models import seq
from ccfd_tpu_torch.ops.ring_attention import reference_attention, ring_attention
from ccfd_tpu_torch.ops.ulysses import ulysses_attention
from ccfd_tpu_torch.params import from_jax_model_params
from ccfd_tpu_torch.parallel.mesh import make_mesh, make_named_mesh
from ccfd_tpu_torch.parallel.partition import DataParallelPartitioner
from ccfd_tpu_torch.serving.history import SeqScorer

CPU8 = [torch.device("cpu")] * 8


def _qkv(seed: int, shape: tuple) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("mp", [2, 4, 8])
def test_ring_exact_vs_dense_and_the_reference(mp):
    qkv = _qkv(0, (2, 4, 64, 16))
    got = ring_attention(*_t(qkv), make_mesh(CPU8, model_parallel=mp), "model")
    dense = reference_attention(*_t(qkv))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)
    ref = ref_ring(*_j(qkv), ref_make_mesh(model_parallel=mp), "model")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_ring_bf16_within_the_bf16_bar():
    qkv = _qkv(1, (2, 4, 64, 32))
    got = ring_attention(*_t(qkv, torch.bfloat16), make_mesh(CPU8, model_parallel=4), "model")
    assert got.dtype == torch.bfloat16
    dense = reference_attention(*_t(qkv, torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), dense.float().numpy(), rtol=0, atol=1e-2)
    ref = ref_ring(*_j(qkv, jnp.bfloat16), ref_make_mesh(model_parallel=4), "model")
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=1e-2)


def test_ulysses_exact_vs_reference():
    """8-way all-to-all attention == plain softmax attention (the reference
    test's shapes) and == the reference's Ulysses."""
    qkv = _qkv(0, (2, 8, 64, 16))
    got = ulysses_attention(*_t(qkv), make_mesh(CPU8, model_parallel=8), "model")
    np.testing.assert_allclose(got.numpy(), reference_attention(*_t(qkv)).numpy(),
                               rtol=2e-5, atol=2e-5)
    ref = ref_ulysses(*_j(qkv), ref_make_mesh(model_parallel=8), axis_name="model")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ref_dense(*_j(qkv))),
                               reference_attention(*_t(qkv)).numpy(), rtol=1e-5, atol=1e-5)


def test_ulysses_and_ring_agree():
    qkv = _qkv(1, (2, 4, 32, 8))
    mesh = make_mesh(CPU8, model_parallel=4)
    ring = ring_attention(*_t(qkv), mesh, "model")
    uly = ulysses_attention(*_t(qkv), mesh, "model")
    np.testing.assert_allclose(uly.numpy(), ring.numpy(), rtol=2e-5, atol=2e-5)


def test_ulysses_rejects_indivisible_heads_and_sequence():
    mesh = make_mesh(CPU8, model_parallel=4)
    q = torch.zeros((1, 3, 16, 8))  # 3 heads over 4 shards
    with pytest.raises(ValueError, match="heads"):
        ulysses_attention(q, q, q, mesh, "model")
    q2 = torch.zeros((1, 4, 18, 8))  # L=18 over 4 shards
    with pytest.raises(ValueError, match="sequence length"):
        ulysses_attention(q2, q2, q2, mesh, "model")
    with pytest.raises(ValueError, match="does not split"):
        ring_attention(q2, q2, q2, mesh, "model")


@pytest.fixture(scope="module")
def seq_tree():
    return jax.tree.map(np.asarray, ref_seq.init(jax.random.PRNGKey(4)))


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_seq_model_with_sequence_parallel_attention_matches_the_reference(seq_tree, kind):
    """The full transformer forward with L sharded == dense attention, and
    == the reference's forward with its own sequence-parallel attention."""
    x = np.random.default_rng(5).normal(size=(2, 16, 30)).astype(np.float32)
    port_fn = ring_attention if kind == "ring" else ulysses_attention
    ref_fn = ref_ring if kind == "ring" else ref_ulysses
    mesh, rmesh = make_mesh(CPU8, model_parallel=4), ref_make_mesh(model_parallel=4)
    p = from_jax_model_params("seq", seq_tree)
    got = seq.logits(p, torch.from_numpy(x), torch.float32,
                     attention_fn=lambda q, k, v: port_fn(q, k, v, mesh, "model"))
    dense = seq.logits(p, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), dense.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    ref = ref_seq.logits(seq_tree, jnp.asarray(x), compute_dtype=jnp.float32,
                         attention_fn=lambda q, k, v: ref_fn(q, k, v, rmesh, "model"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _flat(node, path=""):
    """``{"/"-joined path: leaf}`` of a tree of dicts and lists."""
    if isinstance(node, dict):
        return {k: v for key, sub in node.items() for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(node, (list, tuple)):
        return {k: v for i, sub in enumerate(node) for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: node}


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_attention_is_differentiable(seq_tree, kind):
    """Backward through the ring's rotations or both all-to-alls gives the
    dense attention's gradients, and the reference's (its test's bars)."""
    x = np.random.default_rng(5).normal(size=(2, 16, 30)).astype(np.float32)
    y = np.asarray([0.0, 1.0], np.float32)
    mesh = make_mesh(CPU8, model_parallel=4)
    port_fn = ring_attention if kind == "ring" else ulysses_attention

    def grads(attn):
        p = from_jax_model_params("seq", seq_tree)
        leaves = _flat(p)
        for t in leaves.values():
            t.requires_grad_(True)
        seq.loss_fn(p, torch.from_numpy(x), torch.from_numpy(y), compute_dtype=torch.float32,
                    attention_fn=attn).backward()
        return {k: t.grad for k, t in leaves.items()}

    g_sp = grads(lambda q, k, v: port_fn(q, k, v, mesh, "model"))
    g_dense = grads(None)
    ref_g = _flat(jax.grad(lambda p: ref_seq.loss_fn(p, jnp.asarray(x), jnp.asarray(y),
                                                     compute_dtype=jnp.float32))(seq_tree))
    checked = 0
    for path, g in g_sp.items():
        if g is None:  # the normalizer: data, no gradient
            assert g_dense[path] is None
            continue
        np.testing.assert_allclose(g.numpy(), g_dense[path].numpy(), rtol=5e-3, atol=5e-4,
                                   err_msg=path)
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_g[path]), rtol=5e-3, atol=5e-4,
                                   err_msg=path)
        checked += 1
    assert checked > 10


def _seq_pair(seq_tree, part, ref_part, seq_parallel, n_rows=24):
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(n_rows, 30)).astype(np.float32)
    ids = [f"c{i % 6}" for i in range(n_rows)]
    port = SeqScorer(from_jax_model_params("seq", seq_tree), length=8,
                     batch_sizes=(n_rows,), compute_dtype="float32", max_customers=64,
                     partitioner=part, seq_parallel=seq_parallel)
    ref = RefSeqScorer(seq_tree, length=8, batch_sizes=(n_rows,), compute_dtype="float32",
                       max_customers=64, partitioner=ref_part, seq_parallel=seq_parallel)
    single = SeqScorer(from_jax_model_params("seq", seq_tree), length=8,
                       batch_sizes=(n_rows,), compute_dtype="float32", max_customers=64,
                       device="cpu")
    for s in (port, ref, single):
        s.score(rows, ids)  # fill histories identically
    return port, port.score(rows, ids), ref.score(rows, ids), single.score(rows, ids)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_seq_scorer_sequence_parallel_matches_the_reference(seq_tree, kind):
    """``SeqScorer(seq_parallel=ring|ulysses)`` on a (4, 1, 2) mesh: L over
    tp, the batch over data; scores within 2e-2/2e-3 of the reference's
    sharded SeqScorer and of the port's single-device one."""
    port, got, ref, single = _seq_pair(
        seq_tree, DataParallelPartitioner(make_named_mesh(CPU8, tp=2)),
        RefDP(ref_named_mesh(jax.devices()[:8], tp=2)), kind)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(got, single, rtol=2e-2, atol=2e-3)
    grid = port.executable_grid()
    assert grid["seq_parallel"] == kind and grid["seq_parallel_engaged"] is True
    assert grid["mesh_devices"] == 8


def test_seq_scorer_falls_back_where_the_axis_does_not_divide(seq_tree, caplog):
    """A bucket whose L the sp axis does not divide serves dense attention
    (warned once) and still matches; the inventory says nothing engaged."""
    import logging

    rng = np.random.default_rng(6)
    rows = rng.normal(size=(16, 30)).astype(np.float32)
    part = DataParallelPartitioner(make_named_mesh(CPU8[:6], tp=3))
    with caplog.at_level(logging.WARNING):
        s = SeqScorer(from_jax_model_params("seq", seq_tree), length=8, batch_sizes=(16,),
                      compute_dtype="float32", max_customers=64, partitioner=part,
                      seq_parallel="ring")
        got = s.score(rows, list(range(16)))
    single = SeqScorer(from_jax_model_params("seq", seq_tree), length=8, batch_sizes=(16,),
                       compute_dtype="float32", max_customers=64, device="cpu")
    np.testing.assert_allclose(got, single.score(rows, list(range(16))),
                               rtol=2e-2, atol=2e-3)
    assert s.executable_grid()["seq_parallel_engaged"] is False
    assert any("cannot shard" in r.getMessage() for r in caplog.records)


def test_seq_scorer_seq_parallel_needs_a_tp_axis_and_a_mesh(seq_tree):
    p = from_jax_model_params("seq", seq_tree)
    with pytest.raises(ValueError, match="tp/model mesh axis"):
        SeqScorer(p, length=8, batch_sizes=(16,),
                  partitioner=DataParallelPartitioner(make_named_mesh(CPU8)),
                  seq_parallel="ring")
    with pytest.raises(ValueError, match="needs a mesh"):
        SeqScorer(p, length=8, batch_sizes=(16,), device="cpu", seq_parallel="ulysses")
