"""Kernel B1's plain PyTorch version vs the JAX Pallas kernel.

The JAX kernel runs with ``interpret=True`` on the CPU, as tests/test_ops.py
runs it. The plain version repeats the kernel's arithmetic with the same
rounding points, so they agree to 1e-5 in probability (7.4e-7 measured on
the committed checkpoint); logits are compared too because the committed
checkpoint saturates most probabilities. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.ops import fused_mlp as jax_fused
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.ops import fused_mlp
from ccfd_tpu_torch.params import from_jax_params, load_params, to_numpy
from tests.torch_helpers import mlp_tree


@pytest.fixture(scope="module")
def rows():
    return kaggle_surrogate(n=2048, seed=5).X


def _jax_kernel(tree, x: np.ndarray, tile: int) -> np.ndarray:
    kp = jax_fused.fold_for_kernel(tree)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return np.asarray(jax_fused.fused_mlp_score(kp, xb, tile=tile, interpret=True))


def _port(tree, x: np.ndarray):
    kp = fused_mlp.pack_for_kernel(
        fused_mlp.fold_for_kernel(from_jax_params(tree)), "cpu")
    p, z = fused_mlp.fused_mlp_score(
        kp, torch.from_numpy(x).to(torch.bfloat16), with_logits=True)
    return p.numpy(), z.numpy()


def _assert_logits_close(z: np.ndarray, ref_p: np.ndarray) -> None:
    """The JAX kernel returns only p: recover its logits where p is not
    saturated (so the inverse sigmoid is well conditioned) and compare."""
    ok = (ref_p > 1e-4) & (ref_p < 1 - 1e-4)
    assert ok.sum() >= 8
    ref_z = np.log(ref_p[ok].astype(np.float64)) - np.log1p(-ref_p[ok].astype(np.float64))
    np.testing.assert_allclose(z[ok], ref_z, rtol=0, atol=2e-3)


def test_fold_matches_reference(rows):
    tree = mlp_tree(rows, hidden=256, seed=1)
    tree["norm"]["sigma"][4] = 0.0  # the zero-sigma guard folds as 1
    ref = jax_fused.fold_for_kernel(tree)
    got = fused_mlp.fold_for_kernel(from_jax_params(tree))
    assert tuple(got["w1"].shape) == (32, 256)
    np.testing.assert_allclose(got["w1"][:30].numpy(), np.asarray(ref["w1"])[:30], rtol=1e-6)
    assert torch.count_nonzero(got["w1"][30:]).item() == 0
    np.testing.assert_allclose(got["b1"].numpy(), np.asarray(ref["b1"]), rtol=1e-6)
    for k in ("w2", "b2", "w3", "b3"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_plain_version_matches_jax_kernel_on_random_params(rows):
    tree = mlp_tree(rows, hidden=256, seed=2)
    x = rows[:256]
    ref = _jax_kernel(tree, x, tile=256)
    p, z = _port(tree, x)
    assert 0.01 < np.median(p) < 0.99
    np.testing.assert_allclose(p, ref, rtol=0, atol=1e-5)
    _assert_logits_close(z, ref)


def test_plain_version_matches_jax_kernel_on_checkpoint(rows):
    tree = to_numpy(load_params())
    x = rows[:256]
    ref = _jax_kernel(tree, x, tile=256)
    p, z = _port(tree, x)
    np.testing.assert_allclose(p, ref, rtol=0, atol=1e-5)
    _assert_logits_close(z, ref)


def test_ragged_batch_matches_jax_kernel_on_padded_batch(rows):
    tree = mlp_tree(rows, hidden=256, seed=3)
    padded = np.zeros((128, 30), np.float32)
    padded[:100] = rows[:100]
    ref = _jax_kernel(tree, padded, tile=128)[:100]
    p, _ = _port(tree, rows[:100])
    assert p.shape == (100,)
    np.testing.assert_allclose(p, ref, rtol=0, atol=1e-5)


def _wide(rows: np.ndarray, features: int) -> np.ndarray:
    """``rows`` widened (or cut) to ``features`` columns by repeating them."""
    reps = -(-features // rows.shape[1])
    return np.ascontiguousarray(np.concatenate([rows] * reps, axis=1)[:, :features])


@pytest.mark.parametrize("features,hidden", [
    (30, 8), (30, 40), (30, 272), (30, 512), (30, 1024), (40, 48), (128, 256),
    (30, 1025), (30, 2048), (30, 4096)])
def test_plain_version_matches_jax_kernel_at_lifted_widths(rows, features, hidden):
    """Every width the reference's kernel serves: any H (past 1,024 the
    kernel's wide layout) and F up to its 128-lane bound.

    Past H=1,024 two f32 summation orders flip a bf16 rounding of h now
    and then: at H=2,048 the JAX kernel itself lies 8.1e-5 in p from an f64
    evaluation with the same rounding points on 2 of these 64 rows, and the
    port 4.8e-6. There the port is held to 1e-5 against the JAX kernel on
    every row where the JAX kernel lies within 1e-5 of the f64 evaluation
    (at least 95% of rows), and to 1e-5 against the f64 evaluation on every
    row."""
    x = _wide(rows[:64], features)
    tree = mlp_tree(x, hidden=hidden, seed=4)
    ref = _jax_kernel(tree, x, tile=64)
    p, z = _port(tree, x)
    assert np.isfinite(z).all()
    if hidden <= fused_mlp.MAX_RESIDENT_H1:
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-5)
        return
    p64 = _f64_kernel(tree, x)
    agree = np.abs(ref - p64) <= 1e-5
    assert agree.mean() >= 0.95
    np.testing.assert_allclose(p[agree], ref[agree], rtol=0, atol=1e-5)
    np.testing.assert_allclose(p, p64, rtol=0, atol=1e-5)


def _f64_kernel(tree, x: np.ndarray) -> np.ndarray:
    """B1's arithmetic in float64 with its rounding points (bf16 operands,
    h rounded to bf16 after each relu): p with no summation-order noise."""
    kp = fused_mlp.pack_for_kernel(fused_mlp.fold_for_kernel(from_jax_params(tree)), "cpu")
    d = lambda t: t.double()  # noqa: E731
    xb = torch.from_numpy(x).to(torch.bfloat16)
    h = torch.relu(d(xb) @ d(kp["w1"][: x.shape[1]]) + d(kp["b1"])).to(torch.bfloat16)
    h = torch.relu(d(h) @ d(kp["w2"]) + d(kp["b2"])).to(torch.bfloat16)
    return torch.sigmoid((d(h) * d(kp["w3"])).sum(1) + d(kp["b3"])).numpy()


@pytest.mark.parametrize("features,hidden,match", [(129, 64, "at most 128 features")])
def test_widths_past_the_limits_raise(rows, features, hidden, match):
    tree = mlp_tree(_wide(rows[:8], features), hidden=hidden, seed=4)
    with pytest.raises(ValueError, match=match):
        fused_mlp.fold_for_kernel(from_jax_params(tree))


@pytest.mark.parametrize("features,hidden", [(30, 256), (40, 48), (128, 1024), (16, 272)])
def test_stream_lays_out_the_weights_as_the_kernel_reads_them(features, hidden):
    """Each W element sits at the offset of the source's swizzle formula,
    and undoing the layout gives W back."""
    rng = np.random.default_rng(features * hidden)
    w1 = torch.from_numpy(rng.normal(size=(-(-features // 16) * 16, hidden)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(hidden, hidden)).astype(np.float32))
    stream = fused_mlp.pack_stream(w1, w2)
    plan = fused_mlp.plan(features, hidden)
    assert stream.dtype == torch.uint8
    assert stream.numel() == (plan["k1p"] + plan["hp"]) * plan["hp"] * 2
    as_bf16 = stream.view(torch.bfloat16)
    for layer, w in ((1, w1), (2, w2)):
        k, n = np.meshgrid(np.arange(w.shape[0]), np.arange(w.shape[1]), indexing="ij")
        off = fused_mlp.stream_offset(layer, k, n, features, hidden)
        assert (off % 2 == 0).all()
        got = as_bf16[torch.from_numpy(off // 2)]
        assert torch.equal(got, w.to(torch.bfloat16))
    # every other byte of the stream is padding, and zero
    assert torch.count_nonzero(as_bf16).item() == (
        torch.count_nonzero(w1.to(torch.bfloat16)) + torch.count_nonzero(w2.to(torch.bfloat16)))


def test_plan_fits_every_width_in_shared_memory():
    """The layout the CUDA source computes (``make_layout``): every F up to
    128 and any H fits one block with at least two ring stages; h1 stays in
    shared memory up to H=1,024 and goes through the ring (wide) past it,
    each stage then one 32 KB chunk and one 8 KB h1 block; the served model
    (F=30, H=256) keeps its weights resident."""
    widths = list(range(1, 1200)) + [2048, 2049, 4096, 8192, 65536]
    for features in (1, 16, 30, 64, 65, 128):
        for hidden in widths:
            p = fused_mlp.plan(features, hidden)
            assert p["stages"] >= 2 and p["smem"] <= fused_mlp.SMEM_LIMIT
            assert p["wide"] == (hidden > fused_mlp.MAX_RESIDENT_H1)
            assert p["resident"] == 0 or not p["wide"]
    served = fused_mlp.plan(30, 256)
    assert served == {"k1p": 64, "hp": 256, "chunks": 5, "stages": 5,
                      "resident": 1, "wide": 0, "smem": 210_944}
    assert fused_mlp.plan(128, 1024)["stages"] == 2
    wide = fused_mlp.plan(30, 4096)
    assert wide["wide"] == 1 and wide["stages"] == 5
    assert wide["smem"] == 5 * (fused_mlp.STAGE_BYTES + fused_mlp.ATOM_BYTES) + (
        64 * 64 * 2 + 64 * 30 * 2 + 4 * 64 * 2 * 4 + 256)


def test_fold_rejects_wrong_depth(rows):
    tree = mlp_tree(rows, hidden=32, depth=2)
    with pytest.raises(ValueError, match="3-layer"):
        fused_mlp.fold_for_kernel(from_jax_params(tree))


def test_pack_gives_kernel_types(rows):
    kp = fused_mlp.pack_for_kernel(
        fused_mlp.fold_for_kernel(from_jax_params(mlp_tree(rows, hidden=64))), "cpu")
    want = {"w1": ((32, 64), torch.bfloat16), "b1": ((64,), torch.float32),
            "w2": ((64, 64), torch.bfloat16), "b2": ((64,), torch.float32),
            "w3": ((64,), torch.bfloat16), "b3": ((1,), torch.float32),
            "stream": (((64 + 128) * 128 * 2,), torch.uint8),
            "vec": ((3, 128), torch.float32)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in kp.items()} == want
    assert all(v.is_contiguous() for v in kp.values())


def test_cpu_tensor_takes_plain_version_without_counting(rows):
    kp = fused_mlp.pack_for_kernel(
        fused_mlp.fold_for_kernel(from_jax_params(mlp_tree(rows, hidden=64))), "cpu")
    x = torch.from_numpy(rows[:10]).to(torch.bfloat16)
    before = fused_mlp.launches.value
    p = fused_mlp.fused_mlp_score(kp, x)
    assert fused_mlp.launches.value == before
    torch.testing.assert_close(p, fused_mlp.fused_mlp_reference(kp, x)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_mlp.fused_mlp_score(kp, x.to("meta"))


def test_launch_counter_loses_no_increment():
    counter = fused_mlp.LaunchCounter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counter.inc() for _ in range(5000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter.value == 16 * 5000
    counter.reset()
    assert counter.value == 0


@pytest.mark.parametrize("batch,features,hidden,path", [
    (16, 30, 256, "cluster"), (128, 30, 256, "cluster"),
    (16384, 30, 256, "persistent"), (16, 30, 1024, "persistent"),
])
def test_path_for_takes_the_cluster_at_the_rest_buckets(batch, features, hidden, path):
    """B1's cluster launch covers the REST buckets of the served width; a
    full bucket and a width past a portable cluster keep the persistent
    grid."""
    assert fused_mlp.path_for(batch, features, hidden) == path


def test_path_for_edges():
    """The crossover and the cluster bound (hp / 64 CTAs, at most 8) are
    inclusive, at every F; a shape the kernel does not take raises."""
    top = fused_mlp.CLUSTER_MAX_BATCH
    assert top >= 128
    assert fused_mlp.path_for(0, 30, 256) == "persistent"
    assert fused_mlp.path_for(1, 30, 256) == "cluster"
    assert fused_mlp.path_for(top, 30, 256) == "cluster"
    assert fused_mlp.path_for(top + 1, 30, 256) == "persistent"
    assert fused_mlp.path_for(16, 30, 512) == "cluster"  # a cluster of 8
    assert fused_mlp.path_for(16, 30, 640) == "persistent"  # 10 CTAs
    assert fused_mlp.path_for(16, 30, 513) == "persistent"  # hp 640
    assert fused_mlp.path_for(16, 1, 1) == "cluster"  # hp 128: 2 CTAs
    assert fused_mlp.path_for(16, 128, 512) == "cluster"
    with pytest.raises(ValueError, match="features"):
        fused_mlp.path_for(16, 129, 256)


@pytest.mark.parametrize("features,hidden", [(30, 256), (30, 384), (128, 512), (1, 128)])
def test_a_ctas_slice_of_each_layer_two_chunk_is_contiguous(features, hidden):
    """The cluster CTA of rank r bulk-copies rows [64 r, 64 r + 64) of each
    layer-2 K block as one 8 KB slice: in the stream those rows' 64 inputs
    fill exactly the bytes [start, start + 8192) that the CUDA source
    computes, and layer 1 is the stream's first hp * k1p * 2 bytes."""
    plan = fused_mlp.plan(features, hidden)
    k1p, hp = plan["k1p"], plan["hp"]
    k, n = np.meshgrid(np.arange(k1p), np.arange(hp), indexing="ij")
    assert fused_mlp.stream_offset(1, k, n, features, hidden).max() < hp * k1p * 2
    for rank in range(hp // fused_mlp.GROUP):
        p = rank * fused_mlp.GROUP // fused_mlp.PART
        prow = min(fused_mlp.PART, hp - p * fused_mlp.PART)
        for kb in range(hp // fused_mlp.K_BLOCK):
            k, n = np.meshgrid(np.arange(kb * 64, kb * 64 + 64),
                               np.arange(rank * 64, rank * 64 + 64), indexing="ij")
            off = fused_mlp.stream_offset(2, k, n, features, hidden)
            start = (hp * k1p * 2 + p * fused_mlp.PART * hp * 2 + kb * prow * 128
                     + (rank * 64 - p * fused_mlp.PART) * 128)
            assert sorted(set((off // 2).ravel().tolist())) == list(
                range(start // 2, start // 2 + 4096))


def test_cluster_counter_is_on_the_gauge_and_cpu_tensors_do_not_move_it(rows):
    from ccfd_tpu_torch.serving.server import KERNEL_LAUNCHES

    counter = fused_mlp.launches_cluster
    assert counter in KERNEL_LAUNCHES
    assert counter.kernel == "fused_mlp_bf16.cluster"
    assert len({c.kernel for c in KERNEL_LAUNCHES}) == len(KERNEL_LAUNCHES)
    kp = fused_mlp.pack_for_kernel(
        fused_mlp.fold_for_kernel(from_jax_params(mlp_tree(rows, hidden=256))), "cpu")
    before = (counter.value, fused_mlp.launches.value)
    fused_mlp.fused_mlp_score(kp, torch.from_numpy(rows[:16]).to(torch.bfloat16))
    assert (counter.value, fused_mlp.launches.value) == before


def test_the_crossover_tool_finds_what_it_edits_in_b1s_source():
    """B1's source holds the cluster's bounds that ``path_for`` mirrors
    (kClusterMaxCtas, kGroup) and no batch crossover: the choice by batch
    is ``CLUSTER_MAX_BATCH`` alone, and tools/torch_q8_crossover.py runs
    both launches of the shipped library instead of editing the source."""
    import re

    from ccfd_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_mlp.cu").read_text()
    assert "kClusterMaxBatch" not in src
    for name, value in (("kClusterMaxCtas", fused_mlp.CLUSTER_MAX_CTAS),
                        ("kGroup", fused_mlp.GROUP)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
