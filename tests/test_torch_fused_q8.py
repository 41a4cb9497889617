"""Kernels B2 and B3: their plain PyTorch versions vs the JAX Pallas kernels.

The JAX kernels run with ``interpret=True`` on the CPU, tile 256, as
tests/test_fused_q8.py runs them. The plain versions follow the rounding
points of the served graph: true divisions and ``((acc * s) * scale) + b``
without a fused multiply-add. Tolerances are the reference's own: 1e-5 in
probability against the JAX kernels, 1e-6 for B3 against B2, and the host
prequantization bit for bit. Interpret mode runs the kernel body under
XLA's jit, whose rounding differs on about 1 row in 1,000 (see
tests/test_torch_quant.py); those rows are held against the op-by-op JAX
graph instead, and counted. The CUDA kernels themselves are held against
the plain versions on the card (tests/test_torch_kernels_q8_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.ops import fused_mlp_q8 as jax_fused
from ccfd_tpu.ops import quant as jax_quant
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.ops import fused_mlp_q8, quant
from ccfd_tpu_torch.params import load_params, to_numpy
from tests.torch_helpers import assert_matches_jax, mlp_tree

TREES = ["seed0", "seed1", "seed2", "seed3", "checkpoint"]


@pytest.fixture(scope="module")
def rows():
    return kaggle_surrogate(n=2048, seed=5).X


def _tree(rows, which: str) -> dict:
    if which == "checkpoint":
        return to_numpy(load_params())
    return mlp_tree(rows, hidden=256, seed=int(which[4:]))


def _kps(tree):
    """(JAX kernel params, the port's packed kernel params on the CPU, the
    JAX int8 tree)."""
    jqp = jax_quant.quantize_mlp(tree)
    kp = fused_mlp_q8.pack_for_kernel(
        fused_mlp_q8.fold_for_kernel(quant.quantize_mlp(tree)), "cpu")
    return jax_fused.fold_for_kernel(jqp), kp, jqp


def _eager_apply(jqp, x) -> np.ndarray:
    with jax.disable_jit():
        return np.asarray(jax_quant.apply(jqp, jnp.asarray(x)))


def _jax_b2(jkp, x, tile=256):
    return np.asarray(jax_fused.fused_mlp_q8_score(jkp, jnp.asarray(x), tile=tile,
                                                    interpret=True))


def _jax_b3(jkp, q, s, tile=256):
    return np.asarray(jax_fused.fused_mlp_q8_score_preq(
        jkp, jnp.asarray(q), jnp.asarray(s), tile=tile, interpret=True))


@pytest.mark.parametrize("which", TREES)
def test_plain_b2_and_b3_match_jax_kernels(rows, which):
    jkp, kp, jqp = _kps(_tree(rows, which))
    x = rows[:512]
    eager = _eager_apply(jqp, x)
    p2, z2 = fused_mlp_q8.fused_mlp_q8_score(kp, torch.from_numpy(x), with_logits=True)
    assert p2.shape == (512,) and p2.dtype == torch.float32
    assert_matches_jax(p2.numpy(), eager, _jax_b2(jkp, x))
    with jax.disable_jit():
        z_eager = np.asarray(jax_quant.logits(jqp, jnp.asarray(x)))
    np.testing.assert_allclose(z2.numpy(), z_eager, rtol=0, atol=1e-5)

    q, s = fused_mlp_q8.prequantize_rows_numpy(kp, x)
    p3, z3 = fused_mlp_q8.fused_mlp_q8_score_preq(
        kp, torch.from_numpy(q), torch.from_numpy(s), with_logits=True)
    assert_matches_jax(p3.numpy(), eager, _jax_b3(jkp, q, s))
    torch.testing.assert_close(p3, p2, rtol=0, atol=1e-6)
    torch.testing.assert_close(z3, z2, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["seed1", "checkpoint"])
def test_prequantize_equals_reference_bit_for_bit(rows, which):
    jkp, kp, _ = _kps(_tree(rows, which))
    q, s = fused_mlp_q8.prequantize_rows_numpy(kp, rows)
    rq, rs = jax_fused.prequantize_rows_numpy(jkp, rows)
    assert q.dtype == np.int8 and q.shape == (2048, 30) and s.shape == (2048, 1)
    assert q.tobytes() == rq.tobytes() and s.tobytes() == rs.tobytes()


def test_parity_survives_large_magnitude_normalizers(rows):
    """The reference's regression (tests/test_fused_q8.py:36-55): with a
    huge mu and a doubled sigma, a reciprocal multiply in place of the
    division flips quantization steps (4e-3 in p there)."""
    tree = mlp_tree(rows, hidden=256, seed=12)
    tree["norm"]["mu"] = tree["norm"]["mu"] + 3.0
    tree["norm"]["sigma"] = tree["norm"]["sigma"] * 2.0
    jkp, kp, jqp = _kps(tree)
    x = rows[:256]
    eager = _eager_apply(jqp, x)
    full = fused_mlp_q8.fused_mlp_q8_score(kp, torch.from_numpy(x)).numpy()
    assert_matches_jax(full, eager, _jax_b2(jkp, x))
    q, s = fused_mlp_q8.prequantize_rows_numpy(kp, x)
    rq, rs = jax_fused.prequantize_rows_numpy(jkp, x)
    assert q.tobytes() == rq.tobytes() and s.tobytes() == rs.tobytes()
    preq = fused_mlp_q8.fused_mlp_q8_score_preq(
        kp, torch.from_numpy(q), torch.from_numpy(s)).numpy()
    assert_matches_jax(preq, eager, _jax_b3(jkp, q, s))


def test_ragged_batch_matches_jax_kernel_on_padded_batch(rows):
    jkp, kp, _ = _kps(_tree(rows, "seed3"))
    padded = np.zeros((128, 30), np.float32)
    padded[:100] = rows[:100]
    ref = _jax_b2(jkp, padded, tile=128)[:100]
    p = fused_mlp_q8.fused_mlp_q8_score(kp, torch.from_numpy(rows[:100])).numpy()
    assert p.shape == (100,)
    np.testing.assert_allclose(p, ref, rtol=0, atol=1e-5)


def test_fold_lays_out_the_kernel_weights(rows):
    tree = _tree(rows, "seed0")
    qp = quant.quantize_mlp(tree)
    got = fused_mlp_q8.fold_for_kernel(qp)
    w1q, w2q = qp["layers"][0]["wq"], qp["layers"][1]["wq"]
    assert tuple(got["w1t"].shape) == (256, 32) and got["w1t"].dtype == torch.int8
    assert torch.equal(got["w1t"][:, :30], w1q.t())
    assert torch.count_nonzero(got["w1t"][:, 30:]).item() == 0
    assert torch.equal(got["w2t"], w2q.t())
    assert torch.equal(got["w3"], qp["layers"][2]["wq"].reshape(256))
    for i, (s, b) in enumerate((("s1", "b1"), ("s2", "b2"), ("s3", "b3"))):
        assert torch.equal(got[s], qp["layers"][i]["scale"].reshape(-1))
        assert torch.equal(got[b], qp["layers"][i]["b"].reshape(-1))
    np.testing.assert_array_equal(got["sigma"].numpy(), tree["norm"]["sigma"])


def _wide(rows: np.ndarray, features: int) -> np.ndarray:
    """``rows`` widened to ``features`` columns by repeating them."""
    reps = -(-features // rows.shape[1])
    return np.ascontiguousarray(np.concatenate([rows] * reps, axis=1)[:, :features])


def _bad(rows, kind: str) -> dict:
    if kind == "unquantized":
        return to_numpy(load_params())
    if kind == "depth2":
        return quant.quantize_mlp(mlp_tree(rows, hidden=64, depth=2))
    if kind == "features129":
        return quant.quantize_mlp(mlp_tree(_wide(rows, 129), hidden=64))
    if kind == "last1152":  # the reference's case: a last layer over the bound
        qp = quant.quantize_mlp(mlp_tree(rows, hidden=64))
        qp["layers"][2] = {"wq": torch.ones((1152, 1), dtype=torch.int8),
                           "scale": torch.ones(1), "b": torch.zeros(1)}
        return qp
    return quant.quantize_mlp(mlp_tree(rows, hidden=int(kind[6:])))


@pytest.mark.parametrize("kind,match", [
    ("unquantized", "3-layer quantized"),
    ("depth2", "3-layer quantized"),
    ("last1152", "1040"),
    ("features129", "at most 128 features"),
    ("hidden1088", "1040"),
])
def test_fold_refuses_what_the_kernels_do_not_take(rows, kind, match):
    with pytest.raises(ValueError, match=match):
        fused_mlp_q8.fold_for_kernel(_bad(rows, kind))


@pytest.mark.parametrize("features,hidden", [
    (40, 64), (30, 16), (30, 48), (30, 320), (30, 1040), (128, 256)])
def test_plain_b2_and_b3_match_jax_kernels_at_lifted_widths(rows, features, hidden):
    """Every width the reference's kernels serve: F up to its 128-lane
    bound, any H up to its integer-exact bound of 1,040."""
    x = _wide(rows[:64], features)
    tree = mlp_tree(x, hidden=hidden, seed=hidden)
    jkp, kp, jqp = _kps(tree)
    eager = _eager_apply(jqp, x)
    p2 = fused_mlp_q8.fused_mlp_q8_score(kp, torch.from_numpy(x)).numpy()
    assert_matches_jax(p2, eager, _jax_b2(jkp, x, tile=64))
    q, s = fused_mlp_q8.prequantize_rows_numpy(kp, x)
    p3 = fused_mlp_q8.fused_mlp_q8_score_preq(kp, torch.from_numpy(q), torch.from_numpy(s))
    assert_matches_jax(p3.numpy(), eager, _jax_b3(jkp, q, s, tile=64))
    np.testing.assert_allclose(p3.numpy(), p2, rtol=0, atol=1e-6)


def test_plan_fits_every_width_in_shared_memory():
    """The layout the CUDA source computes (``make_layout``): every F up to
    128 and H up to 1,040 fits one block with at least two ring stages;
    the served model (F=30, H=256) scores 64-row tiles with its weights
    resident, and the widest models 32-row tiles."""
    for features in (1, 30, 32, 33, 64, 128):
        for hidden in range(16, fused_mlp_q8.MAX_EXACT_HIDDEN + 1):
            p = fused_mlp_q8.plan(features, hidden)
            assert p["stages"] >= 2 and p["smem"] <= fused_mlp_q8.SMEM_LIMIT
            assert p["rows"] in (64, 32)
    served = fused_mlp_q8.plan(30, 256)
    assert (served["rows"], served["chunks"], served["stages"], served["resident"],
            served["smem"]) == (64, 5, 5, 1, 184_064)
    assert fused_mlp_q8.plan(30, 1040)["rows"] == 32
    assert fused_mlp_q8.plan(128, 1040)["smem"] == 232_192


@pytest.mark.parametrize("features,hidden", [(30, 256), (40, 48), (128, 1040), (30, 600)])
def test_stream_lays_out_the_weights_as_the_kernels_read_them(features, hidden):
    """Each W element sits at the offset of the source's layout, and the
    rest of the stream is zero padding."""
    rng = np.random.default_rng(features + hidden)
    w1t = torch.from_numpy(rng.integers(-127, 128, (hidden, -(-features // 32) * 32),
                                        dtype=np.int8))
    w1t[:, features:] = 0
    w2t = torch.from_numpy(rng.integers(-127, 128, (hidden, hidden), dtype=np.int8))
    stream = fused_mlp_q8.pack_stream(w1t, w2t, features)
    assert stream.dtype == torch.int8
    assert tuple(stream.shape) == fused_mlp_q8._want(features, hidden)["stream"][0]
    for layer, wt in ((1, w1t), (2, w2t)):
        n, k = np.meshgrid(np.arange(wt.shape[0]), np.arange(wt.shape[1]), indexing="ij")
        off = fused_mlp_q8.stream_offset(layer, k, n, features, hidden)
        assert torch.equal(stream[torch.from_numpy(off)], wt)
    assert torch.count_nonzero(stream).item() == (
        torch.count_nonzero(w1t) + torch.count_nonzero(w2t)).item()


def test_pack_gives_kernel_types(rows):
    kp = fused_mlp_q8.pack_for_kernel(
        fused_mlp_q8.fold_for_kernel(quant.quantize_mlp(mlp_tree(rows, hidden=64))), "cpu")
    f32, i8 = torch.float32, torch.int8
    want = {"mu": ((30,), f32), "sigma": ((30,), f32),
            "w1t": ((64, 32), i8), "s1": ((64,), f32), "b1": ((64,), f32),
            "w2t": ((64, 64), i8), "s2": ((64,), f32), "b2": ((64,), f32),
            "w3": ((64,), i8), "s3": ((1,), f32), "b3": ((1,), f32),
            "stream": ((64 * 48 + 64 * 80,), i8), "vec": ((4, 64), f32),
            "w3p": ((64,), i8)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in kp.items()} == want
    assert all(v.is_contiguous() for v in kp.values())


def test_cpu_tensors_take_plain_versions_without_counting(rows):
    kp = fused_mlp_q8.pack_for_kernel(
        fused_mlp_q8.fold_for_kernel(quant.quantize_mlp(mlp_tree(rows, hidden=64))), "cpu")
    x = torch.from_numpy(rows[:10])
    q, s = (torch.from_numpy(a) for a in fused_mlp_q8.prequantize_rows_numpy(kp, rows[:10]))
    before = (fused_mlp_q8.launches.value, fused_mlp_q8.launches_preq.value)
    p = fused_mlp_q8.fused_mlp_q8_score(kp, x)
    p3 = fused_mlp_q8.fused_mlp_q8_score_preq(kp, q, s)
    assert (fused_mlp_q8.launches.value, fused_mlp_q8.launches_preq.value) == before
    torch.testing.assert_close(p, fused_mlp_q8.fused_mlp_q8_reference(kp, x)[0], rtol=0, atol=0)
    torch.testing.assert_close(
        p3, fused_mlp_q8.fused_mlp_q8_preq_reference(kp, q, s)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_mlp_q8.fused_mlp_q8_score(kp, x.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_mlp_q8.fused_mlp_q8_score_preq(kp, q.to("meta"), s.to("meta"))


@pytest.mark.parametrize("batch,features,hidden,path", [
    (16, 30, 256, "cluster"), (128, 30, 256, "cluster"),
    (16384, 30, 256, "persistent"), (16, 30, 1040, "persistent"),
])
def test_path_for_takes_the_cluster_at_the_rest_buckets(batch, features, hidden, path):
    """B3's cluster launch covers the REST buckets of the served width; a
    full bucket and a width past a portable cluster keep the persistent
    grid."""
    assert fused_mlp_q8.path_for(batch, features, hidden) == path


def test_path_for_edges():
    """The crossover and the cluster bound (hp / 64 CTAs, at most 8) are
    inclusive; a shape the kernels do not take raises."""
    top = fused_mlp_q8.CLUSTER_MAX_BATCH
    assert top >= 128
    assert fused_mlp_q8.path_for(1, 30, 256) == "cluster"
    assert fused_mlp_q8.path_for(top, 30, 256) == "cluster"
    assert fused_mlp_q8.path_for(top + 1, 30, 256) == "persistent"
    assert fused_mlp_q8.path_for(0, 30, 256) == "persistent"
    assert fused_mlp_q8.path_for(16, 128, 512) == "cluster"  # a cluster of 8
    assert fused_mlp_q8.path_for(16, 30, 513) == "persistent"  # hp 576: 9 CTAs
    assert fused_mlp_q8.path_for(16, 1, 16) == "cluster"  # one CTA
    with pytest.raises(ValueError, match="features"):
        fused_mlp_q8.path_for(16, 129, 256)
    with pytest.raises(ValueError, match="1040"):
        fused_mlp_q8.path_for(16, 30, 1041)


def test_cluster_counter_is_on_the_gauge_and_cpu_tensors_do_not_move_it(rows):
    from ccfd_tpu_torch.serving.server import KERNEL_LAUNCHES

    counter = fused_mlp_q8.launches_preq_cluster
    assert counter in KERNEL_LAUNCHES
    assert counter.kernel == "fused_mlp_q8_preq.cluster"
    assert len({c.kernel for c in KERNEL_LAUNCHES}) == len(KERNEL_LAUNCHES)
    kp = fused_mlp_q8.pack_for_kernel(
        fused_mlp_q8.fold_for_kernel(quant.quantize_mlp(mlp_tree(rows, hidden=256))), "cpu")
    q, s = (torch.from_numpy(a) for a in fused_mlp_q8.prequantize_rows_numpy(kp, rows[:16]))
    before = (counter.value, fused_mlp_q8.launches_preq.value)
    fused_mlp_q8.fused_mlp_q8_score_preq(kp, q, s)
    assert (counter.value, fused_mlp_q8.launches_preq.value) == before


def _tool(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_card_tools_find_what_they_edit_in_the_source():
    """tools/torch_q8_phase_trace.py stamps the persistent body: it finds
    its anchors. The source's cluster bound is the Python mirror's, and it
    has no batch crossover (``CLUSTER_MAX_BATCH`` alone chooses)."""
    import re

    from ccfd_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_mlp_q8.cu").read_text()
    assert "kClusterMaxBatch" not in src
    ctas = re.search(r"constexpr int kClusterMaxCtas = (\d+);", src)
    assert ctas and int(ctas.group(1)) == fused_mlp_q8.CLUSTER_MAX_CTAS
    trace = _tool("torch_q8_phase_trace")
    assert trace.stamped_source(src).count("STAMP(") > len(trace.ANCHORS)
