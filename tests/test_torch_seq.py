"""The port's seq family (models/seq.py, ops/seq_quant.py,
ops/ring_attention.py, data/sequences.py) against the reference's, on the
CPU, on the params the operator serves (the reference's
``seq.init(PRNGKey(0))`` with its normalizer, ``assets/seq_init.npz``) and
seeded surrogate histories, each of a seeded depth with zero left-pad.

Tolerances (max |Δ| over the rows):
- float32: 1e-5 in the logit and in p (only summation order differs);
- bfloat16: 5e-2 in the logit and 1e-2 in p. The dense sums run in f32 in
  two orders, so a sum near a bf16 rounding boundary rounds apart and the
  one-ulp step (2^-8 relative) carries through the blocks; measured
  1.1e-2 in the logit and 3.7e-3 in p on 256 histories;
- seq_q8 (held against the reference's seq_q8, never against f32): 2e-2
  in p at either compute dtype. An ulp apart in a layer norm or a GELU
  can move a token's ``rint(h / s)`` to the next integer (about one row in
  ten); measured 4.5e-3 (f32) and 8.6e-3 (bf16) in p on 256 histories.
  The embed's output, whose input is the same f32 rows, is bit-equal, and
  the int32 sums are exact.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.data.ccfd import Dataset as RefDataset
from ccfd_tpu.data.sequences import build_windows as ref_build_windows
from ccfd_tpu.models import seq as ref_seq
from ccfd_tpu.ops import ring_attention as ref_attn
from ccfd_tpu.ops import seq_quant as ref_q8
from ccfd_tpu_torch.data.ccfd import Dataset
from ccfd_tpu_torch.data.sequences import build_windows
from ccfd_tpu_torch.models import seq
from ccfd_tpu_torch.ops import ring_attention, seq_quant
from ccfd_tpu_torch.params import from_jax_model_params, load_tree, to_numpy
from tests import torch_helpers  # noqa: F401  (one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "ccfd_tpu_torch" / "assets"
sys.path.insert(0, str(REPO / "tools"))
import export_torch_seq_assets as assets  # noqa: E402

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = {"f32": 1e-5, "bf16": 5e-2}
P_TOL = {"f32": 1e-5, "bf16": 1e-2}
Q8_P_TOL = 2e-2


@pytest.fixture(scope="module")
def ref_params():
    return assets.reference_seq_params()


@pytest.fixture(scope="module")
def port_params():
    return load_tree(ASSETS / "seq_init.npz")


def histories(n: int, length: int, seed: int = 1) -> np.ndarray:
    from ccfd_tpu_torch.data.ccfd import synthetic_dataset

    ds = synthetic_dataset(n=2048, fraud_rate=0.05, seed=seed)
    rng = np.random.default_rng(seed)
    x = ds.X[rng.integers(0, ds.n, size=(n, length))].astype(np.float32)
    depth = rng.integers(1, length + 1, size=n)
    depth[0] = 1
    for i, d in enumerate(depth):
        x[i, : length - d] = 0.0
    return x


def test_the_asset_is_the_references_operator_init(ref_params, port_params):
    """``seq_init.npz`` equals the reference's params, regenerated."""
    want = to_numpy(from_jax_model_params("seq", ref_params))
    got = to_numpy(port_params)
    flat_w = {k: v for k, v in _flat(want)}
    flat_g = {k: v for k, v in _flat(got)}
    assert flat_w.keys() == flat_g.keys() and len(flat_g) == 32
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def test_the_golden_file_is_the_references_and_the_port_meets_it(ref_params, port_params):
    g = np.load(ASSETS / "seq_golden.npz")
    want = assets.golden(ref_params)
    assert set(g.files) == set(want)
    np.testing.assert_array_equal(g["x"], want["x"])
    np.testing.assert_array_equal(g["depth"], want["depth"])
    for k in want:
        if k.startswith("p_"):
            np.testing.assert_allclose(g[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    x = torch.from_numpy(g["x"])
    q8 = seq_quant.quantize_seq(port_params)
    for name, (_, tdt) in DT.items():
        got = seq.apply_serving(port_params, x, tdt, pos_length=assets.LENGTH).numpy()
        np.testing.assert_allclose(got, g[f"p_seq_{name}"], rtol=0, atol=P_TOL[name])
        got = seq_quant.apply(q8, x, tdt, pos_length=assets.LENGTH).numpy()
        np.testing.assert_allclose(got, g[f"p_seq_q8_{name}"], rtol=0, atol=Q8_P_TOL)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("length", [1, 8, 24])
def test_logits_match_the_reference(ref_params, port_params, name, length):
    jdt, tdt = DT[name]
    x = histories(48, length, seed=length)
    want = np.asarray(ref_seq.logits(ref_params, jnp.asarray(x), jdt))
    got = seq.logits(port_params, torch.from_numpy(x), tdt).numpy()
    assert got.dtype == np.float32 and got.shape == (48,)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL[name])


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("length,pos_length", [(64, 64), (8, 64), (1, 64), (16, None)])
def test_readout_and_serving_match_the_reference(ref_params, port_params, name, length,
                                                 pos_length):
    """``logits_readout`` and ``apply_serving``, positions anchored as the
    last L rows of a ``pos_length`` table."""
    jdt, tdt = DT[name]
    x = histories(64, length, seed=100 + length)
    want = np.asarray(ref_seq.logits_readout(ref_params, jnp.asarray(x), jdt,
                                             pos_length=pos_length))
    got = seq.logits_readout(port_params, torch.from_numpy(x), tdt,
                             pos_length=pos_length).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL[name])
    want = np.asarray(ref_seq.apply_serving(ref_params, jnp.asarray(x), jdt,
                                            pos_length=pos_length))
    got = seq.apply_serving(port_params, torch.from_numpy(x), tdt,
                            pos_length=pos_length).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=P_TOL[name])


def test_readout_equals_the_full_graph_and_anchoring_moves_positions(port_params):
    x = torch.from_numpy(histories(32, 16, seed=7))
    full = seq.logits(port_params, x, torch.float32)
    np.testing.assert_allclose(seq.logits_readout(port_params, x, torch.float32).numpy(),
                               full.numpy(), rtol=0, atol=1e-5)
    # the same 16 tokens at the end of a 64-long table are other positions
    moved = seq.logits_readout(port_params, x, torch.float32, pos_length=64)
    assert np.abs(moved.numpy() - full.numpy()).max() > 1e-3
    pos = seq._positions(64, seq.D_MODEL)
    np.testing.assert_allclose(pos[-16:].numpy(),
                               np.asarray(ref_seq._positions(64, seq.D_MODEL))[-16:],
                               rtol=0, atol=1e-5)  # f32 sin/cos of angles up to 63
    # the sin half, then the cos half, concatenated (not interleaved)
    angles = np.arange(64)[:, None] * np.exp(
        -np.log(10000.0) * 2.0 * np.arange(64)[None, :] / seq.D_MODEL)
    np.testing.assert_allclose(pos[:, :64].numpy(), np.sin(angles), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pos[:, 64:].numpy(), np.cos(angles), rtol=0, atol=1e-4)


def test_layer_norm_gelu_and_attention_are_the_references():
    rng = np.random.default_rng(3)
    h = rng.normal(size=(4, 6, 128)).astype(np.float32) * 3
    scale = rng.normal(size=128).astype(np.float32)
    bias = rng.normal(size=128).astype(np.float32)
    for name, (jdt, tdt) in DT.items():
        want = np.asarray(ref_seq._layer_norm(jnp.asarray(h).astype(jdt), scale, bias),
                          np.float32)
        got = seq._layer_norm(torch.from_numpy(h).to(tdt), torch.from_numpy(scale),
                              torch.from_numpy(bias)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 if name == "f32" else 0.05)
    want = np.asarray(jax.nn.gelu(jnp.asarray(h)))
    np.testing.assert_allclose(seq._gelu(torch.from_numpy(h), torch.float32).numpy(), want,
                               rtol=0, atol=1e-5)
    q, k, v = (rng.normal(size=(2, 4, 9, 32)).astype(np.float32) for _ in range(3))
    want = np.asarray(ref_attn.reference_attention(*map(jnp.asarray, (q, k, v))))
    got = ring_attention.reference_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # one query against nine keys (the readout block's shape), bf16
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q[:, :, -1:], k, v))
    want = np.asarray(ref_attn.reference_attention(qb, kb, vb), np.float32)
    got = ring_attention.reference_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q[:, :, -1:], k, v))).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_quantize_seq_is_bit_equal(ref_params, port_params):
    want = to_numpy(from_jax_model_params("seq_q8", ref_q8.quantize_seq(ref_params)))
    got = to_numpy(seq_quant.quantize_seq(port_params))
    fw, fg = dict(_flat(want)), dict(_flat(got))
    assert fw.keys() == fg.keys()
    for k in fw:
        assert fg[k].dtype == fw[k].dtype, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    assert fg["/embed/wq"].dtype == np.int8
    assert seq_quant.is_quantized(seq_quant.quantize_seq(port_params))
    assert not seq_quant.is_quantized(port_params)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("length,pos_length", [(64, 64), (8, 64), (1, 64)])
def test_seq_q8_matches_the_references_seq_q8(ref_params, port_params, name, length,
                                              pos_length):
    jdt, tdt = DT[name]
    x = histories(64, length, seed=200 + length)
    want = np.asarray(ref_q8.apply(ref_q8.quantize_seq(ref_params), jnp.asarray(x), jdt,
                                   pos_length=pos_length))
    got = seq_quant.apply(seq_quant.quantize_seq(port_params), torch.from_numpy(x), tdt,
                          pos_length=pos_length).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=Q8_P_TOL)


def test_q8_embed_is_bit_equal_and_int_sums_exact(ref_params, port_params):
    x = histories(32, 16, seed=5)
    h = (x - np.asarray(ref_params["norm"]["mu"])) / np.asarray(ref_params["norm"]["sigma"])
    rq, tq = ref_q8.quantize_seq(ref_params), seq_quant.quantize_seq(port_params)
    for name, (jdt, tdt) in DT.items():
        want = np.asarray(ref_q8._q_dense(jnp.asarray(h), rq["embed"], jdt), np.float32)
        got = seq_quant._q_dense(torch.from_numpy(h), tq["embed"], tdt).float().numpy()
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, size=(64, 512), dtype=np.int8)
    w = rng.integers(-127, 128, size=(512, 128), dtype=np.int8)
    q[0], w[:, 0] = 127, 127  # the largest sum, 127 * 127 * 512
    acc = seq_quant._int_acc(torch.from_numpy(q), torch.from_numpy(w))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), q.astype(np.int64) @ w.astype(np.int64))


def test_build_windows_matches_the_reference():
    from ccfd_tpu_torch.data.ccfd import synthetic_dataset

    ds = synthetic_dataset(n=200, seed=4)
    for L, stride in ((1, 1), (16, 1), (16, 5), (200, 3)):
        X, y = build_windows(Dataset(ds.X, ds.y), L, stride)
        RX, Ry = ref_build_windows(RefDataset(ds.X, ds.y), L, stride)
        np.testing.assert_array_equal(X, RX)
        np.testing.assert_array_equal(y, Ry)
    with pytest.raises(ValueError, match="seq_len"):
        build_windows(Dataset(ds.X, ds.y), 201)


def test_registry_init_and_quantized_init_shapes():
    from ccfd_tpu_torch.models.registry import get_model

    p = get_model("seq").init(torch.Generator().manual_seed(0))
    assert p["blocks"][0]["qkv"]["w"].shape == (128, 384) and len(p["blocks"]) == 2
    assert p["blocks"][1]["mlp_in"]["w"].shape == (128, 512)
    assert p["embed"]["w"].shape == (30, 128) and p["head"]["w"].shape == (128, 1)
    q = get_model("seq_q8").init()
    assert q["embed"]["wq"].dtype == torch.int8
    out = get_model("seq").apply(p, torch.zeros((3, 4, 30)), torch.float32)
    assert out.shape == (3,) and torch.isfinite(out).all()
