"""The port's int8 model (ops/quant.py), its params file format and its
registry entry, vs the JAX package.

``quantize_mlp`` must equal the reference's bit for bit. ``apply`` and
``logits`` follow the served graph's rounding points (true divisions,
``((acc * s_x) * scale) + b`` without a fused multiply-add) and agree with
the JAX graph to 1e-5 in probability and in logits. The JAX graph is
evaluated op by op (``jax.disable_jit``): under ``jit`` XLA:CPU contracts
the dequant into an FMA and divides by 127 through a reciprocal, which
moves a quantization step on about 1 row in 1,000 (2 of 2,048 rows of
seed 2 here, by up to 2.2e-4 in p). The jitted graph is held at 1e-5 on
every other row, and those rows are counted.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.cli import _restore_q8_checkpoint
from ccfd_tpu.ops import quant as jax_quant
from ccfd_tpu.utils.metrics_math import roc_auc as jax_roc_auc
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.models import mlp
from ccfd_tpu_torch.models.registry import get_model
from ccfd_tpu_torch.ops import quant
from ccfd_tpu_torch.params import (
    flatten,
    from_jax_q8_params,
    load_params,
    save_params,
    to_numpy,
)
from ccfd_tpu_torch.utils.metrics_math import roc_auc
from tests.torch_helpers import assert_matches_jax, mlp_tree

REPO = Path(__file__).resolve().parents[1]
TREES = ["seed0", "seed1", "seed2", "seed3", "checkpoint"]


@pytest.fixture(scope="module")
def rows():
    return kaggle_surrogate(n=2048, seed=5).X


def _tree(rows, which: str) -> dict:
    if which == "checkpoint":
        return to_numpy(load_params())
    return mlp_tree(rows, hidden=256, seed=int(which[4:]))


def _jax_eager(fn, *args) -> np.ndarray:
    with jax.disable_jit():
        return np.asarray(fn(*args))


@pytest.mark.parametrize("which", TREES)
def test_quantize_mlp_equals_reference_bit_for_bit(rows, which):
    tree = _tree(rows, which)
    ref = jax.tree.map(np.asarray, jax_quant.quantize_mlp(tree))
    got = to_numpy(quant.quantize_mlp(tree))
    want = flatten(ref)
    for k, v in flatten(got).items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
        assert v.tobytes() == want[k].tobytes(), k
    assert got["layers"][1]["wq"].dtype == np.int8


def test_committed_asset_quantizes_to_the_committed_q8_checkpoint():
    ref = jax.tree.map(np.asarray,
                       _restore_q8_checkpoint(str(REPO / "checkpoints_q8")))
    got = flatten(quant.quantize_mlp(load_params()))
    want = flatten(ref)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("which", TREES)
def test_apply_and_logits_match_jax(rows, which):
    tree = _tree(rows, which)
    jqp = jax_quant.quantize_mlp(tree)
    qp = quant.quantize_mlp(tree)
    x = rows
    p = quant.apply(qp, torch.from_numpy(x)).numpy()
    z = quant.logits(qp, torch.from_numpy(x)).numpy()
    assert p.shape == (len(x),) and p.dtype == np.float32
    assert_matches_jax(p, _jax_eager(jax_quant.apply, jqp, jnp.asarray(x)),
                       np.asarray(jax_quant.apply(jqp, jnp.asarray(x))))
    z_eager = _jax_eager(jax_quant.logits, jqp, jnp.asarray(x))
    np.testing.assert_allclose(z, z_eager, rtol=0, atol=1e-5)


def test_random_params_spread_and_checkpoint_saturates(rows):
    """Why parity runs on both: the checkpoint's p saturates."""
    x = torch.from_numpy(rows)
    p_rand = quant.apply(quant.quantize_mlp(_tree(rows, "seed0")), x).numpy()
    p_ckpt = quant.apply(quant.quantize_mlp(_tree(rows, "checkpoint")), x).numpy()
    assert 0.05 < np.median(p_rand) < 0.95
    assert np.median(p_ckpt) < 1e-3


@pytest.mark.parametrize("which", ["seed1", "checkpoint"])
def test_apply_numpy_matches_reference(rows, which):
    tree = _tree(rows, which)
    ref = jax_quant.apply_numpy(jax.tree.map(np.asarray, jax_quant.quantize_mlp(tree)), rows)
    got = quant.apply_numpy(quant.quantize_mlp(tree), rows)
    np.testing.assert_array_equal(got, ref)


def test_registry_init_quantizes_a_seeded_mlp():
    spec = get_model("mlp_q8")
    got = spec.init(torch.Generator().manual_seed(3))
    want = quant.quantize_mlp(mlp.init(torch.Generator().manual_seed(3)))
    for k, v in flatten(want).items():
        np.testing.assert_array_equal(flatten(got)[k], v)
    assert got["layers"][0]["wq"].dtype == torch.int8
    x = torch.zeros((4, 30))
    assert spec.apply(got, x, torch.bfloat16).shape == (4,)


def test_register_with_base_params(rows):
    tree = _tree(rows, "seed3")
    quant.register(base_params={"layers": tree["layers"]})  # no normalizer
    try:
        got = get_model("mlp_q8").init()
        np.testing.assert_array_equal(got["norm"]["sigma"].numpy(), np.ones(30, np.float32))
        np.testing.assert_array_equal(
            got["layers"][2]["wq"].numpy(),
            np.asarray(jax_quant.quantize_mlp(tree)["layers"][2]["wq"]))
    finally:
        quant.register()


def test_roc_auc_matches_reference():
    rng = np.random.default_rng(1)
    y = rng.random(500) < 0.2
    s = np.round(rng.random(500), 2)  # ties
    assert roc_auc(y, s) == jax_roc_auc(y, s)
    with pytest.raises(ValueError, match="both classes"):
        roc_auc(np.zeros(4), np.ones(4))


def test_q8_params_file_round_trips_and_is_told_apart(tmp_path, rows):
    tree = _tree(rows, "seed1")
    jqp = jax.tree.map(np.asarray, jax_quant.quantize_mlp(tree))
    qp = from_jax_q8_params(jqp)
    assert qp["layers"][0]["wq"].dtype == torch.int8
    assert qp["layers"][0]["scale"].dtype == torch.float32
    save_params(qp, tmp_path / "q8.npz")
    with np.load(tmp_path / "q8.npz") as z:
        assert sorted(z.files) == sorted(
            ["norm/mu", "norm/sigma"] + [f"layers/{i}/{k}" for i in range(3)
                                         for k in ("wq", "scale", "b")])
        assert z["layers/1/wq"].dtype == np.int8
    back = load_params(tmp_path / "q8.npz")
    assert quant.is_quantized(back)
    for k, v in flatten(jqp).items():
        assert flatten(back)[k].tobytes() == v.tobytes(), k
    save_params(tree, tmp_path / "f32.npz")
    assert not quant.is_quantized(load_params(tmp_path / "f32.npz"))
