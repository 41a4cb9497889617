"""Port's models/mlp.py vs the JAX reference ccfd_tpu/models/mlp.py.

Both follow the same rounding points (normalize in f32, bf16 operands, f32
accumulation, bf16 after each hidden relu); only the matmuls' summation
order differs, so probabilities and logits agree to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.data.ccfd import synthetic_dataset
from ccfd_tpu.models import mlp as jax_mlp
from ccfd_tpu_torch.models import mlp
from ccfd_tpu_torch.models.registry import get_model
from ccfd_tpu_torch.params import from_jax_params, to_numpy
from tests.torch_helpers import mlp_tree


@pytest.fixture(scope="module")
def rows():
    return synthetic_dataset(n=256, fraud_rate=0.2, seed=3).X


@pytest.mark.parametrize("hidden", [64, 256])
def test_apply_bf16_matches_reference(rows, hidden):
    tree = mlp_tree(rows, hidden=hidden, seed=hidden)
    params = from_jax_params(tree)
    x = torch.from_numpy(rows)
    ref_z = np.asarray(jax_mlp.logits(tree, jnp.asarray(rows), jnp.bfloat16))
    ref_p = np.asarray(jax_mlp.apply(tree, jnp.asarray(rows), compute_dtype=jnp.bfloat16))
    got_z = mlp.logits(params, x, torch.bfloat16).numpy()
    got_p = mlp.apply(params, x, torch.bfloat16).numpy()
    assert got_p.shape == (256,) and got_p.dtype == np.float32
    assert 0.01 < np.median(ref_p) < 0.99  # not saturated
    np.testing.assert_allclose(got_p, ref_p, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_z, ref_z, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hidden", [64, 256])
def test_apply_f32_matches_reference(rows, hidden):
    tree = mlp_tree(rows, hidden=hidden, seed=hidden + 1)
    got = mlp.apply(from_jax_params(tree), torch.from_numpy(rows), torch.float32).numpy()
    ref = np.asarray(jax_mlp.apply(tree, jnp.asarray(rows), compute_dtype=jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hidden", [64, 256])
def test_apply_numpy_matches_reference(rows, hidden):
    tree = mlp_tree(rows, hidden=hidden, seed=hidden + 2)
    got = mlp.apply_numpy(to_numpy(from_jax_params(tree)), rows)
    ref = jax_mlp.apply_numpy(tree, rows)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_init_is_seeded_he_init():
    a = mlp.init(torch.Generator().manual_seed(5), hidden=64)
    b = mlp.init(torch.Generator().manual_seed(5), hidden=64)
    c = mlp.init(torch.Generator().manual_seed(6), hidden=64)
    assert [tuple(layer["w"].shape) for layer in a["layers"]] == [(30, 64), (64, 64), (64, 1)]
    assert torch.equal(a["layers"][1]["w"], b["layers"][1]["w"])
    assert not torch.equal(a["layers"][1]["w"], c["layers"][1]["w"])
    std = a["layers"][1]["w"].std().item()
    assert abs(std - (2.0 / 64) ** 0.5) < 0.02
    assert torch.equal(a["norm"]["sigma"], torch.ones(30))


def test_set_normalizer_guards_zero_std(rows):
    params = mlp.init(torch.Generator().manual_seed(0), hidden=16)
    std = rows.std(0)
    std[3] = 0.0
    p = mlp.set_normalizer(params, rows.mean(0), std)
    assert p["norm"]["sigma"][3].item() == 1.0
    assert p["layers"] is params["layers"]


def test_registry_serves_mlp_only():
    """The ported families: ``mlp``, ``mlp_q8``, ``logreg``/``modelfull``,
    ``gbt``/``gbt_mxu`` and, since A15a, ``seq``/``seq_q8`` (neither
    trainable, as the reference registers them); an unknown name names the
    queue in ROADMAP.md."""
    from ccfd_tpu_torch.models import logreg, seq, trees
    from ccfd_tpu_torch.ops import quant, seq_quant

    assert get_model("mlp").apply is mlp.apply
    assert get_model("mlp_q8").apply is quant.apply
    assert get_model("modelfull").apply is logreg.apply
    assert get_model("gbt_mxu").apply is trees.apply_mxu
    assert get_model("seq").apply is seq.apply and not get_model("seq").trainable
    assert get_model("seq_q8").apply is seq_quant.apply
    assert not get_model("seq_q8").trainable
    with pytest.raises(KeyError, match="ROADMAP.md"):
        get_model("seq_sharded")
