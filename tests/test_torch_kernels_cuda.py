"""Kernel B1 on the card vs its plain PyTorch version (marker ``cuda``).

Skips where there is no CUDA card; the skip is decided inside the fixture,
never at import. On the card:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerance 1e-3 in probability: the kernel sums in another order than the
plain version, and a bf16 rounding of h may then flip one ulp.
"""

import numpy as np
import pytest
import torch

from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.models import mlp
from ccfd_tpu_torch.ops import fused_mlp
from ccfd_tpu_torch.params import load_params

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def rows():
    return kaggle_surrogate(n=20_000).X


def _kp(params, dev):
    return fused_mlp.pack_for_kernel(fused_mlp.fold_for_kernel(params), dev)


def _random_params(rows, hidden, seed=0):
    g = torch.Generator().manual_seed(seed)
    return mlp.set_normalizer(mlp.init(g, hidden=hidden), rows.mean(0), rows.std(0))


@pytest.mark.parametrize("hidden", [16, 64, 256])
@pytest.mark.parametrize("batch", [1, 63, 64, 100, 4096])
def test_kernel_matches_plain_version(dev, rows, hidden, batch):
    kp = _kp(_random_params(rows, hidden, seed=hidden), dev)
    x = torch.from_numpy(rows[:batch]).to(torch.bfloat16).to(dev)
    before = fused_mlp.launches.value
    p, z = fused_mlp.fused_mlp_score(kp, x, with_logits=True)
    assert fused_mlp.launches.value == before + 1
    p_ref, z_ref = fused_mlp.fused_mlp_reference(kp, x)
    torch.cuda.synchronize()
    assert p.shape == (batch,) and torch.isfinite(p).all()
    assert (p - p_ref).abs().max().item() <= 1e-3
    assert (z - z_ref).abs().max().item() <= 1e-2 * max(1.0, z_ref.abs().max().item())
    assert torch.equal(p >= 0.5, p_ref >= 0.5)


def test_kernel_on_checkpoint(dev, rows):
    kp = _kp(load_params(), dev)
    x = torch.from_numpy(rows[:16384]).to(torch.bfloat16).to(dev)
    p = fused_mlp.fused_mlp_score(kp, x)
    p_ref = fused_mlp.fused_mlp_reference(kp, x)[0]
    torch.cuda.synchronize()
    assert (p - p_ref).abs().max().item() <= 1e-3


def test_rows_are_independent_of_the_batch(dev, rows):
    kp = _kp(load_params(), dev)
    x = torch.from_numpy(rows[:1000]).to(torch.bfloat16).to(dev)
    whole = fused_mlp.fused_mlp_score(kp, x)
    part = fused_mlp.fused_mlp_score(kp, x[:77].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(whole[:77], part)


def test_wrapper_checks_inputs(dev, rows):
    kp = _kp(load_params(), dev)
    x = torch.from_numpy(rows[:8]).to(dev)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_mlp.fused_mlp_score(kp, x)  # float32 rows
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp.fused_mlp_score(kp, xb.t().contiguous().t())
    with pytest.raises(ValueError, match="pack_for_kernel"):
        fused_mlp.fused_mlp_score({**kp, "w2": kp["w2"].float()}, xb)
    with pytest.raises(ValueError, match="pack_for_kernel"):
        fused_mlp.fused_mlp_score(_kp(load_params(), "cpu"), xb)
    before = fused_mlp.launches.value
    assert fused_mlp.fused_mlp_score(kp, xb[:0]).shape == (0,)
    assert fused_mlp.launches.value == before


def test_scorer_on_the_card_goes_through_the_kernel(dev, rows):
    from ccfd_tpu_torch.serving.scorer import Scorer

    s = Scorer(params=load_params(), device=dev)
    s.warmup()
    before = fused_mlp.launches.value
    got = s.score(rows[:5000])
    assert fused_mlp.launches.value - before == s.dispatch_total() == 1
    cpu = Scorer(params=load_params(), device="cpu").score(rows[:5000])
    np.testing.assert_allclose(got, cpu, rtol=0, atol=1e-3)
