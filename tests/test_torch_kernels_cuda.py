"""Kernel B1 on the card vs its plain PyTorch version (marker ``cuda``).

Skips where there is no CUDA card; the skip is decided inside the fixture,
never at import. On the card:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerance 1e-3 in probability up to H=256: the kernel sums in another
order than the plain version, and a bf16 rounding of h may then flip one
ulp. Wider, the flips grow with H and add to z like a random walk, so the
bar grows as sqrt(H / 256) (chip_smoke.py b1_tol_p).

B1 takes a cluster launch up to ``CLUSTER_MAX_BATCH`` rows where H needs at
most 8 CTAs of 64 columns (``path_for``); ``fused_mlp.launch`` runs either
launch at any batch. The two sum each row in one order, so a row's p and z
are the same bits on either.
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
    return mlp.set_normalizer(mlp.init(g, num_features=rows.shape[1], hidden=hidden),
                              rows.mean(0), rows.std(0))


def _wide(rows, features):
    reps = -(-features // rows.shape[1])
    return np.ascontiguousarray(np.concatenate([rows] * reps, axis=1)[:, :features])


def _check(kp, x, tol_p=None):
    if tol_p is None:
        tol_p = 1e-3 * max(1.0, kp["w2"].shape[0] / 256) ** 0.5
    before = fused_mlp.launches.value
    p, z = fused_mlp.fused_mlp_score(kp, x, with_logits=True)
    assert fused_mlp.launches.value == before + 1
    p_ref, z_ref = fused_mlp.fused_mlp_reference(kp, x)
    torch.cuda.synchronize()
    assert p.shape == (x.shape[0],) and torch.isfinite(p).all()
    assert (p - p_ref).abs().max().item() <= tol_p
    assert (z - z_ref).abs().max().item() <= 1e-2 * max(1.0, z_ref.abs().max().item())
    assert torch.equal(p >= 0.5, p_ref >= 0.5)


@pytest.mark.parametrize("hidden", [16, 48, 256, 272, 1024, 1152, 2048, 4096])
@pytest.mark.parametrize("batch", [1, 16, 63, 64, 100, 4096, 16384])
def test_kernel_matches_plain_version(dev, rows, hidden, batch):
    kp = _kp(_random_params(rows, hidden, seed=hidden), dev)
    _check(kp, torch.from_numpy(rows[:batch]).to(torch.bfloat16).to(dev))


@pytest.mark.parametrize("features,hidden", [(128, 256), (128, 1024), (40, 48)])
@pytest.mark.parametrize("batch", [1, 100, 16384])
def test_kernel_at_wide_features(dev, rows, features, hidden, batch):
    """Bar 2e-3: the tensor cores accumulate each 16-deep step less
    precisely than the plain version's f32 multiply-adds. Against an f64
    evaluation with the same rounding points, the kernel lay up to twice as
    far as the plain version on the card: 1.0e-3 against 4.7e-4 at F=40,
    H=48; 1.5e-3 against 1.1e-3 at F=128, H=1024 (16,384 rows)."""
    x = _wide(rows[:batch], features)
    kp = _kp(_random_params(x, hidden, seed=features), dev)
    _check(kp, torch.from_numpy(x).to(torch.bfloat16).to(dev), tol_p=2e-3)


@pytest.mark.parametrize("batch", [1, 100, 1000])
def test_wide_layout_at_wide_features(dev, rows, batch):
    """F=128 with H=2,048: the widest x tile beside the wide layout's
    ring. At 16,384 rows of these random params one row lies close enough
    to p = 0.5 for the two summation orders to put it on either side (run
    on the card), so the case stops at 1,000 rows."""
    x = _wide(rows[:batch], 128)
    kp = _kp(_random_params(x, 2048, seed=128), dev)
    _check(kp, torch.from_numpy(x).to(torch.bfloat16).to(dev), tol_p=2e-3)


@pytest.mark.parametrize("hidden", [256, 1024, 2048])
def test_rows_do_not_depend_on_the_tiles_a_block_walks(dev, rows, hidden):
    """The same rows at B and at B + 64 x SMs: in the second launch every
    block walks one more tile, and each row's result is bit for bit the same."""
    kp = _kp(_random_params(rows, hidden, seed=3), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = torch.from_numpy(rows[:1000 + 64 * sms]).to(torch.bfloat16).to(dev)
    few = fused_mlp.fused_mlp_score(kp, x[:1000].contiguous())
    many = fused_mlp.fused_mlp_score(kp, x)
    torch.cuda.synchronize()
    assert torch.equal(few, many[:1000])


def test_a_row_slice_at_any_offset_scores_the_same(dev, rows):
    """Rows that start at an offset the bulk copies cannot take (77 rows of
    60 bytes in) are copied first and score as the whole batch does."""
    kp = _kp(load_params(), dev)
    x = torch.from_numpy(rows[:1000]).to(torch.bfloat16).to(dev)
    whole = fused_mlp.fused_mlp_score(kp, x)
    part = fused_mlp.fused_mlp_score(kp, x[77:300])
    torch.cuda.synchronize()
    assert x[77:300].data_ptr() % 16 and torch.equal(whole[77:300], part)


def test_plan_of_the_built_kernel_matches_the_python_mirror(dev):
    for features, hidden in ((30, 256), (30, 1024), (128, 1024), (1, 1), (40, 48), (65, 300),
                             (30, 1025), (30, 4096), (128, 2048)):
        assert fused_mlp.kernel_plan(features, hidden) == fused_mlp.plan(features, hidden)


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


CROSSOVER = fused_mlp.CLUSTER_MAX_BATCH


@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
@pytest.mark.parametrize("batch", [1, 16, 17, 77, 128, 1000, 2048])
def test_cluster_path_matches_plain_version(dev, rows, hidden, batch):
    """The cluster launch (2, 4, 6 and 8 CTAs) on ragged batches, p and z
    against the plain version; 2,048 rows lie past the crossover, on the
    persistent grid."""
    assert fused_mlp.path_for(batch, 30, hidden) == (
        "cluster" if batch <= CROSSOVER else "persistent")
    kp = _kp(_random_params(rows, hidden, seed=hidden + 5), dev)
    _check(kp, torch.from_numpy(rows[:batch]).to(torch.bfloat16).to(dev))


@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
def test_a_row_scores_the_same_bits_on_both_paths(dev, rows, hidden):
    """The first 77 rows at B=77 (the cluster launch) and at B=4,096 (the
    persistent grid): the same bits of p and z."""
    kp = _kp(_random_params(rows, hidden, seed=hidden + 11), dev)
    x = torch.from_numpy(rows[:4096]).to(torch.bfloat16).to(dev)
    assert [fused_mlp.path_for(b, 30, hidden) for b in (77, 4096)] == ["cluster", "persistent"]
    p_c, z_c = fused_mlp.fused_mlp_score(kp, x[:77].contiguous(), with_logits=True)
    p_p, z_p = fused_mlp.fused_mlp_score(kp, x, with_logits=True)
    torch.cuda.synchronize()
    assert torch.equal(p_c, p_p[:77]) and torch.equal(z_c, z_p[:77])


@pytest.mark.parametrize("features,hidden", [(64, 512), (65, 384), (128, 512)])
def test_cluster_path_at_wide_features(dev, rows, features, hidden):
    """Two K blocks of layer 1 (F > 64), and F at the 128-lane bound with
    a cluster of 8, on the cluster launch: against the plain version, and
    bit-equal to the persistent grid."""
    x_np = _wide(rows[:4096], features)
    kp = _kp(_random_params(x_np, hidden, seed=features), dev)
    x = torch.from_numpy(x_np).to(torch.bfloat16).to(dev)
    assert fused_mlp.path_for(100, features, hidden) == "cluster"
    _check(kp, x[:100].contiguous(), tol_p=2e-3)
    p_c, z_c = fused_mlp.fused_mlp_score(kp, x[:100].contiguous(), with_logits=True)
    p_p, z_p = fused_mlp.fused_mlp_score(kp, x, with_logits=True)
    torch.cuda.synchronize()
    assert torch.equal(p_c, p_p[:100]) and torch.equal(z_c, z_p[:100])


def test_a_row_slice_at_an_odd_offset_on_the_cluster_path(dev, rows):
    """Rows from an odd row offset (a start the bulk copies cannot take)
    scored on the cluster launch equal the same rows inside a batch on the
    persistent grid."""
    kp = _kp(load_params(), dev)
    x = torch.from_numpy(rows[:4096]).to(torch.bfloat16).to(dev)
    part = x[33:49]
    assert part.data_ptr() % 16 and fused_mlp.path_for(16, 30, 256) == "cluster"
    got = fused_mlp.fused_mlp_score(kp, part, with_logits=True)
    whole = fused_mlp.fused_mlp_score(kp, x, with_logits=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], whole[0][33:49]) and torch.equal(got[1], whole[1][33:49])


def test_the_cluster_counter_moves_as_path_for_says(dev, rows):
    """A launch at B=16 adds one to ``launches`` and one to
    ``launches_cluster``; past the crossover only ``launches`` moves. The
    counter follows the launch handed to the entry: a named launch counts
    as what it names, at any batch."""
    kp = _kp(load_params(), dev)
    for b in (16, 128, CROSSOVER, CROSSOVER + 1):
        x = torch.from_numpy(rows[:b]).to(torch.bfloat16).to(dev)
        before = (fused_mlp.launches.value, fused_mlp.launches_cluster.value)
        fused_mlp.fused_mlp_score(kp, x)
        cluster = fused_mlp.path_for(b, 30, 256) == "cluster"
        assert cluster == (b <= CROSSOVER)
        assert (fused_mlp.launches.value, fused_mlp.launches_cluster.value) == (
            before[0] + 1, before[1] + cluster)
        for path in fused_mlp.PATHS:
            before = (fused_mlp.launches.value, fused_mlp.launches_cluster.value)
            fused_mlp.launch(kp, x, path)
            assert (fused_mlp.launches.value, fused_mlp.launches_cluster.value) == (
                before[0] + 1, before[1] + (path == "cluster"))
    torch.cuda.synchronize()


@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
@pytest.mark.parametrize("batch", sorted({1, 16, 17, 128, CROSSOVER, CROSSOVER + 1, 2048}))
def test_both_launches_give_the_same_bits(dev, rows, hidden, batch):
    """The same rows on the persistent grid and on the cluster (2, 4, 6
    and 8 CTAs), on either side of the crossover: the same bits of p and
    z."""
    kp = _kp(_random_params(rows, hidden, seed=hidden + 3), dev)
    x = torch.from_numpy(rows[:batch]).to(torch.bfloat16).to(dev)
    got = [fused_mlp.launch(kp, x, path, with_logits=True) for path in fused_mlp.PATHS]
    torch.cuda.synchronize()
    (p_p, z_p), (p_c, z_c) = got
    assert torch.equal(p_p, p_c) and torch.equal(z_p, z_c)


def test_the_entry_refuses_what_it_cannot_run(dev, rows):
    """B1's entry refuses a cluster launch of no rows and one of more than
    8 CTAs (H=640: 10), and a launch it does not name; the persistent grid
    takes H=640."""
    fn, _plan, _blocks, _err = fused_mlp._kernel_entry()
    invalid = 1  # cudaErrorInvalidValue
    assert fn(None, None, None, None, None, None, None, 0, 0, 30, 256, 1, None) == invalid
    assert fn(None, None, None, None, None, None, None, 0, 16, 30, 256, 2, None) == invalid
    kp = _kp(_random_params(rows, 640, seed=640), dev)
    x = torch.from_numpy(rows[:16]).to(torch.bfloat16).to(dev)
    before = fused_mlp.launches.value
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fused_mlp.launch(kp, x, "cluster")
    assert fused_mlp.launches.value == before
    _check(kp, x)  # on path_for's launch, the persistent grid
