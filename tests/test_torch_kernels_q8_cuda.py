"""Kernels B2 and B3 on the card vs their plain PyTorch versions (marker
``cuda``).

Skips where there is no CUDA card; the skip is decided inside the fixture,
never at import. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_q8_cuda.py

The kernels and the plain versions round at the same points (IEEE
divisions, no fused multiply-add, exact integer sums), so they are held to
bit equality (the reference's own bars, tests/test_fused_q8.py, are 1e-5
in probability and 1e-6 for B3 against B2). Hidden widths cover the
padding to the kernels' multiple of 64 and the 32-row tiles of the widest
models (up to the reference's bound of 1,040), batches the ragged last tile
and enough tiles for every persistent block to walk more than one. B3
takes a cluster launch up to ``CLUSTER_MAX_BATCH`` rows where H needs at
most 8 CTAs (``path_for``), and ``fused_mlp_q8.launch_preq`` runs either
launch at any batch; batches on both sides of each 16-row slab, of the
64-row tile and of the crossover hold it to the same bits.
"""

import numpy as np
import pytest
import torch

from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.models import mlp
from ccfd_tpu_torch.ops import fused_mlp_q8, quant
from ccfd_tpu_torch.params import load_params

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def rows():
    return kaggle_surrogate(n=20_000).X


def _qp(rows, hidden, seed):
    g = torch.Generator().manual_seed(seed)
    return quant.quantize_mlp(mlp.set_normalizer(
        mlp.init(g, num_features=rows.shape[1], hidden=hidden), rows.mean(0), rows.std(0)))


def _wide(rows, features):
    reps = -(-features // rows.shape[1])
    return np.ascontiguousarray(np.concatenate([rows] * reps, axis=1)[:, :features])


def _kp(qp, dev):
    return fused_mlp_q8.pack_for_kernel(fused_mlp_q8.fold_for_kernel(qp), dev)


def _both(kp, x_np, dev):
    """B2 and B3 on the card, and their plain versions on the same inputs."""
    x = torch.from_numpy(x_np).to(dev)
    host_norm = {k: kp[k].cpu() for k in ("mu", "sigma")}
    q_np, s_np = fused_mlp_q8.prequantize_rows_numpy(host_norm, x_np)
    q, s = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
    before = (fused_mlp_q8.launches.value, fused_mlp_q8.launches_preq.value)
    p2, z2 = fused_mlp_q8.fused_mlp_q8_score(kp, x, with_logits=True)
    p3, z3 = fused_mlp_q8.fused_mlp_q8_score_preq(kp, q, s, with_logits=True)
    assert (fused_mlp_q8.launches.value, fused_mlp_q8.launches_preq.value) == (
        before[0] + 1, before[1] + 1)
    r2 = fused_mlp_q8.fused_mlp_q8_reference(kp, x)
    r3 = fused_mlp_q8.fused_mlp_q8_preq_reference(kp, q, s)
    torch.cuda.synchronize()
    return (p2, z2), (p3, z3), r2, r3


def _check_bit_equal(kp, x_np, dev):
    """B2 and B3 equal their plain versions and each other, bit for bit."""
    (p2, z2), (p3, z3), (r2p, r2z), (r3p, r3z) = _both(kp, x_np, dev)
    for p, z, rp, rz in ((p2, z2, r2p, r2z), (p3, z3, r3p, r3z)):
        assert p.shape == (x_np.shape[0],) and torch.isfinite(p).all()
        assert torch.equal(p, rp) and torch.equal(z, rz)
    assert torch.equal(p3, p2) and torch.equal(z3, z2)


@pytest.mark.parametrize("hidden", [32, 48, 288, 320, 1040])
@pytest.mark.parametrize("batch", [1, 16, 63, 64, 100, 4096, 16384])
def test_kernels_match_plain_versions(dev, rows, hidden, batch):
    _check_bit_equal(_kp(_qp(rows, hidden, seed=hidden), dev), rows[:batch], dev)


@pytest.mark.parametrize("features,hidden", [(128, 256), (128, 1040), (40, 64)])
@pytest.mark.parametrize("batch", [1, 100, 16384])
def test_kernels_at_wide_features(dev, rows, features, hidden, batch):
    x = _wide(rows[:batch], features)
    _check_bit_equal(_kp(_qp(x, hidden, seed=features), dev), x, dev)


@pytest.mark.parametrize("hidden", [256, 1040])
def test_rows_do_not_depend_on_the_tiles_a_block_walks(dev, rows, hidden):
    """The same rows at B and at B + 64 x SMs: in the second launch every
    block walks more tiles, and each row's result is bit for bit the same."""
    kp = _kp(_qp(rows, hidden, seed=5), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = torch.from_numpy(rows[:1000 + 64 * sms]).to(dev)
    few = fused_mlp_q8.fused_mlp_q8_score(kp, x[:1000].contiguous())
    many = fused_mlp_q8.fused_mlp_q8_score(kp, x)
    torch.cuda.synchronize()
    assert torch.equal(few, many[:1000])


def test_a_row_slice_at_any_offset_scores_the_same(dev, rows):
    """Rows, int8 rows and scales that start at offsets the bulk copies
    cannot take are copied first and score as the whole batch does."""
    kp = _kp(quant.quantize_mlp(load_params()), dev)
    x = torch.from_numpy(rows[:1000]).to(dev)
    q_np, s_np = fused_mlp_q8.prequantize_rows_numpy(
        {k: kp[k].cpu() for k in ("mu", "sigma")}, rows[:1000])
    q, s = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
    whole2 = fused_mlp_q8.fused_mlp_q8_score(kp, x)
    whole3 = fused_mlp_q8.fused_mlp_q8_score_preq(kp, q, s)
    part2 = fused_mlp_q8.fused_mlp_q8_score(kp, x[77:300])
    part3 = fused_mlp_q8.fused_mlp_q8_score_preq(kp, q[77:300], s[77:300])
    torch.cuda.synchronize()
    assert x[77:300].data_ptr() % 16 and q[77:300].data_ptr() % 16
    assert torch.equal(whole2[77:300], part2) and torch.equal(whole3[77:300], part3)


def test_plan_of_the_built_kernels_matches_the_python_mirror(dev):
    keys = ("k1p", "hp", "rows", "chunks", "stages", "resident", "smem")
    for features, hidden in ((30, 256), (30, 1040), (128, 1040), (128, 256), (1, 16), (40, 48)):
        want = {k: fused_mlp_q8.plan(features, hidden)[k] for k in keys}
        assert fused_mlp_q8.kernel_plan(features, hidden) == want


def test_kernels_on_the_committed_q8_model(dev, rows):
    kp = _kp(quant.quantize_mlp(load_params()), dev)
    (p2, z2), (p3, _z3), (r2p, r2z), _ = _both(kp, rows[:16384], dev)
    assert (p2 - r2p).abs().max().item() <= 1e-5
    assert (z2 - r2z).abs().max().item() <= 1e-4 * max(1.0, r2z.abs().max().item())
    assert (p3 - p2).abs().max().item() <= 1e-6


def test_large_magnitude_normalizers(dev, rows):
    g = torch.Generator().manual_seed(12)
    qp = quant.quantize_mlp(mlp.set_normalizer(
        mlp.init(g), rows.mean(0) + 3.0, rows.std(0) * 2.0))
    kp = _kp(qp, dev)
    (p2, _), (p3, _), (r2p, _), (r3p, _) = _both(kp, rows[:4096], dev)
    assert (p2 - r2p).abs().max().item() <= 1e-5
    assert (p3 - r3p).abs().max().item() <= 1e-5


def test_rows_are_independent_of_the_batch(dev, rows):
    kp = _kp(quant.quantize_mlp(load_params()), dev)
    x = torch.from_numpy(rows[:1000]).to(dev)
    whole = fused_mlp_q8.fused_mlp_q8_score(kp, x)
    part = fused_mlp_q8.fused_mlp_q8_score(kp, x[:77].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(whole[:77], part)


def test_wrappers_check_inputs(dev, rows):
    kp = _kp(quant.quantize_mlp(load_params()), dev)
    x = torch.from_numpy(rows[:8]).to(dev)
    with pytest.raises(ValueError, match="float32"):
        fused_mlp_q8.fused_mlp_q8_score(kp, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp_q8.fused_mlp_q8_score(kp, x.t().contiguous().t())
    with pytest.raises(ValueError, match="pack_for_kernel"):
        fused_mlp_q8.fused_mlp_q8_score({**kp, "w2t": kp["w2t"].float()}, x)
    with pytest.raises(ValueError, match="pack_for_kernel"):
        fused_mlp_q8.fused_mlp_q8_score(_kp(quant.quantize_mlp(load_params()), "cpu"), x)
    q = torch.zeros((8, 30), dtype=torch.int8, device=dev)
    s = torch.ones((8, 1), device=dev)
    with pytest.raises(ValueError, match="int8"):
        fused_mlp_q8.fused_mlp_q8_score_preq(kp, q.float(), s)
    with pytest.raises(ValueError, match="rows"):
        fused_mlp_q8.fused_mlp_q8_score_preq(kp, q, s[:4])
    with pytest.raises(ValueError, match="one device"):
        fused_mlp_q8.fused_mlp_q8_score_preq(kp, q, s.cpu())
    before = fused_mlp_q8.launches.value
    assert fused_mlp_q8.fused_mlp_q8_score(kp, x[:0]).shape == (0,)
    assert fused_mlp_q8.launches.value == before


@pytest.mark.parametrize("wire", ["int8", "f32"])
def test_scorer_on_the_card_goes_through_the_kernel(dev, rows, wire):
    from ccfd_tpu_torch.serving.scorer import Scorer

    qp = quant.quantize_mlp(load_params())
    s = Scorer(model_name="mlp_q8", params=qp, device=dev, q8_wire=wire)
    s.warmup()
    counter = fused_mlp_q8.launches_preq if wire == "int8" else fused_mlp_q8.launches
    other = fused_mlp_q8.launches if wire == "int8" else fused_mlp_q8.launches_preq
    before, other_before = counter.value, other.value
    got = s.score(rows[:5000])
    assert counter.value - before == s.dispatch_total() == 1
    assert other.value == other_before
    cpu = Scorer(model_name="mlp_q8", params=qp, device="cpu", q8_wire=wire).score(rows[:5000])
    np.testing.assert_allclose(got, cpu, rtol=0, atol=1e-5)


CROSSOVER = fused_mlp_q8.CLUSTER_MAX_BATCH
CLUSTER_BATCHES = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, CROSSOVER - 1, CROSSOVER,
                   CROSSOVER + 1]


@pytest.mark.parametrize("params,hidden", [("committed", 256), ("seeded", 256),
                                           ("seeded", 512), ("seeded", 1040)])
@pytest.mark.parametrize("batch", CLUSTER_BATCHES)
def test_b3_on_both_paths_matches_plain_and_b2(dev, rows, batch, params, hidden):
    """B3 equals its plain version and B2 bit for bit on each side of the
    slabs, the tile and the crossover: the cluster path at H=256 (4 CTAs)
    and H=512 (8), the persistent grid at H=1,040 and past the crossover.
    The committed model is H=256."""
    if params == "committed":
        qp = quant.quantize_mlp(load_params())
    else:
        qp = _qp(rows, hidden, seed=hidden + 21)
    _check_bit_equal(_kp(qp, dev), rows[:batch], dev)


@pytest.mark.parametrize("hidden", [256, 512])
def test_a_row_scores_the_same_alone_and_in_every_bucket(dev, rows, hidden):
    """A row alone, in a 16-, a 128- and a 16,384-row batch: the same bits
    on the cluster path and on the persistent grid."""
    kp = _kp(_qp(rows, hidden, seed=9), dev)
    q_np, s_np = fused_mlp_q8.prequantize_rows_numpy(
        {k: kp[k].cpu() for k in ("mu", "sigma")}, rows[:16384])
    q, s = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
    assert [fused_mlp_q8.path_for(b, 30, hidden) for b in (1, 16, 128, 16384)] == [
        "cluster", "cluster", "cluster", "persistent"]
    got = [fused_mlp_q8.fused_mlp_q8_score_preq(kp, q[:b].contiguous(), s[:b].contiguous(),
                                                with_logits=True) for b in (1, 16, 128, 16384)]
    torch.cuda.synchronize()
    for p, z in got[1:]:
        assert torch.equal(p[:1], got[0][0]) and torch.equal(z[:1], got[0][1])
    for p, z in got[2:]:
        assert torch.equal(p[:16], got[1][0]) and torch.equal(z[:16], got[1][1])
    assert torch.equal(got[3][0][:128], got[2][0]) and torch.equal(got[3][1][:128], got[2][1])


def test_the_cluster_counter_moves_as_path_for_says(dev, rows):
    """The counter follows the launch handed to the entry: ``path_for``'s
    answer through the wrapper, and a named launch as what it names."""
    kp = _kp(quant.quantize_mlp(load_params()), dev)
    q_np, s_np = fused_mlp_q8.prequantize_rows_numpy(
        {k: kp[k].cpu() for k in ("mu", "sigma")}, rows[:CROSSOVER + 1])
    for b in (16, 128, CROSSOVER, CROSSOVER + 1):
        q, s = torch.from_numpy(q_np[:b]).to(dev), torch.from_numpy(s_np[:b]).to(dev)
        before = (fused_mlp_q8.launches_preq.value, fused_mlp_q8.launches_preq_cluster.value)
        fused_mlp_q8.fused_mlp_q8_score_preq(kp, q, s)
        cluster = fused_mlp_q8.path_for(b, 30, 256) == "cluster"
        assert (fused_mlp_q8.launches_preq.value,
                fused_mlp_q8.launches_preq_cluster.value) == (before[0] + 1,
                                                              before[1] + cluster)
        for path in fused_mlp_q8.PATHS:
            before = (fused_mlp_q8.launches_preq.value,
                      fused_mlp_q8.launches_preq_cluster.value)
            fused_mlp_q8.launch_preq(kp, q, s, path)
            assert (fused_mlp_q8.launches_preq.value,
                    fused_mlp_q8.launches_preq_cluster.value) == (
                before[0] + 1, before[1] + (path == "cluster"))
    torch.cuda.synchronize()
    assert fused_mlp_q8.path_for(CROSSOVER + 1, 30, 256) == "persistent"


@pytest.mark.parametrize("hidden", [256, 512])
@pytest.mark.parametrize("batch", sorted({1, 16, 17, 128, CROSSOVER, CROSSOVER + 1, 2048}))
def test_both_launches_give_the_same_bits(dev, rows, hidden, batch):
    """The same rows on B3's persistent grid and on its cluster (4 and 8
    CTAs), on either side of the crossover: the same bits of p and z, and
    B2's on the f32 rows."""
    kp = _kp(_qp(rows, hidden, seed=hidden + 3), dev)
    q_np, s_np = fused_mlp_q8.prequantize_rows_numpy(
        {k: kp[k].cpu() for k in ("mu", "sigma")}, rows[:batch])
    q, s = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
    got = [fused_mlp_q8.launch_preq(kp, q, s, path, with_logits=True)
           for path in fused_mlp_q8.PATHS]
    p2, z2 = fused_mlp_q8.fused_mlp_q8_score(kp, torch.from_numpy(rows[:batch]).to(dev),
                                             with_logits=True)
    torch.cuda.synchronize()
    for p, z in got:
        assert torch.equal(p, p2) and torch.equal(z, z2)


def test_the_entry_refuses_what_it_cannot_run(dev, rows):
    """B3's entry refuses a cluster launch of no rows and one of more than
    8 CTAs (H=513: hp 576, 9), and a launch it does not name; the
    persistent grid takes H=513."""
    _full, preq, _plan, _err = fused_mlp_q8._kernel_entries()
    invalid = 1  # cudaErrorInvalidValue
    assert preq(None, None, None, None, None, None, None, None, None, 0, 30, 256, 1,
                None) == invalid
    assert preq(None, None, None, None, None, None, None, None, None, 16, 30, 256, 2,
                None) == invalid
    kp = _kp(_qp(rows, 513, seed=513), dev)
    q_np, s_np = fused_mlp_q8.prequantize_rows_numpy(
        {k: kp[k].cpu() for k in ("mu", "sigma")}, rows[:16])
    q, s = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
    before = fused_mlp_q8.launches_preq.value
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fused_mlp_q8.launch_preq(kp, q, s, "cluster")
    assert fused_mlp_q8.launches_preq.value == before
    _check_bit_equal(kp, rows[:16], dev)  # on path_for's launch, the persistent grid
