"""The port's Scorer on the CPU vs the JAX Scorer on the fused path.

``Scorer(device="cpu")`` runs kernel B1's plain version (the wrapper sees a
CPU tensor); the JAX ``Scorer(use_fused=True)`` runs the Pallas kernel in
interpret mode. Same rows, same params: probabilities agree to 1e-5.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from ccfd_tpu.data.ccfd import synthetic_dataset
from ccfd_tpu.serving.scorer import Scorer as JaxScorer
from ccfd_tpu_torch.ops import fused_mlp
from ccfd_tpu_torch.params import from_jax_params
from ccfd_tpu_torch.serving.scorer import Scorer
from tests.torch_helpers import mlp_tree


@pytest.fixture(scope="module")
def data():
    X = synthetic_dataset(n=600, fraud_rate=0.2, seed=9).X
    return X, mlp_tree(X, hidden=64, seed=9)


def test_matches_jax_fused_scorer(data):
    X, tree = data
    ref = JaxScorer(model_name="mlp", params=tree, batch_sizes=(16, 128),
                    use_fused=True, host_tier_rows=0).score(X[:200])
    s = Scorer(params=from_jax_params(tree), batch_sizes=(16, 128), device="cpu")
    assert s.fused
    got = s.score(X[:200])
    assert got.shape == (200,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_f32_path_matches_jax_xla_scorer(data):
    X, tree = data
    ref = JaxScorer(model_name="mlp", params=tree, batch_sizes=(16, 128),
                    compute_dtype="float32", use_fused=False,
                    host_tier_rows=0).score(X[:50])
    s = Scorer(params=from_jax_params(tree), batch_sizes=(16, 128),
               compute_dtype="float32", device="cpu")
    assert not s.fused
    np.testing.assert_allclose(s.score(X[:50]), ref, rtol=0, atol=1e-5)


def test_bucketing_and_dispatch_counts(data):
    X, tree = data
    s = Scorer(params=tree, batch_sizes=(128, 16), device="cpu")
    assert s.batch_sizes == (16, 128)
    assert [s.bucket(n) for n in (1, 16, 17, 128, 129, 10_000)] == [16, 16, 128, 128, 128, 128]
    s.score(X[:10])
    s.score(X[:100])
    s.score(X[:300])  # 128 + 128 + 44 -> three dispatches of the 128 bucket
    assert s.score(X[:0]).shape == (0,)
    grid = s.executable_grid()
    assert grid["dispatches"] == {"16": 1, "128": 4}
    assert grid["fused"] and grid["device"] == "cpu" and grid["model"] == "mlp"
    assert s.dispatch_total() == 5


def test_padding_does_not_change_rows(data):
    X, tree = data
    s = Scorer(params=tree, batch_sizes=(16, 128, 1024), device="cpu")
    whole = s.score(X[:300])
    # the CPU's BLAS blocks each batch size differently, so a row's sums
    # may differ in the last ulp between buckets (the CUDA kernel's do not)
    np.testing.assert_allclose(s.score(X[:7]), whole[:7], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(s.score_pipelined(X[:300], depth=3), whole)


def test_swap_params_changes_output(data):
    X, tree = data
    s = Scorer(params=tree, batch_sizes=(64,), device="cpu")
    before = s.score(X[:64])
    new_tree = mlp_tree(X, hidden=64, seed=10)
    s.swap_params(from_jax_params(new_tree))
    after = s.score(X[:64])
    assert np.abs(after - before).max() > 1e-3
    fresh = Scorer(params=new_tree, batch_sizes=(64,), device="cpu").score(X[:64])
    np.testing.assert_array_equal(after, fresh)


def test_swap_stages_fresh_tensors(data):
    _X, tree = data
    params = from_jax_params(tree)
    s = Scorer(params=params, batch_sizes=(16,), device="cpu")
    params["layers"][0]["w"].zero_()  # the caller's tensors are not aliased
    assert s.params["layers"][0]["w"].abs().sum().item() > 0


def test_concurrent_callers_get_their_own_rows(data):
    X, tree = data
    s = Scorer(params=tree, batch_sizes=(16, 128), device="cpu")
    want = [s.score(X[i * 40:(i + 1) * 40]) for i in range(8)]
    got: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(i: int) -> None:
            for _ in range(5):
                got[i] = s.score(X[i * 40:(i + 1) * 40])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for i in range(8):
        np.testing.assert_array_equal(got[i], want[i])
    assert s.dispatch_total() == 8 + 8 * 5


def test_default_device_is_the_card_and_raises_without_one(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scorer(params=data[1])


def test_unsupported_hidden_width_raises(data):
    """B1 takes any hidden width (past 1,024 in its wide layout); what it
    refuses, as the reference does, is more than 128 features."""
    X, _ = data
    wide = np.concatenate([X] * 5, axis=1)[:, :129]
    with pytest.raises(ValueError, match="at most 128 features"):
        Scorer(params=mlp_tree(wide, hidden=64), num_features=129, device="cpu")
    assert Scorer(params=mlp_tree(X, hidden=1025), device="cpu").fused


@pytest.mark.parametrize("hidden", [40, 512, 1025])
def test_serves_a_wide_model_like_the_jax_scorer(data, hidden):
    """Hidden widths the reference serves and the port once refused."""
    X, _ = data
    tree = mlp_tree(X, hidden=hidden, seed=13)
    ref = JaxScorer(model_name="mlp", params=tree, batch_sizes=(16, 128),
                    use_fused=True, host_tier_rows=0).score(X[:100])
    s = Scorer(params=from_jax_params(tree), batch_sizes=(16, 128), device="cpu")
    assert s.fused
    np.testing.assert_allclose(s.score(X[:100]), ref, rtol=0, atol=1e-5)


def test_warmup_runs_every_bucket_without_counting(data):
    _X, tree = data
    s = Scorer(params=tree, batch_sizes=(16, 128), device="cpu")
    before = fused_mlp.launches.value
    s.warmup()
    assert s.dispatch_total() == 0
    assert fused_mlp.launches.value == before  # CPU: the plain version


def test_rejects_wrong_width(data):
    X, tree = data
    s = Scorer(params=tree, batch_sizes=(16,), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        s.score(X[:4, :20])
