"""The port's tree family (models/trees.py; ``gbt`` and ``gbt_mxu``)
against ccfd_tpu/models/trees.py: the converters on fitted sklearn
ensembles (params equal exactly), both evaluations and the numpy forward
on the same rows, the embedding of an unbalanced tree, ties at a
threshold, non-finite rows, the depth guard, the committed artifact, and
the Scorer's init of the family."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.ensemble import GradientBoostingClassifier, HistGradientBoostingClassifier

from ccfd_tpu.cli import _restore_gbt_params
from ccfd_tpu.models import trees as jax_trees
from ccfd_tpu.models.registry import get_model as jax_get_model
from ccfd_tpu.serving.scorer import Scorer as JaxScorer
from ccfd_tpu_torch.cli import restore_gbt_params
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.models import trees
from ccfd_tpu_torch.models.registry import get_model
from ccfd_tpu_torch.params import from_jax_model_params, to_numpy
from ccfd_tpu_torch.serving.scorer import Scorer

KEYS = ("feature", "threshold", "leaf", "base")


@pytest.fixture(scope="module")
def ensembles(dataset):
    """{name: (sklearn model, the reference's params, the port's params)}."""
    hgb = HistGradientBoostingClassifier(max_depth=5, max_iter=30,
                                         random_state=0).fit(dataset.X, dataset.y)
    gbt = GradientBoostingClassifier(n_estimators=20, max_depth=3,
                                     random_state=0).fit(dataset.X, dataset.y)
    return {"hgb": (hgb, jax_trees.from_sklearn_hgb(hgb), trees.from_sklearn_hgb(hgb)),
            "gbt": (gbt, jax_trees.from_sklearn_gbt(gbt), trees.from_sklearn_gbt(gbt))}


def _rows(dataset):
    """The dataset's rows and some with NaN and +/-inf cells."""
    x = dataset.X[:512].copy()
    rng = np.random.default_rng(7)
    cells = rng.integers(0, x.size, 60)
    x.flat[cells[:20]] = np.nan
    x.flat[cells[20:40]] = np.inf
    x.flat[cells[40:]] = -np.inf
    return np.concatenate([dataset.X[:512], x])


@pytest.mark.parametrize("kind", ["hgb", "gbt"])
def test_converters_give_the_references_params(ensembles, kind):
    _clf, ref, mine = ensembles[kind]
    assert mine["feature"].dtype == torch.int32 and mine["leaf"].dtype == torch.float32
    for k in KEYS:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["hgb", "gbt"])
@pytest.mark.parametrize("fn", ["logits", "logits_mxu"])
def test_evaluations_match_the_reference(dataset, ensembles, kind, fn):
    clf, ref, mine = ensembles[kind]
    x = _rows(dataset)
    got = getattr(trees, fn)(mine, torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jax_trees, fn)(ref, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the two evaluations reach the same leaf in every tree, and so sum alike
    np.testing.assert_array_equal(trees.leaf_indices(mine, torch.from_numpy(x)).numpy(),
                                  trees.leaf_indices_mxu(mine, torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(trees.logits(mine, torch.from_numpy(x)).numpy(),
                                  trees.logits_mxu(mine, torch.from_numpy(x)).numpy())
    p = (trees.apply if fn == "logits" else trees.apply_mxu)(mine, torch.from_numpy(x[:512]))
    np.testing.assert_allclose(p.numpy(), clf.predict_proba(x[:512])[:, 1],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["hgb", "gbt"])
def test_apply_numpy_matches_the_reference(dataset, ensembles, kind):
    _clf, ref, mine = ensembles[kind]
    x = _rows(dataset)
    got = trees.apply_numpy(to_numpy(mine), x)
    np.testing.assert_allclose(got, jax_trees.apply_numpy({k: np.asarray(v) for k, v in
                                                          ref.items()}, x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, trees.apply(mine, torch.from_numpy(x)).numpy(),
                               rtol=0, atol=1e-6)


def test_unbalanced_tree_embedding():
    """Root splits f0 at 0.5; its left child is a leaf (-1), its right splits
    f1 at 0.0 into leaves +1 / +3: the early leaf fills both slots below it."""
    src = (np.array([1, -1, 3, -1, -1]), np.array([2, -1, 4, -1, -1]),
           np.array([0, -2, 1, -2, -2]), np.array([0.5, -2.0, 0.0, -2.0, -2.0]),
           np.array([0.0, -1.0, 0.0, 1.0, 3.0]))
    got = trees._embed_tree(*src, depth=2, scale=1.0)
    for g, w in zip(got, jax_trees._embed_tree(*src, depth=2, scale=1.0)):
        np.testing.assert_array_equal(g, w)
    params = {"feature": torch.from_numpy(got[0][None]),
              "threshold": torch.from_numpy(got[1][None]),
              "leaf": torch.from_numpy(got[2][None]), "base": torch.tensor(0.0)}
    x = torch.tensor([[0.0, 9.9], [1.0, -1.0], [1.0, 1.0]])
    np.testing.assert_allclose(trees.logits(params, x).numpy(), [-1.0, 1.0, 3.0])
    np.testing.assert_allclose(trees.logits_mxu(params, x).numpy(), [-1.0, 1.0, 3.0])
    with pytest.raises(ValueError, match="deeper than depth=1"):
        trees._embed_tree(*src, depth=1, scale=1.0)


def test_ties_at_a_threshold_go_left_in_both_evaluations():
    p = {"feature": torch.zeros((1, 1), dtype=torch.int32),
         "threshold": torch.tensor([[1.5]]), "leaf": torch.tensor([[10.0, 20.0]]),
         "base": torch.tensor(0.0)}
    x = torch.tensor([[1.5] + [0.0] * 29, [1.6] + [0.0] * 29])
    want = np.asarray(jax_trees.logits_mxu(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()}, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(want, [10.0, 20.0])
    np.testing.assert_array_equal(trees.logits(p, x).numpy(), want)
    np.testing.assert_array_equal(trees.logits_mxu(p, x).numpy(), want)


def test_nonfinite_rows_descend_alike():
    p = {"feature": torch.tensor([[1, 0, 2]], dtype=torch.int32),
         "threshold": torch.tensor([[0.5, -1.0, 2.0]]),
         "leaf": torch.tensor([[1.0, 2.0, 3.0, 4.0]]), "base": torch.tensor(0.0)}
    rows = np.zeros((4, 30), np.float32)
    rows[0, 1] = np.nan       # NaN at the root's split feature
    rows[1, 1] = np.inf       # +inf at the root's split feature
    rows[2, 0] = -np.inf      # -inf on the left child's feature
    rows[3, 2] = np.inf       # +inf on the right child's feature
    want = np.asarray(jax_trees.logits({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                                       jnp.asarray(rows)))
    x = torch.from_numpy(rows)
    np.testing.assert_array_equal(trees.logits(p, x).numpy(), want)
    np.testing.assert_array_equal(trees.logits_mxu(p, x).numpy(), want)


def test_depth_guard_refuses_pathological_trees(dataset):
    clf = HistGradientBoostingClassifier(max_depth=4, max_iter=5,
                                         random_state=0).fit(dataset.X, dataset.y)
    for mod in (jax_trees, trees):
        with pytest.raises(ValueError, match="retrain with"):
            mod.from_sklearn_hgb(clf, max_embed_depth=3)


def test_the_committed_artifact_scores_as_the_reference():
    """checkpoints_gbt/params.npz (the reference's `train --family hgb`):
    read by both packages, equal params, and both evaluations on
    Kaggle-scale rows against the reference's."""
    ref = _restore_gbt_params("")
    mine = restore_gbt_params(None)
    assert mine is not None and trees.depth_of(mine) == 8
    for k in KEYS:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]), err_msg=k)
    x = kaggle_surrogate(n=1024, seed=11).X
    want = np.asarray(jax_trees.logits(ref, jnp.asarray(x)))
    for fn in (trees.logits, trees.logits_mxu):
        np.testing.assert_allclose(fn(mine, torch.from_numpy(x)).numpy(), want,
                                   rtol=0, atol=1e-5)


def test_scorer_inits_the_family_from_the_generator_alone():
    """The Scorer draws a model's init from its generator only, as the
    reference's ``spec.init(key)``: the gbt init is the registry's 50-tree
    depth-4 ensemble, not one of ``num_features`` trees."""
    for name in ("gbt", "gbt_mxu"):
        ref = JaxScorer(model_name=name, batch_sizes=(16,), use_fused=False)
        mine = Scorer(model_name=name, batch_sizes=(16,), device="cpu")
        for k in KEYS:
            assert tuple(mine.params[k].shape) == tuple(np.shape(ref._params[k])), k
        assert get_model(name).trainable == jax_get_model(name).trainable is False
        x = np.random.default_rng(0).normal(size=(5, 30)).astype(np.float32)
        np.testing.assert_array_equal(mine.score(x), np.full(5, 0.5, np.float32))


@pytest.mark.parametrize("name", ["gbt", "gbt_mxu"])
def test_scorer_serves_fitted_trees_as_the_reference(dataset, ensembles, name):
    _clf, ref, _mine = ensembles["hgb"]
    mine = from_jax_model_params(name, {k: np.asarray(v) for k, v in ref.items()})
    x = _rows(dataset)[:300]
    got = Scorer(model_name=name, params=mine, batch_sizes=(64, 256), device="cpu").score(x)
    want = JaxScorer(model_name=name, params=ref, batch_sizes=(64, 256),
                     use_fused=False, host_tier_rows=0).score(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
