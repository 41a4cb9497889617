"""The port's logistic-regression scorer (models/logreg.py; ``logreg`` and
``modelfull``) against ccfd_tpu/models/logreg.py on the same seeded numpy
inputs and params."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression
from sklearn.preprocessing import StandardScaler

from ccfd_tpu.models import logreg as jax_logreg
from ccfd_tpu.models.registry import get_model as jax_get_model
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.models import logreg
from ccfd_tpu_torch.models.registry import get_model
from ccfd_tpu_torch.params import from_jax_model_params, to_numpy

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def rows():
    """Kaggle-scale rows (Time to 1.7e5, Amount to ~1e4) and labels."""
    ds = kaggle_surrogate(n=2048, seed=3)
    return ds.X, ds.y


@pytest.fixture(scope="module")
def fitted(rows):
    """The reference's IRLS fit of the rows, as its numpy params."""
    X, y = rows
    p = jax_logreg.fit_numpy(X.astype(np.float64), y)
    return {k: np.asarray(v) for k, v in p.items()}


def _both(tree):
    return from_jax_model_params("logreg", tree), {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_logits_and_apply_match_the_reference(rows, fitted, dtype):
    X, _ = rows
    tdt, jdt = DTYPES[dtype]
    mine, ref = _both(fitted)
    z = logreg.logits(mine, torch.from_numpy(X), tdt).numpy()
    p = logreg.apply(mine, torch.from_numpy(X), tdt).numpy()
    z_ref = np.asarray(jax_logreg.logits(ref, jnp.asarray(X), jdt))
    p_ref = np.asarray(jax_logreg.apply(ref, jnp.asarray(X), compute_dtype=jdt))
    assert z.dtype == np.float32 and p.dtype == np.float32  # not rounded to bf16
    np.testing.assert_allclose(z, z_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-6 if dtype == "float32" else 1e-5)


def test_registry_serves_logreg_and_modelfull(rows, fitted):
    X, _ = rows
    mine, ref = _both(fitted)
    for name in ("logreg", "modelfull"):
        spec, jspec = get_model(name), jax_get_model(name)
        assert spec.apply is logreg.apply and spec.trainable == jspec.trainable
        got = spec.apply(mine, torch.from_numpy(X[:64]), torch.bfloat16).numpy()
        want = np.asarray(jspec.apply(ref, jnp.asarray(X[:64]), compute_dtype=jnp.bfloat16))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        init = spec.init(torch.Generator().manual_seed(0))
        assert init["w"].shape == (30,) and init["b"].shape == ()
        assert init["w"].dtype == torch.float32


def test_apply_numpy_matches_the_reference(rows, fitted):
    X, _ = rows
    mine, ref = _both(fitted)
    got = logreg.apply_numpy(to_numpy(mine), X)
    np.testing.assert_allclose(got, jax_logreg.apply_numpy(fitted, X), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got, logreg.apply(mine, torch.from_numpy(X)).numpy(),
                               rtol=0, atol=1e-6)


def test_fold_standardizer_and_fit_numpy_match_the_reference(rows):
    X, y = rows
    rng = np.random.default_rng(4)
    w, b = rng.normal(size=30), 0.3
    mean, scale = X.mean(0).astype(np.float64), X.std(0).astype(np.float64)
    scale[3] = 0.0  # a constant column keeps its weight
    got = to_numpy(logreg.fold_standardizer(w, b, mean, scale))
    want = jax_logreg.fold_standardizer(w, b, mean, scale)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    got = to_numpy(logreg.fit_numpy(X.astype(np.float64), y, iters=30))
    want = jax_logreg.fit_numpy(X.astype(np.float64), y, iters=30)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_from_sklearn_matches_the_reference(dataset):
    scaler = StandardScaler().fit(dataset.X)
    clf = LogisticRegression(max_iter=500).fit(scaler.transform(dataset.X), dataset.y)
    for sc in (scaler, None):
        got = to_numpy(logreg.from_sklearn(clf, sc))
        want = jax_logreg.from_sklearn(clf, sc)
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    p = logreg.apply(logreg.from_sklearn(clf, scaler), torch.from_numpy(dataset.X)).numpy()
    np.testing.assert_allclose(p, clf.predict_proba(scaler.transform(dataset.X))[:, 1],
                               rtol=1e-4, atol=1e-5)
