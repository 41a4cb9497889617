"""Logistic-regression fraud scorer: the port of ccfd_tpu/models/logreg.py
(the reference's ``modelfull``).

The reference serves a scikit-learn classifier in a Seldon pod returning a
fraud probability ``proba_1`` per 30-feature row. Feature standardization
(the ``StandardScaler`` stage) is folded into the weights at conversion
time, so scoring is one (B, F) x (F,) dot and a sigmoid.

Params are ``{"w": (F,), "b": ()}`` in float32. ``logits`` rounds the rows
and ``w`` to ``compute_dtype`` and sums their products in float32, as the
reference's ``jnp.dot(..., preferred_element_type=float32)`` does: the
result is float32, not rounded to bf16 (a product of two bf16 values is
exact in f32). On the card the f32 dot needs TF32 off (``logits`` raises
otherwise).

``fit_numpy`` (IRLS), ``fold_standardizer`` and ``from_sklearn`` run in
numpy; ``from_sklearn`` reads a fitted estimator's ``coef_`` and
``intercept_`` (and a scaler's ``mean_`` and ``scale_``) and imports
nothing of scikit-learn.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.data.ccfd import NUM_FEATURES
from ccfd_tpu_torch.device import require_full_f32
from ccfd_tpu_torch.models.mlp import _dot_f32

Params = Mapping[str, Any]


def init(generator: torch.Generator | None = None,
         num_features: int = NUM_FEATURES) -> dict:
    """Small normal weights from ``generator``, zero bias."""
    w = torch.randn((num_features,), generator=generator, dtype=torch.float32) * 0.01
    return {"w": w, "b": torch.zeros((), dtype=torch.float32)}


def logits(params: Params, x: torch.Tensor,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    require_full_f32(x, "logreg")
    z = _dot_f32(x.to(compute_dtype), params["w"], compute_dtype)
    return z + params["b"].float()


@torch.no_grad()
def apply(params: Params, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """proba_1 for each row of x: (B, F) -> (B,)."""
    return torch.sigmoid(logits(params, x, compute_dtype))


def apply_numpy(params: Params, x: np.ndarray) -> np.ndarray:
    """Pure-numpy forward (f32); ``params`` hold host arrays."""
    from ccfd_tpu_torch.utils.metrics_math import stable_sigmoid

    z = np.asarray(x, np.float32) @ np.asarray(params["w"], np.float32)
    z = (z + np.float32(params["b"])).reshape(x.shape[0])
    return stable_sigmoid(z)


def fold_standardizer(w: np.ndarray, b: float, mean: np.ndarray,
                      scale: np.ndarray) -> dict:
    """Fold ``(x - mean) / scale`` into (w, b): w' = w/scale, b' = b - w·(mean/scale)."""
    scale = np.where(scale == 0.0, 1.0, scale)
    w_f = (np.asarray(w, np.float64) / scale).astype(np.float32)
    b_f = np.float32(b - np.dot(np.asarray(w, np.float64), mean / scale))
    return {"w": torch.from_numpy(w_f), "b": torch.tensor(b_f)}


def from_sklearn(clf: Any, scaler: Any = None) -> dict:
    """Convert a fitted LogisticRegression (+ optional StandardScaler)."""
    w = np.asarray(clf.coef_).reshape(-1)
    b = float(np.asarray(clf.intercept_).reshape(()))
    if scaler is not None:
        return fold_standardizer(w, b, np.asarray(scaler.mean_), np.asarray(scaler.scale_))
    return {"w": torch.from_numpy(w.astype(np.float32)),
            "b": torch.tensor(b, dtype=torch.float32)}


def fit_numpy(X: np.ndarray, y: np.ndarray, l2: float = 1.0, iters: int = 50) -> dict:
    """Self-contained IRLS trainer: standardizes, then folds back."""
    mean = X.mean(axis=0)
    scale = X.std(axis=0)
    scale = np.where(scale == 0.0, 1.0, scale)
    Xs = (X - mean) / scale
    n, f = Xs.shape
    Xb = np.concatenate([Xs, np.ones((n, 1))], axis=1)
    beta = np.zeros(f + 1)
    reg = np.eye(f + 1) * l2
    reg[-1, -1] = 0.0
    for _ in range(iters):
        z = Xb @ beta
        p = 1.0 / (1.0 + np.exp(-z))
        wgt = np.maximum(p * (1.0 - p), 1e-6)
        g = Xb.T @ (p - y) + reg @ beta
        H = (Xb * wgt[:, None]).T @ Xb + reg
        step = np.linalg.solve(H, g)
        beta = beta - step
        if np.max(np.abs(step)) < 1e-8:
            break
    return fold_standardizer(beta[:f], float(beta[f]), mean, scale)
