"""Numpy math shared by the host-side forwards and ``quantize``'s evidence
(copies of the reference's ``ccfd_tpu/utils/metrics_math.stable_sigmoid``
and ``roc_auc``)."""

from __future__ import annotations

import numpy as np


def stable_sigmoid(z: np.ndarray) -> np.ndarray:
    """Overflow-safe numpy sigmoid (f32)."""
    z = np.asarray(z, np.float32)
    out = np.empty_like(z, np.float32)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the rank statistic (Mann-Whitney U), handling score ties
    with midranks — equivalent to sklearn.roc_auc_score. O(n log n)."""
    y = np.asarray(y_true).astype(bool).ravel()
    s = np.asarray(scores, np.float64).ravel()
    if y.size != s.size:
        raise ValueError(f"shape mismatch: {y.size} labels vs {s.size} scores")
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes present")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(y.size, np.float64)
    ranks[order] = np.arange(1, y.size + 1, dtype=np.float64)
    # midranks for ties: average the rank over each tied group
    s_sorted = s[order]
    i = 0
    while i < y.size:
        j = i
        while j + 1 < y.size and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    u = ranks[y].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))
