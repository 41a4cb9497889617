"""A frozen copy of the port's Kaggle-shaped surrogate generator
(``ccfd_tpu_torch/data/surrogate.py::kaggle_surrogate``), numpy only.

The benchmark owns its traffic: a later change to the program's generator
must not change the rows a cell sends. The generator follows the public
summary statistics of the Kaggle credit-card table (284,807 rows, 492
frauds, ``Time, V1..V28, Amount``): the PCA variance ladder, the fraud
class's mean shifts in three sub-populations, heavy-tailed amounts and a
day-night time cycle. Deterministic in ``seed``; any whole number numpy
takes (also above 2**32) is a seed.
"""
from __future__ import annotations

import numpy as np

FEATURE_NAMES = ("Time", *(f"V{i}" for i in range(1, 29)), "Amount")
KAGGLE_ROWS = 284_807
KAGGLE_FRAUDS = 492

_LADDER = np.array([
    1.959, 1.651, 1.516, 1.416, 1.380, 1.332, 1.237, 1.194, 1.099, 1.089,
    1.021, 0.999, 0.995, 0.959, 0.915, 0.876, 0.850, 0.838, 0.814, 0.771,
    0.735, 0.726, 0.624, 0.606, 0.521, 0.482, 0.404, 0.330,
], np.float32)

_FRAUD_SHIFT = np.array([
    -4.77, 3.63, -7.03, 4.54, -3.15, -1.40, -5.57, 0.57, -2.58, -5.68,
    3.80, -6.26, -0.11, -6.97, -0.09, -4.14, -6.67, -2.25, 0.68, 0.37,
    0.71, 0.014, -0.04, -0.105, 0.042, 0.051, 0.17, 0.075,
], np.float32)

_MAX_AMOUNT = 25_691.16


def _time_column(rng: np.random.Generator, n: int, night_weight: float) -> np.ndarray:
    day = rng.integers(0, 2, size=n) * 86_400.0
    bulge = rng.random(n) >= night_weight
    tod = np.where(
        bulge,
        np.clip(rng.normal(14 * 3600, 4.5 * 3600, size=n), 0, 86_399),
        rng.uniform(0, 86_400, size=n),
    )
    return np.sort((day + tod).astype(np.float32))


def _licit_amounts(rng: np.random.Generator, n: int) -> np.ndarray:
    body = np.exp(rng.normal(np.log(22.0), 1.35, size=n))
    tail = rng.random(n) < 0.015
    pareto = (rng.pareto(1.1, size=n) + 1.0) * 150.0
    out = np.where(tail, pareto, body)
    return np.clip(out, 0.0, _MAX_AMOUNT).astype(np.float32)


def _fraud_amounts(rng: np.random.Generator, n: int) -> np.ndarray:
    small = np.exp(rng.normal(np.log(9.2), 1.2, size=n))
    big = rng.random(n) < 0.06
    out = np.where(big, np.exp(rng.normal(np.log(350.0), 1.0, size=n)), small)
    return np.clip(out, 0.0, 2_125.87).astype(np.float32)


def kaggle_surrogate(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(X, y): ``n`` rows of 30 float32 features in the table's column
    order, Time-ordered, and their int32 class labels."""
    rng = np.random.default_rng(seed)
    n_fraud = max(1, round(n * KAGGLE_FRAUDS / KAGGLE_ROWS))
    n_licit = n - n_fraud

    v_licit = rng.normal(0.0, 1.0, size=(n_licit, 28)).astype(np.float32)
    heavy = rng.random(n_licit) < 0.02
    v_licit[heavy] *= 3.0
    v_licit *= _LADDER[None, :]

    v_fraud = rng.normal(0.0, 1.0, size=(n_fraud, 28)).astype(np.float32)
    u = rng.random(n_fraud)
    stealth = u < 0.40
    mode_c = u > 0.85
    scale = np.where(stealth[:, None], 1.25, 2.2).astype(np.float32)
    scale = np.where(mode_c[:, None], 1.5, scale)
    shift = _FRAUD_SHIFT[None, :] * np.where(stealth[:, None], 0.15, 0.9)
    c_shift = 0.3 * _FRAUD_SHIFT + np.concatenate(
        [np.zeros(21, np.float32), 2.5 * _LADDER[21:]]
    )
    shift = np.where(mode_c[:, None], c_shift[None, :], shift).astype(np.float32)
    v_fraud = v_fraud * _LADDER[None, :] * scale + shift

    t_licit = _time_column(rng, n_licit, night_weight=0.25)
    t_fraud = _time_column(rng, n_fraud, night_weight=0.45)
    a_licit = _licit_amounts(rng, n_licit)
    a_fraud = _fraud_amounts(rng, n_fraud)

    X = np.concatenate([
        np.concatenate([t_licit[:, None], v_licit, a_licit[:, None]], axis=1),
        np.concatenate([t_fraud[:, None], v_fraud, a_fraud[:, None]], axis=1),
    ]).astype(np.float32)
    y = np.concatenate([np.zeros(n_licit, np.int32), np.ones(n_fraud, np.int32)])
    order = np.argsort(X[:, 0], kind="stable")
    return np.ascontiguousarray(X[order]), np.ascontiguousarray(y[order])
