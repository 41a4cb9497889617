"""Kaggle CCFD dataset access: schema, CSV loading, and a synthetic generator.

The port's own copy of ccfd_tpu/data/ccfd.py (numpy only). The reference
streams ``creditcard.csv`` (Kaggle credit-card-fraud, 284,807 rows): schema
``Time, V1..V28, Amount`` features + ``Class`` label, 30 features, binary
label, ~0.17% positives. When the real CSV is unavailable,
``synthetic_dataset`` produces a class-conditional Gaussian stream with the
same shape, deterministic in the seed.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, NamedTuple

import numpy as np

FEATURE_NAMES: tuple[str, ...] = ("Time",) + tuple(f"V{i}" for i in range(1, 29)) + ("Amount",)
NUM_FEATURES: int = len(FEATURE_NAMES)  # 30
LABEL_NAME = "Class"


class Dataset(NamedTuple):
    X: np.ndarray  # (N, 30) float32
    y: np.ndarray  # (N,) int32 in {0, 1}

    @property
    def n(self) -> int:
        return self.X.shape[0]


def synthetic_dataset(
    n: int = 20000, fraud_rate: float = 0.01, seed: int = 0
) -> Dataset:
    """Class-conditional Gaussian surrogate for the Kaggle CCFD table.

    V1..V28 mimic PCA components (zero-mean, unit-ish variance) whose means
    shift for the fraud class; Time is a monotone ramp; Amount is log-normal
    with a heavier tail for fraud.
    """
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < fraud_rate).astype(np.int32)
    # Per-component fraud shift, fixed by seed 1234 so it is stable across calls.
    shift_rng = np.random.default_rng(1234)
    shift = shift_rng.normal(0.0, 1.5, size=28).astype(np.float32)
    v = rng.normal(0.0, 1.0, size=(n, 28)).astype(np.float32)
    v = v + y[:, None] * shift[None, :]
    time_col = np.sort(rng.uniform(0.0, 172800.0, size=n)).astype(np.float32)  # two days
    amount = np.exp(rng.normal(3.0 + 1.2 * y, 1.0)).astype(np.float32)
    X = np.concatenate([time_col[:, None], v, amount[:, None]], axis=1).astype(np.float32)
    return Dataset(X=X, y=y)


def parse_csv_rows(rows: Iterator[list[str]], limit: int | None = None) -> Dataset:
    """Parse Kaggle-format rows (header first) from any csv.reader source."""
    xs: list[list[float]] = []
    ys: list[int] = []
    header = next(rows)
    cols = [h.strip().strip('"') for h in header]
    feat_idx = [cols.index(name) for name in FEATURE_NAMES]
    label_idx = cols.index(LABEL_NAME) if LABEL_NAME in cols else None
    for i, row in enumerate(rows):
        if limit is not None and i >= limit:
            break
        xs.append([float(row[j]) for j in feat_idx])
        ys.append(int(float(row[label_idx].strip('"'))) if label_idx is not None else 0)
    return Dataset(
        X=np.asarray(xs, dtype=np.float32), y=np.asarray(ys, dtype=np.int32)
    )


def load_csv(path: str, limit: int | None = None) -> Dataset:
    """Load a Kaggle-format creditcard.csv (header row, Class last column)."""
    with open(path, newline="") as f:
        return parse_csv_rows(iter(csv.reader(f)), limit=limit)


def load_csv_bytes(data: bytes, limit: int | None = None) -> Dataset:
    """Parse an in-memory creditcard.csv."""
    lines = data.decode("utf-8").splitlines()
    return parse_csv_rows(iter(csv.reader(lines)), limit=limit)


def to_csv_bytes(ds: Dataset) -> bytes:
    """Serialize a Dataset back to the Kaggle wire format."""
    out = [",".join(FEATURE_NAMES + (LABEL_NAME,))]
    for i in range(ds.n):
        out.append(",".join(repr(float(v)) for v in ds.X[i]) + f",{int(ds.y[i])}")
    return ("\n".join(out) + "\n").encode()


def load_dataset(
    path: str | None = None, n_synthetic: int = 20000, seed: int = 0
) -> Dataset:
    """The Kaggle CSV when present (path arg or CCFD_CSV env), else synthetic."""
    path = path or os.environ.get("CCFD_CSV", "")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"CCFD csv requested but not found: {path!r} (unset CCFD_CSV to "
                "use the synthetic stream)"
            )
        return load_csv(path)
    return synthetic_dataset(n=n_synthetic, seed=seed)


def iter_transactions(ds: Dataset) -> Iterator[dict]:
    """Yield transactions as dicts, the wire format the producer emits."""
    for i in range(ds.n):
        row = {name: float(ds.X[i, j]) for j, name in enumerate(FEATURE_NAMES)}
        row["id"] = i
        yield row
