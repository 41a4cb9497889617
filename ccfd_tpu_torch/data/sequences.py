"""Transaction-history windows for the sequence scorer.

The port's copy of ccfd_tpu/data/sequences.py: (N, L, 30) sliding windows
over the time-ordered transaction stream, each labeled with the fraud
label of its *last* transaction.
"""

from __future__ import annotations

import numpy as np

from ccfd_tpu_torch.data.ccfd import Dataset


def build_windows(ds: Dataset, seq_len: int, stride: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """-> (X (N, L, F) float32, y (N,) int32); N = floor((n - L) / stride) + 1."""
    n = ds.n
    if n < seq_len:
        raise ValueError(f"dataset has {n} rows < seq_len {seq_len}")
    starts = np.arange(0, n - seq_len + 1, stride)
    idx = starts[:, None] + np.arange(seq_len)[None, :]
    return ds.X[idx], ds.y[idx[:, -1]]
