"""Numpy math shared by the host-side forwards (copy of the reference's
``ccfd_tpu/utils/metrics_math.stable_sigmoid``)."""

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
