"""The plain reference of the MLP family, numpy only. It imports nothing of
the program and takes nothing the program made: it reads the checkpoint
file itself and works out the folding and the quantization again.

- ``forward_bf16``: the 3-layer MLP 30 -> 256 -> 256 -> 1 at the rounding
  points the configuration states for bf16 serving (the system's kernel
  B1): the normalizer folded into the first layer in float32
  (``x @ (W1 / sigma) + (b1 - (mu / sigma) @ W1)``), rows, weights and each
  hidden activation rounded to bf16 (to nearest, ties to even), every sum
  in float32 over exact bf16 products, the last layer an f32 sum against
  the bf16 w3, then the sigmoid.
- ``quantize`` and ``forward_int``: a frozen copy of the int8
  post-training quantization (symmetric per-output-channel weights,
  ``scale = max(max|W[:, o]| / qmax, 1e-8)``) and its forward (per-row
  dynamic activations before every layer, exact integer sums, then
  ``((acc * s_x) * scale) + b`` in float32; the integer sums are taken in
  float64, exact below 2**53), for any width: ``bits=8`` is
  the int8 model, ``bits=4`` the control one step below it.
"""
from __future__ import annotations

import numpy as np

EPS = np.float32(1e-8)


def load(path: str) -> dict:
    """The f32 checkpoint (``layers/{i}/w``, ``layers/{i}/b``,
    ``norm/mu``, ``norm/sigma``) as numpy arrays."""
    with np.load(path) as z:
        depth = sum(1 for k in z.files if k.startswith("layers/") and k.endswith("/w"))
        return {
            "mu": z["norm/mu"].astype(np.float32),
            "sigma": z["norm/sigma"].astype(np.float32),
            "w": [z[f"layers/{i}/w"].astype(np.float32) for i in range(depth)],
            "b": [z[f"layers/{i}/b"].astype(np.float32) for i in range(depth)],
        }


def bf16(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 value (ties to even), as float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = ((u >> np.uint32(16)) & np.uint32(1)) + np.uint32(0x7FFF)
    return ((u + r) & np.uint32(0xFFFF0000)).view(np.float32)


def sigmoid(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, np.float64)
    return 1.0 / (1.0 + np.exp(-z))


def forward_bf16(p: dict, x: np.ndarray) -> np.ndarray:
    """(B, 30) float32 rows -> (B,) probabilities (float64)."""
    w1, w2, w3 = p["w"]
    b1, b2, b3 = p["b"]
    s = (np.float32(1.0) / np.where(p["sigma"] == 0.0, np.float32(1.0), p["sigma"])).astype(
        np.float32)
    w1f = (s[:, None] * w1).astype(np.float32)
    b1f = (b1 - (p["mu"] * s) @ w1).astype(np.float32)
    h = bf16(x)
    h = bf16(np.maximum((h @ bf16(w1f)) + b1f, np.float32(0.0)))
    h = bf16(np.maximum((h @ bf16(w2)) + b2, np.float32(0.0)))
    z = (h @ bf16(w3)).reshape(-1) + b3[0]
    return sigmoid(z.astype(np.float32))


def quantize(p: dict, bits: int = 8) -> dict:
    """Per-output-channel symmetric weights at ``bits``."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    wq, scales = [], []
    for w in p["w"]:
        scale = np.maximum(np.abs(w).max(axis=0) / qmax, EPS).astype(np.float32)
        wq.append(np.clip(np.rint(w / scale), -qmax, qmax).astype(np.float64))
        scales.append(scale)
    return {"mu": p["mu"], "sigma": p["sigma"], "wq": wq, "scale": scales, "b": p["b"],
            "qmax": qmax}


def _quantize_rows(h: np.ndarray, qmax: np.float32) -> tuple[np.ndarray, np.ndarray]:
    amax = np.abs(h).max(axis=1)
    s = np.maximum(amax / qmax, EPS).astype(np.float32)
    q = np.clip(np.rint(h / s[:, None]), -qmax, qmax).astype(np.float64)
    return q, s


def forward_int(q: dict, x: np.ndarray) -> np.ndarray:
    """(B, 30) float32 rows -> (B,) probabilities (float64) of the
    quantized model ``q``."""
    h = ((np.asarray(x, np.float32) - q["mu"]) / q["sigma"]).astype(np.float32)
    n = len(q["wq"])
    for i in range(n):
        qx, sx = _quantize_rows(h, q["qmax"])
        acc = (qx @ q["wq"][i]).astype(np.float32)
        h = (acc * sx[:, None] * q["scale"][i] + q["b"][i]).astype(np.float32)
        if i < n - 1:
            h = np.maximum(h, np.float32(0.0))
    return sigmoid(h.reshape(-1))


def blocks(fn, x: np.ndarray, rows: int = 16384) -> np.ndarray:
    """``fn`` over ``x`` in blocks of ``rows``, so the reference fits."""
    return np.concatenate([fn(x[i:i + rows]) for i in range(0, len(x), rows)]) if len(x) \
        else np.zeros(0)
