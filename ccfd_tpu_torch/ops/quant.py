"""Int8 quantized MLP: the port of ccfd_tpu/ops/quant.py (model ``mlp_q8``).

- **Weights**: symmetric per-output-channel int8 (``quantize_mlp``),
  computed in numpy exactly as the reference does, so the port's int8
  params equal the reference's bit for bit:
  ``scale_o = max(max|W[:, o]| / 127, 1e-8)``,
  ``wq = clip(rint(W / scale), -127, 127)``.
- **Activations**: symmetric per-row dynamic int8 before every layer: one
  amax per row, ``s = max(amax / 127, 1e-8)``, ``q = clip(rint(h / s),
  -127, 127)`` (``rint`` rounds half to even, as ``torch.round`` does).
- **Accumulation**: the integer products are summed exactly (float64
  here: every int8 x int8 sum below 2^53 is exact), then dequantized in
  the served graph's order, ``((acc * s_x) * scale) + b``.

``logits``/``apply`` are the plain torch forward in the served graph's
rounding order (``quant.py:84-99`` of the reference). ``apply_numpy`` is
the host-tier forward of the reference (``:108-133``): it folds the two
scales first, a different rounding, and is not the kernels' plain version
(that is ``ops/fused_mlp_q8.py``).

Params layout: ``{"norm": {"mu", "sigma"}, "layers": [{"wq": int8 (in,
out), "scale": f32 (out,), "b": f32 (out,)}, ...]}``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.data.ccfd import NUM_FEATURES

Params = Mapping[str, Any]

EPS = 1e-8
# finite ceiling for the host-tier per-layer activations (see apply_numpy)
_H_CLAMP = 1e30


def host_array(a: Any, dtype: Any = np.float32) -> np.ndarray:
    """A tensor (on any device) or array-like -> a host numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def quantize_mlp(params: Params) -> dict:
    """f32 MLP params (models/mlp.py layout, tensors or numpy) -> int8
    inference params as CPU tensors: ``wq`` int8, ``scale``/``b``/``norm``
    float32. The numbers are the reference's ``quantize_mlp``'s."""
    layers = []
    for layer in params["layers"]:
        w = host_array(layer["w"])
        scale = np.maximum(np.abs(w).max(axis=0) / 127.0, EPS).astype(np.float32)
        wq = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        layers.append({
            "wq": torch.from_numpy(wq),
            "scale": torch.from_numpy(scale),
            "b": torch.from_numpy(host_array(layer["b"]).copy()),
        })
    return {
        "norm": {"mu": torch.from_numpy(host_array(params["norm"]["mu"]).copy()),
                 "sigma": torch.from_numpy(host_array(params["norm"]["sigma"]).copy())},
        "layers": layers,
    }


def quantize_rows(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (B, K) f32 -> ((B, K) int8, (B,) f32 scale).

    The divisor 127 is a tensor on ``h``'s device, not a Python number: on
    a CUDA tensor PyTorch turns a division by a scalar into a multiply by
    its reciprocal, which differs from the reference's true division in
    the last ulp and can move a quantization step."""
    amax = h.abs().amax(dim=1)
    s = torch.clamp_min(amax / amax.new_tensor(127.0), EPS)
    q = torch.clamp(torch.round(h / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def int_matmul(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product summed over K, returned as float32: the
    sum is taken in float64 (exact) and converted once, as the reference's
    int32 accumulate is converted by ``astype(float32)``."""
    return torch.matmul(q.double(), wq.double()).float()


def _q_dense(h: torch.Tensor, layer: Mapping[str, torch.Tensor]) -> torch.Tensor:
    q, s_x = quantize_rows(h)
    acc = int_matmul(q, layer["wq"])
    return acc * s_x[:, None] * layer["scale"] + layer["b"]


def logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, F) rows -> (B,) float32 logits of the int8 graph."""
    h = (x.float() - params["norm"]["mu"]) / params["norm"]["sigma"]
    layers = params["layers"]
    for layer in layers[:-1]:
        h = torch.relu(_q_dense(h, layer))
    return _q_dense(h, layers[-1]).reshape(x.shape[0])


@torch.no_grad()
def apply(params: Params, x: torch.Tensor, compute_dtype: Any = None) -> torch.Tensor:
    """proba_1 per row: (B, F) -> (B,). ``compute_dtype`` is accepted for
    the registry's signature and ignored: the graph is int8 by design."""
    del compute_dtype
    return torch.sigmoid(logits(params, x))


def apply_numpy(params: Params, x: np.ndarray) -> np.ndarray:
    """Host-tier forward with the same quantized math (int32 accumulate),
    the reference's ``apply_numpy``: the two scales combine first, so a
    degenerate model cannot overflow to inf and then turn a zero weight
    channel into nan, and activations are clamped to a finite ceiling."""
    from ccfd_tpu_torch.utils.metrics_math import stable_sigmoid

    h = (np.asarray(x, np.float32) - host_array(params["norm"]["mu"])) / host_array(
        params["norm"]["sigma"])
    layers = params["layers"]
    for li, layer in enumerate(layers):
        amax = np.abs(h).max(axis=1)
        s_x = np.maximum(amax / 127.0, EPS)
        q = np.clip(np.rint(h / s_x[:, None]), -127, 127).astype(np.int8)
        acc = q.astype(np.int32) @ host_array(layer["wq"], np.int32)
        h = acc.astype(np.float32) * (
            s_x[:, None] * host_array(layer["scale"])[None, :]) + host_array(layer["b"])
        h = np.clip(h, -_H_CLAMP, _H_CLAMP)
        if li < len(layers) - 1:
            h = np.maximum(h, 0.0)
    return stable_sigmoid(h.reshape(x.shape[0]))


def is_quantized(params: Params) -> bool:
    return bool(params["layers"]) and "wq" in params["layers"][0]


def register(base_params: Params | None = None) -> None:
    """Register the int8 graph as model ``mlp_q8``.

    ``init`` quantizes ``base_params`` when given, else a seeded MLP from
    ``models/mlp.py`` (identity normalizer), so ``Scorer(model_name=
    "mlp_q8")`` works standalone; serving passes quantized params."""
    from ccfd_tpu_torch.models import mlp
    from ccfd_tpu_torch.models.registry import ModelSpec, register_model

    def init(generator: torch.Generator | None = None,
             num_features: int = NUM_FEATURES, **kw: Any) -> dict:
        p = base_params if base_params is not None else mlp.init(
            generator, num_features, **kw)
        if "norm" not in p:
            f = p["layers"][0]["w"].shape[0]
            p = mlp.set_normalizer(p, np.zeros(f, np.float32), np.ones(f, np.float32))
        return quantize_mlp(p)

    register_model(ModelSpec("mlp_q8", init, apply, logits, trainable=False,
                             apply_numpy=apply_numpy))
