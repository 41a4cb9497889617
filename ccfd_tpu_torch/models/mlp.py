"""3-layer MLP tabular fraud scorer: the port of ccfd_tpu/models/mlp.py.

Params are a plain dict of float32 tensors in the reference's layout:
  {"norm": {"mu": (F,), "sigma": (F,)},
   "layers": [{"w": (F,H), "b": (H,)}, {"w": (H,H), "b": (H,)}, {"w": (H,1), "b": (1,)}]}

``logits`` follows the reference step by step: normalize in f32 by dividing
by sigma, cast to the compute dtype, then per hidden layer a matmul with
float32 accumulation, + b, relu, back to the compute dtype; the last layer
accumulates in f32 too. A product of two bf16 values is exact in f32, so an
f32 matmul of the bf16-rounded operands is the reference's
``preferred_element_type=float32`` dot up to summation order.

``logits`` is differentiable and ``loss_fn`` trains through it
(``parallel/train.py``). Under autograd the casts round the gradients where
the reference's transposed dots do: the cotangent of a bf16 operand is
rounded to bf16 and converted back to f32. The normalizer is detached, as
the reference stops its gradient: it is data, not a weight. ``apply`` runs
under ``no_grad``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.data.ccfd import NUM_FEATURES

Params = Mapping[str, Any]

DEFAULT_HIDDEN = 256


def init(
    generator: torch.Generator | None = None,
    num_features: int = NUM_FEATURES,
    hidden: int = DEFAULT_HIDDEN,
    depth: int = 3,
    device: "str | torch.device" = "cpu",
) -> dict:
    """He-initialised weights from ``generator`` (identity normalizer)."""
    dims = [num_features] + [hidden] * (depth - 1) + [1]
    layers = []
    for i in range(depth):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator,
                        dtype=torch.float32)
        w = (w * (2.0 / dims[i]) ** 0.5).to(device)
        layers.append({"w": w, "b": torch.zeros(dims[i + 1], device=device)})
    return {
        "norm": {
            "mu": torch.zeros(num_features, device=device),
            "sigma": torch.ones(num_features, device=device),
        },
        "layers": layers,
    }


def set_normalizer(params: Params, mean: np.ndarray, std: np.ndarray) -> dict:
    sigma = np.where(np.asarray(std) == 0.0, 1.0, np.asarray(std))
    device = params["layers"][0]["w"].device
    return {
        "norm": {
            "mu": torch.as_tensor(np.asarray(mean, np.float32), device=device),
            "sigma": torch.as_tensor(np.asarray(sigma, np.float32), device=device),
        },
        "layers": params["layers"],
    }


def _dot_f32(h: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``h @ w`` with both operands rounded to ``compute_dtype`` and the sum
    in float32."""
    return torch.matmul(h.float(), w.to(compute_dtype).float())


def logits(params: Params, x: torch.Tensor,
           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # the normalizer is data statistics, not a trainable parameter
    mu = params["norm"]["mu"].detach()
    sigma = params["norm"]["sigma"].detach()
    h = (x.float() - mu) / sigma
    h = h.to(compute_dtype)
    layers = params["layers"]
    for layer in layers[:-1]:
        h = torch.relu(_dot_f32(h, layer["w"], compute_dtype) + layer["b"])
        h = h.to(compute_dtype)
    last = layers[-1]
    z = _dot_f32(h, last["w"], compute_dtype)
    return (z + last["b"]).reshape(x.shape[0])


@torch.no_grad()
def apply(params: Params, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """proba_1 per row: (B, F) -> (B,)."""
    return torch.sigmoid(logits(params, x, compute_dtype))


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor,
            pos_weight: float = 1.0,
            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Weighted binary cross-entropy on the logits (numerically stable)."""
    from ccfd_tpu_torch.models.losses import weighted_bce_from_logits

    return weighted_bce_from_logits(logits(params, x, compute_dtype), y, pos_weight)


def apply_numpy(params: Params, x: np.ndarray) -> np.ndarray:
    """Pure-numpy forward (f32), semantically ``apply`` without a device.
    ``params`` must hold host numpy arrays (``params.to_numpy``)."""
    from ccfd_tpu_torch.utils.metrics_math import stable_sigmoid

    h = (np.asarray(x, np.float32) - params["norm"]["mu"]) / params["norm"]["sigma"]
    layers = params["layers"]
    for layer in layers[:-1]:
        h = np.maximum(h @ layer["w"] + layer["b"], 0.0)
    last = layers[-1]
    z = (h @ last["w"] + last["b"]).reshape(x.shape[0])
    return stable_sigmoid(z)
