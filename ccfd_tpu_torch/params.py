"""Carry MLP weights between the JAX reference and the port.

The reference's MLP params are a pytree (ccfd_tpu/models/mlp.py):
``{"norm": {"mu", "sigma"}, "layers": [{"w", "b"} x depth]}``. On disk the
port reads an ``.npz`` whose keys flatten that tree: ``norm/mu``,
``norm/sigma``, ``layers/{i}/w``, ``layers/{i}/b``. The committed
``assets/mlp_step_1200.npz`` is the reference's ``checkpoints/step_1200``
written that way (tools/export_torch_params.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

DEFAULT_PARAMS = Path(__file__).resolve().parent / "assets" / "mlp_step_1200.npz"


def from_jax_params(tree: Mapping[str, Any],
                    device: "str | torch.device" = "cpu") -> dict:
    """The reference's MLP pytree (numpy arrays or anything ``np.asarray``
    takes) -> the port's params: float32 tensors on ``device``."""
    def t(a: Any) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {
        "norm": {"mu": t(tree["norm"]["mu"]), "sigma": t(tree["norm"]["sigma"])},
        "layers": [{"w": t(layer["w"]), "b": t(layer["b"])}
                   for layer in tree["layers"]],
    }


def to_numpy(params: Mapping[str, Any]) -> dict:
    """The port's params -> the same tree of host float32 numpy arrays."""
    def n(a: Any) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            return a.detach().to("cpu", torch.float32).numpy().copy()
        return np.asarray(a, np.float32)

    return {
        "norm": {"mu": n(params["norm"]["mu"]), "sigma": n(params["norm"]["sigma"])},
        "layers": [{"w": n(layer["w"]), "b": n(layer["b"])}
                   for layer in params["layers"]],
    }


def flatten(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Param tree -> ``{"norm/mu": ..., "layers/0/w": ...}`` numpy arrays."""
    tree = to_numpy(tree)
    flat = {"norm/mu": tree["norm"]["mu"], "norm/sigma": tree["norm"]["sigma"]}
    for i, layer in enumerate(tree["layers"]):
        flat[f"layers/{i}/w"] = layer["w"]
        flat[f"layers/{i}/b"] = layer["b"]
    return flat


def save_params(tree: Mapping[str, Any], path: "str | Path") -> None:
    with open(path, "wb") as f:
        np.savez(f, **flatten(tree))


def load_params(path: "str | Path" = DEFAULT_PARAMS,
                device: "str | torch.device" = "cpu") -> dict:
    """Read an ``.npz`` written by ``save_params`` into the port's params."""
    with np.load(path) as z:
        depth = sum(1 for k in z.files if k.startswith("layers/") and k.endswith("/w"))
        tree = {
            "norm": {"mu": z["norm/mu"], "sigma": z["norm/sigma"]},
            "layers": [{"w": z[f"layers/{i}/w"], "b": z[f"layers/{i}/b"]}
                       for i in range(depth)],
        }
    return from_jax_params(tree, device=device)
