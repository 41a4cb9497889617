"""Carry MLP weights between the JAX reference and the port.

The reference's MLP params are a pytree (ccfd_tpu/models/mlp.py):
``{"norm": {"mu", "sigma"}, "layers": [{"w", "b"} x depth]}``; its int8
params (ccfd_tpu/ops/quant.py) hold ``{"wq", "scale", "b"}`` per layer. On
disk the port reads an ``.npz`` whose keys flatten either tree:
``norm/mu``, ``norm/sigma``, then ``layers/{i}/w``, ``layers/{i}/b`` (f32)
or ``layers/{i}/wq`` (int8, kept int8), ``layers/{i}/scale``,
``layers/{i}/b``. ``load_params`` tells the two apart by their keys. The
committed ``assets/mlp_step_1200.npz`` is the reference's
``checkpoints/step_1200`` written that way (tools/export_torch_params.py);
its int8 form is ``ops/quant.py::quantize_mlp`` of it, which equals the
reference's ``checkpoints_q8/step_1200``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

DEFAULT_PARAMS = Path(__file__).resolve().parent / "assets" / "mlp_step_1200.npz"

# the MLP's param tree with placeholder leaves: the structure a checkpoint
# restore rebuilds (parallel/checkpoint.py)
MLP_LIKE = {"norm": {"mu": None, "sigma": None},
            "layers": [{"w": None, "b": None} for _ in range(3)]}

# per-layer leaves of each tree, with their dtype
_F32_LEAVES = {"w": np.float32, "b": np.float32}
_Q8_LEAVES = {"wq": np.int8, "scale": np.float32, "b": np.float32}


def _leaves(layer: Mapping[str, Any]) -> dict:
    return _Q8_LEAVES if "wq" in layer else _F32_LEAVES


def _convert(tree: Mapping[str, Any], conv) -> dict:
    return {
        "norm": {k: conv(tree["norm"][k], np.float32) for k in ("mu", "sigma")},
        "layers": [{k: conv(layer[k], dt) for k, dt in _leaves(layer).items()}
                   for layer in tree["layers"]],
    }


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


def from_jax_q8_params(tree: Mapping[str, Any],
                       device: "str | torch.device" = "cpu") -> dict:
    """The reference's int8 pytree (ops/quant.py quantize_mlp) -> the
    port's: ``wq`` int8, ``scale``, ``b`` and the normalizer float32, on
    ``device``."""
    def t(a: Any, dt: Any) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dt), device=device)

    return _convert({"norm": tree["norm"],
                     "layers": [{k: layer[k] for k in _Q8_LEAVES}
                                for layer in tree["layers"]]}, t)


def to_numpy(params: Mapping[str, Any]) -> dict:
    """The port's params (either tree) -> the same tree of host numpy
    arrays: float32, and int8 for ``wq``."""
    def n(a: Any, dt: Any) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.array(a, dt)

    return _convert(params, n)


def to_device(tree: Mapping[str, Any], device: "str | torch.device") -> dict:
    """The same param tree with every tensor on ``device``."""
    return {"norm": {k: v.to(device) for k, v in tree["norm"].items()},
            "layers": [{k: v.to(device) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def flatten(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Param tree -> ``{"norm/mu": ..., "layers/0/w": ...}`` numpy arrays."""
    tree = to_numpy(tree)
    flat = {"norm/mu": tree["norm"]["mu"], "norm/sigma": tree["norm"]["sigma"]}
    for i, layer in enumerate(tree["layers"]):
        for k, v in layer.items():
            flat[f"layers/{i}/{k}"] = v
    return flat


def save_params(tree: Mapping[str, Any], path: "str | Path") -> None:
    with open(path, "wb") as f:
        np.savez(f, **flatten(tree))


def load_params(path: "str | Path" = DEFAULT_PARAMS,
                device: "str | torch.device" = "cpu") -> dict:
    """Read an ``.npz`` written by ``save_params`` into the port's params:
    the int8 tree when it holds ``layers/{i}/wq``, else the f32 tree."""
    with np.load(path) as z:
        q8 = any(k.endswith("/wq") for k in z.files)
        leaves = _Q8_LEAVES if q8 else _F32_LEAVES
        first = next(iter(leaves))
        depth = sum(1 for k in z.files
                    if k.startswith("layers/") and k.endswith(f"/{first}"))
        tree = {
            "norm": {"mu": z["norm/mu"], "sigma": z["norm/sigma"]},
            "layers": [{k: z[f"layers/{i}/{k}"] for k in leaves}
                       for i in range(depth)],
        }
    return (from_jax_q8_params if q8 else from_jax_params)(tree, device=device)
