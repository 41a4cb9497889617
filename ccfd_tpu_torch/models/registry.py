"""Model registry: name -> (init, apply), as ccfd_tpu/models/registry.py.

The port serves ``mlp`` (bf16, kernel B1) and ``mlp_q8`` (int8, kernels
B2 and B3; registered by ``ops/quant.py::register``, whose ``init``
quantizes a seeded MLP). The other families of the reference (logreg, gbt,
seq) are queued in ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ccfd_tpu_torch.models import mlp


@dataclass(frozen=True)
class ModelSpec:
    name: str
    init: Callable[..., Any]
    apply: Callable[..., Any]  # (params, x, compute_dtype) -> proba_1 (B,)
    apply_numpy: Callable[..., Any]


_REGISTRY: dict[str, ModelSpec] = {
    "mlp": ModelSpec("mlp", mlp.init, mlp.apply, mlp.apply_numpy),
}


def register_model(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def get_model(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"model {name!r} is not ported yet (the port serves "
            f"{sorted(_REGISTRY)}); see ROADMAP.md for the queue") from None


def _register_builtin() -> None:
    from ccfd_tpu_torch.ops import quant

    quant.register()


_register_builtin()
