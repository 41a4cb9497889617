"""Model registry: name -> (init, apply), as ccfd_tpu/models/registry.py.

The port serves ``mlp`` only so far; the other families of the reference
(logreg, gbt, mlp_q8, seq) are queued in ROADMAP.md.
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


def get_model(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"model {name!r} is not ported yet (the port serves "
            f"{sorted(_REGISTRY)}); see ROADMAP.md for the queue") from None
