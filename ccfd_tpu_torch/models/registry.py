"""Model registry: name -> (init, apply), as ccfd_tpu/models/registry.py.

The serving layer and the router look models up by the ``CCFD_MODEL`` /
``SELDON_ENDPOINT`` name, the way the reference selects its Seldon graph
node by name. The port serves:

- ``mlp`` (bf16, kernel B1) and ``mlp_q8`` (int8, kernels B2 and B3;
  registered by ``ops/quant.py::register``, whose ``init`` quantizes a
  seeded MLP);
- ``logreg`` and its alias ``modelfull`` (the reference's Seldon graph
  node name);
- ``gbt`` (the lockstep gather descent) and ``gbt_mxu`` (the gather-free
  evaluation of the same tree params); their ``init`` is an empty 50-tree
  depth-4 ensemble and takes no feature count;
- an inference graph registered under its CR's name
  (``serving/graph.py::InferenceGraph.as_model_spec``);
- the seq family, ``seq`` and ``seq_q8`` (registered by
  ``ops/seq_quant.py::register``), over (B, L, F) histories: served by
  ``serving/history.py::SeqScorer``, not by the row ``Scorer``.

``init(generator)`` takes a seeded ``torch.Generator``; ``apply(params, x,
compute_dtype)`` returns proba_1 (B,).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ccfd_tpu_torch.models import logreg, mlp, trees


@dataclass(frozen=True)
class ModelSpec:
    name: str
    init: Callable[..., Any]
    apply: Callable[..., Any]  # (params, x, compute_dtype) -> proba_1 (B,)
    logits: Callable[..., Any]
    trainable: bool
    # pure-numpy forward over host params (the router's host tier)
    apply_numpy: Callable[..., Any] | None = None


_REGISTRY: dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def get_model(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"model {name!r} is not ported yet (the port serves "
            f"{sorted(_REGISTRY)}); see ROADMAP.md for the queue") from None


def _empty_ensemble(generator: Any = None, n_trees: int = 50, depth: int = 4) -> dict:
    del generator  # the empty ensemble draws nothing
    return trees.init_empty(n_trees, depth)


def _register_builtin() -> None:
    from ccfd_tpu_torch.ops import quant, seq_quant

    for name in ("logreg", "modelfull"):
        register_model(ModelSpec(name, logreg.init, logreg.apply, logreg.logits,
                                 trainable=True, apply_numpy=logreg.apply_numpy))
    register_model(ModelSpec("mlp", mlp.init, mlp.apply, mlp.logits, trainable=True,
                             apply_numpy=mlp.apply_numpy))
    register_model(ModelSpec("gbt", _empty_ensemble, trees.apply, trees.logits,
                             trainable=False, apply_numpy=trees.apply_numpy))
    register_model(ModelSpec("gbt_mxu", _empty_ensemble, trees.apply_mxu, trees.logits_mxu,
                             trainable=False, apply_numpy=trees.apply_numpy))
    quant.register()
    seq_quant.register()


_register_builtin()
