"""Seldon-shaped inference graph as one torch function: the port of
ccfd_tpu/serving/graph.py.

The reference's model-serving layer is Seldon Core, whose unit of
deployment is an inference graph: a tree of typed nodes declared in a
SeldonDeployment CR (``deploy/model/graph_ensemble.json``). Node types:

- ``MODEL``              scores the features (a registry model);
- ``TRANSFORMER``        rewrites the input before its child sees it;
- ``OUTPUT_TRANSFORMER`` rewrites its child's output;
- ``COMBINER``           merges the outputs of >= 2 children;
- ``ROUTER``             splits traffic between >= 2 children.

``build()`` closes the tree into one ``(params, x, compute_dtype) -> (B,)``
function of torch operations, as the reference closes it into one jitted
XLA function: no per-node hop. A ROUTER scores every branch on the full
batch and blends the results with per-row simplex weights (one-hot for
hard routing), so shapes stay static.

``hash_split`` hashes a row as ``frac(|x · (1..F) · 0.618...|)`` in float32.
On Kaggle-scale ``Amount`` |h| reaches ~1e4, where float32 keeps u to about
three decimals, so another summation order can move a row across an arm
boundary; on the card the dot needs TF32 off (it raises otherwise).

Params are ``{node name: node params}`` (``{}`` for stateless nodes), so
``Scorer.swap_params`` can replace any node's weights. ``as_model_spec()``
registers the graph as a model, a drop-in ``CCFD_MODEL`` for the Scorer and
the REST server; a graph may not take the name of a built-in model.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.device import require_full_f32
from ccfd_tpu_torch.models.registry import ModelSpec, get_model, register_model

NODE_TYPES = ("MODEL", "TRANSFORMER", "OUTPUT_TRANSFORMER", "COMBINER", "ROUTER")

_EPS = 1e-6
_GOLDEN = np.float32(0.61803398875)


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return torch.log(p) - torch.log1p(-p)


def _feature_index(feature: Any) -> int:
    if isinstance(feature, int):
        return feature
    return FEATURE_NAMES.index(str(feature))


def _f32(values: Any, device: Any = None) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# Component registries: implementation name -> (init, apply).
#
# init(generator, config) -> params ({} for stateless components).
# Transformer apply(params, x, config) -> x'              (B,F) -> (B,F)
# Output-transformer apply(params, p, config) -> p'       (B,)  -> (B,)
# Combiner apply(params, ps, config) -> p                 [(B,)]*n -> (B,)
# Router apply(params, x, config) -> weights              (B,F) -> (B,n) simplex
# --------------------------------------------------------------------------

_TRANSFORMERS: dict[str, tuple[Callable, Callable]] = {}
_OUTPUT_TRANSFORMERS: dict[str, tuple[Callable, Callable]] = {}
_COMBINERS: dict[str, tuple[Callable, Callable]] = {}
_ROUTERS: dict[str, tuple[Callable, Callable]] = {}

_KIND_REGISTRY = {
    "TRANSFORMER": _TRANSFORMERS,
    "OUTPUT_TRANSFORMER": _OUTPUT_TRANSFORMERS,
    "COMBINER": _COMBINERS,
    "ROUTER": _ROUTERS,
}


def register_component(kind: str, name: str, init: Callable, apply: Callable) -> None:
    _KIND_REGISTRY[kind][name] = (init, apply)


def _no_params(generator, config):
    return {}


# -- transformers ----------------------------------------------------------

def _standardize_init(generator, config):
    n = len(FEATURE_NAMES)
    scale = _f32(config.get("scale", [1.0] * n))
    return {"mean": _f32(config.get("mean", [0.0] * n)),
            "scale": torch.where(scale == 0.0, torch.ones_like(scale), scale)}


register_component("TRANSFORMER", "standardize", _standardize_init,
                   lambda p, x, cfg: (x - p["mean"]) / p["scale"])
register_component("TRANSFORMER", "identity", _no_params, lambda p, x, cfg: x)
register_component(
    "TRANSFORMER", "clip", _no_params,
    lambda p, x, cfg: torch.clamp(x, float(cfg.get("lo", -1e6)), float(cfg.get("hi", 1e6))))

# -- output transformers ---------------------------------------------------

register_component("OUTPUT_TRANSFORMER", "identity", _no_params, lambda p, y, cfg: y)
# Platt scaling: recalibrate a scorer's probabilities without retraining it
register_component(
    "OUTPUT_TRANSFORMER", "platt",
    lambda generator, cfg: {"a": _f32(float(cfg.get("a", 1.0))),
                            "b": _f32(float(cfg.get("b", 0.0)))},
    lambda p, y, cfg: torch.sigmoid(p["a"] * _logit(y) + p["b"]))

# -- combiners -------------------------------------------------------------

register_component("COMBINER", "average", _no_params,
                   lambda p, ys, cfg: torch.stack(ys).mean(dim=0))
register_component("COMBINER", "max", _no_params,
                   lambda p, ys, cfg: torch.stack(ys).amax(dim=0))


def _weighted_init(generator, config):
    w = config.get("weights")
    if w is None:
        raise ValueError("combiner 'weighted' needs config weights: [..]")
    w = _f32([float(v) for v in w])
    return {"w": w / w.sum()}


register_component("COMBINER", "weighted", _weighted_init,
                   lambda p, ys, cfg: torch.einsum("n,nb->b", p["w"], torch.stack(ys)))

# -- routers ---------------------------------------------------------------


def _feature_threshold_weights(p, x, cfg):
    """Hard route: child 1 when feature > threshold else child 0 (one-hot)."""
    j = _feature_index(cfg.get("feature", "Amount"))
    hi = (x[:, j] > float(cfg.get("threshold", 0.0))).float()
    return torch.stack([1.0 - hi, hi], dim=1)


register_component("ROUTER", "feature_threshold", _no_params, _feature_threshold_weights)


def _hash_split_init(generator, config):
    w = config.get("weights")
    if w is None:
        raise ValueError("router 'hash_split' needs config weights: [..]")
    w = _f32([float(v) for v in w])
    return {"cum": torch.cumsum(w / w.sum(), dim=0)}


def hash_split_arms(x: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """(B,) int64 arm per row: how many of the cumulative weights (the last
    excluded) u = frac(|h|) reaches, h = x · (1..F) · 0.618... in float32
    (TF32 off on the card)."""
    require_full_f32(x, "the hash_split router")
    # float32 products k * fl32(0.618...), as the numpy mirror's, made on
    # the device (no host copy, so the router captures in a CUDA graph)
    vec = torch.arange(1.0, x.shape[1] + 1.0, dtype=torch.float32,
                       device=x.device) * float(_GOLDEN)
    u = torch.remainder((x.float() @ vec).abs(), 1.0)
    return (u[:, None] >= cum[None, :-1]).sum(dim=1)


def _hash_split_weights(p, x, cfg):
    """Deterministic traffic split (A/B, canary): a per-row hash of the
    features lands each request in a weight bucket, so the same transaction
    always routes to the same arm."""
    n = p["cum"].shape[0]
    arm = hash_split_arms(x, p["cum"])
    return (arm[:, None] == torch.arange(n, device=x.device)).float()


register_component("ROUTER", "hash_split", _hash_split_init, _hash_split_weights)


def hash_split_arms_numpy(x: Any, weights: Any) -> np.ndarray:
    """Host mirror of the ``hash_split`` ROUTER's per-row arm, in float32
    end to end: ``x`` (B, F), ``weights`` per-arm traffic fractions ->
    (B,) int32 arms."""
    x = np.asarray(x, np.float32)
    w = np.asarray([float(v) for v in weights], np.float32)
    cum = np.cumsum(w / np.sum(w))
    vec = np.arange(1.0, x.shape[1] + 1.0, dtype=np.float32) * _GOLDEN
    u = np.mod(np.abs(x @ vec), 1.0)
    return np.sum(u[:, None] >= cum[None, :-1], axis=1).astype(np.int32)


# an arm may differ between two float32 evaluations of the hash only where
# u lies this close to an arm boundary, in float32 ulps of |h|
HASH_SPLIT_MARGIN_ULPS = 4.0


def hash_split_margin_ulps(x: Any, weights: Any) -> np.ndarray:
    """(B,) float64: how far each row's u = frac(|h|), with h taken in
    float64, lies from the nearest arm boundary (a cumulative weight, or
    the wrap at 0 and 1), in float32 ulps of |h|. Two float32 summation
    orders of h can put a row in different arms only where this is small
    (``HASH_SPLIT_MARGIN_ULPS``)."""
    x = np.asarray(x, np.float32).astype(np.float64)
    w = np.asarray([float(v) for v in weights], np.float32)
    cum = np.cumsum(w / np.sum(w))[:-1].astype(np.float64)
    vec = (np.arange(1.0, x.shape[1] + 1.0, dtype=np.float32) * _GOLDEN).astype(np.float64)
    h = np.abs(x @ vec)
    u = np.mod(h, 1.0)
    d = np.minimum(np.abs(u[:, None] - cum[None, :]).min(axis=1, initial=np.inf),
                   np.minimum(u, 1.0 - u))
    return d / np.spacing(h.astype(np.float32)).astype(np.float64)


# --------------------------------------------------------------------------
# Graph spec + compiler
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    """One node of the inference tree."""

    name: str
    type: str
    implementation: str = ""  # component/model name; defaults to node name
    children: tuple["Node", ...] = ()
    config: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.type not in NODE_TYPES:
            raise ValueError(f"node {self.name!r}: unknown type {self.type!r}")
        n = len(self.children)
        if self.type == "MODEL" and n != 0:
            # a (B,) probability is not a feature row: chaining goes through
            # explicit OUTPUT_TRANSFORMER nodes
            raise ValueError(f"MODEL node {self.name!r} must be a leaf")
        if self.type in ("TRANSFORMER", "OUTPUT_TRANSFORMER") and n != 1:
            raise ValueError(f"{self.type} node {self.name!r} needs exactly 1 child")
        if self.type in ("COMBINER", "ROUTER") and n < 2:
            raise ValueError(f"{self.type} node {self.name!r} needs >=2 children")

    @property
    def impl(self) -> str:
        return self.implementation or self.name


_GRAPH_NAMES: set[str] = set()  # registry names owned by graphs (re-register ok)


class InferenceGraph:
    """A validated node tree and its evaluator."""

    def __init__(self, root: Node, name: str | None = None):
        self.root = root
        self.name = name or root.name
        names: list[str] = []

        def walk(n: Node):
            names.append(n.name)
            for c in n.children:
                walk(c)

        walk(root)
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names in graph: {sorted(names)}")
        self.node_names = tuple(names)

        # arity mismatches fail at load time, with the node named
        def check_arity(n: Node):
            kids = len(n.children)
            if n.type == "ROUTER" and n.impl == "feature_threshold" and kids != 2:
                raise ValueError(f"router {n.name!r} (feature_threshold) needs exactly 2 "
                                 f"children, has {kids}")
            w = n.config.get("weights")
            if n.type in ("ROUTER", "COMBINER") and w is not None and len(w) != kids:
                raise ValueError(f"{n.type.lower()} {n.name!r}: {len(w)} weights for "
                                 f"{kids} children")
            for c in n.children:
                check_arity(c)

        check_arity(root)

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_cr(cr: Mapping[str, Any]) -> "InferenceGraph":
        """Load from a SeldonDeployment-shaped CR dict: ``spec.predictors[0]
        .graph``, each node ``{name, type, children, parameters}`` with
        Seldon's ``parameters`` list of ``{name, value, type}`` mapped onto
        the component config. A bare graph dict is taken too."""
        try:
            graph = cr["spec"]["predictors"][0]["graph"]
        except (KeyError, IndexError, TypeError):
            graph = cr
        name = str(cr.get("metadata", {}).get("name", "") if isinstance(cr, Mapping) else "")
        return InferenceGraph(InferenceGraph._parse_node(graph), name=name or None)

    @staticmethod
    def from_cr_file(path: str) -> "InferenceGraph":
        with open(path) as f:
            return InferenceGraph.from_cr(json.load(f))

    @staticmethod
    def _parse_node(d: Mapping[str, Any]) -> Node:
        config: dict[str, Any] = dict(d.get("config", {}))
        for p in d.get("parameters", ()) or ():
            v = p.get("value")
            t = str(p.get("type", "STRING")).upper()
            if t == "INT":
                v = int(v)
            elif t in ("FLOAT", "DOUBLE"):
                v = float(v)
            elif t == "BOOL":
                v = str(v).lower() in ("1", "true", "yes")
            elif t == "JSON":
                v = json.loads(v) if isinstance(v, str) else v
            config[str(p["name"])] = v
        return Node(
            name=str(d["name"]),
            type=str(d.get("type", "MODEL")).upper(),
            implementation=str(d.get("implementation", "") or ""),
            children=tuple(InferenceGraph._parse_node(c) for c in d.get("children", ()) or ()),
            config=config,
        )

    # -- params ------------------------------------------------------------

    def init(self, generator: torch.Generator | None = None) -> dict[str, Any]:
        """Per-node params keyed by node name (stateless nodes get ``{}``),
        drawn from ``generator`` in tree order."""
        params: dict[str, Any] = {}

        def walk(n: Node):
            if n.type == "MODEL":
                params[n.name] = get_model(n.impl).init(generator)
            else:
                init_fn, _ = self._component(n)
                params[n.name] = init_fn(generator, n.config)
            for c in n.children:
                walk(c)

        walk(self.root)
        return params

    @staticmethod
    def _component(n: Node) -> tuple[Callable, Callable]:
        reg = _KIND_REGISTRY[n.type]
        try:
            return reg[n.impl]
        except KeyError:
            raise KeyError(f"no {n.type} component {n.impl!r}; known: {sorted(reg)}") from None

    # -- compilation -------------------------------------------------------

    def build(self) -> Callable[..., torch.Tensor]:
        """Close the tree into one ``(params, x, compute_dtype=) -> (B,)``."""

        def compile_node(n: Node) -> Callable[[dict, torch.Tensor, Any], torch.Tensor]:
            if n.type == "MODEL":
                spec = get_model(n.impl)
                return lambda params, x, dtype, _s=spec, _n=n: _s.apply(
                    params[_n.name], x, dtype)
            _, apply_fn = self._component(n)
            kids = tuple(compile_node(c) for c in n.children)
            if n.type == "TRANSFORMER":
                return lambda params, x, dtype, _a=apply_fn, _k=kids[0], _n=n: _k(
                    params, _a(params[_n.name], x, _n.config), dtype)
            if n.type == "OUTPUT_TRANSFORMER":
                return lambda params, x, dtype, _a=apply_fn, _k=kids[0], _n=n: _a(
                    params[_n.name], _k(params, x, dtype), _n.config)
            if n.type == "COMBINER":
                return lambda params, x, dtype, _a=apply_fn, _ks=kids, _n=n: _a(
                    params[_n.name], [k(params, x, dtype) for k in _ks], _n.config)

            # ROUTER: every branch scores the full batch; the router's
            # per-row simplex weights select or blend
            def run_router(params, x, dtype, _a=apply_fn, _ks=kids, _n=n):
                w = _a(params[_n.name], x, _n.config)
                ys = torch.stack([k(params, x, dtype) for k in _ks])
                return torch.einsum("bn,nb->b", w.float(), ys)

            return run_router

        root_fn = compile_node(self.root)

        @torch.no_grad()
        def apply(params, x, compute_dtype=torch.float32):
            return root_fn(params, x, compute_dtype)

        return apply

    # -- registry integration ---------------------------------------------

    def as_model_spec(self, register: bool = True) -> ModelSpec:
        """The graph as a registry model (a drop-in ``CCFD_MODEL``)."""
        graph_apply = self.build()

        def logits(params, x, compute_dtype=torch.float32):
            return _logit(graph_apply(params, x, compute_dtype=compute_dtype))

        spec = ModelSpec(name=self.name, init=self.init, apply=graph_apply, logits=logits,
                         trainable=False)  # the nodes may include trees
        if register:
            # never clobber a built-in model: a CR named "mlp" would swap
            # graph-shaped params under every later Scorer(model_name="mlp");
            # re-registering a graph name (a CR reload) is fine
            try:
                existing = get_model(self.name)
            except KeyError:
                existing = None
            if existing is not None and self.name not in _GRAPH_NAMES:
                raise ValueError(
                    f"graph name {self.name!r} collides with a registered "
                    f"model; set metadata.name in the CR to a unique name")
            _GRAPH_NAMES.add(self.name)
            register_model(spec)
        return spec


def load_graph_cr(path: str, register: bool = True) -> ModelSpec:
    """CR file -> registered ModelSpec (what ``CCFD_GRAPH_CR`` points at)."""
    return InferenceGraph.from_cr_file(path).as_model_spec(register=register)
