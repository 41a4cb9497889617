"""Carry model params between the JAX reference and the port.

A param tree is nested dicts and lists whose leaves are tensors (or numpy
arrays, or Python scalars). The MLP's (ccfd_tpu/models/mlp.py) is
``{"norm": {"mu", "sigma"}, "layers": [{"w", "b"} x depth]}``; its int8
params (ccfd_tpu/ops/quant.py) hold ``{"wq", "scale", "b"}`` per layer;
``logreg``/``modelfull`` hold ``{"w", "b"}``, the tree family ``{"feature",
"threshold", "leaf", "base"}``, and an inference graph ``{node name: that
node's params}``. Floating leaves are float32 in the port; integer leaves
keep their type (int8 ``wq``, int32 ``feature``). ``to_numpy``,
``to_device`` and ``flatten`` take any such tree.

On disk the port reads an ``.npz`` whose keys flatten the MLP or int8
tree: ``norm/mu``, ``norm/sigma``, then ``layers/{i}/w``, ``layers/{i}/b``
(f32) or ``layers/{i}/wq`` (int8, kept int8), ``layers/{i}/scale``,
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

# the MLP's and the int8 MLP's param trees with placeholder leaves: the
# structures a checkpoint restore rebuilds (parallel/checkpoint.py)
MLP_LIKE = {"norm": {"mu": None, "sigma": None},
            "layers": [{"w": None, "b": None} for _ in range(3)]}
Q8_LIKE = {"norm": {"mu": None, "sigma": None},
           "layers": [{"wq": None, "scale": None, "b": None} for _ in range(3)]}

# per-layer leaves of each tree, with their dtype
_F32_LEAVES = {"w": np.float32, "b": np.float32}
_Q8_LEAVES = {"wq": np.int8, "scale": np.float32, "b": np.float32}


def _mlp_tree(tree: Mapping[str, Any], leaves: dict) -> dict:
    """The MLP-shaped ``tree`` cut to the normalizer and ``leaves`` per
    layer, each leaf a numpy array of its dtype."""
    return {"norm": {k: np.asarray(tree["norm"][k], np.float32) for k in ("mu", "sigma")},
            "layers": [{k: np.asarray(layer[k], dt) for k, dt in leaves.items()}
                       for layer in tree["layers"]]}


def from_jax_params(tree: Mapping[str, Any],
                    device: "str | torch.device" = "cpu") -> dict:
    """The reference's MLP pytree (numpy arrays or anything ``np.asarray``
    takes) -> the port's params: float32 tensors on ``device``."""
    return to_device(_mlp_tree(tree, _F32_LEAVES), device)


def from_jax_q8_params(tree: Mapping[str, Any],
                       device: "str | torch.device" = "cpu") -> dict:
    """The reference's int8 pytree (ops/quant.py quantize_mlp) -> the
    port's: ``wq`` int8, ``scale``, ``b`` and the normalizer float32, on
    ``device``."""
    return to_device(_mlp_tree(tree, _Q8_LEAVES), device)


def tree_map(fn: Any, tree: Any) -> Any:
    """``fn`` applied to every leaf of a tree of dicts and lists, the
    structure kept (dict order too)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def host_leaf(a: Any) -> np.ndarray:
    """One leaf as a fresh host numpy array: floats float32, integers (int8
    ``wq``, int32 ``feature``) their own type."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return np.array(a, np.float32 if a.dtype.kind == "f" else a.dtype)


def tensor_leaf(a: Any, device: "str | torch.device" = "cpu", copy: bool = False) -> torch.Tensor:
    """One leaf as a tensor on ``device``: floats float32, integers their
    own type; the same tensor when nothing changes, unless ``copy``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(host_leaf(a))
    return t.to(device, torch.float32 if t.is_floating_point() else t.dtype, copy=copy)


def to_numpy(params: Any) -> dict:
    """The port's params (any tree) -> the same tree of host numpy arrays."""
    return tree_map(host_leaf, params)


def to_device(tree: Any, device: "str | torch.device") -> dict:
    """The same param tree with every leaf a tensor on ``device``."""
    return tree_map(lambda a: tensor_leaf(a, device), tree)


def digest(tree: Any) -> str:
    """sha256 (16 hex) over a param tree's flattened paths, dtypes, shapes
    and bytes: two processes serve the same params exactly when the
    digests are equal (``up`` prints the served params'; the smoke holds
    the REST answers against the params it digests)."""
    import hashlib

    h = hashlib.sha256()
    for path, a in sorted(flatten(tree).items()):
        a = np.ascontiguousarray(a)
        h.update(f"{path}:{a.dtype}:{a.shape};".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def flatten(tree: Any) -> dict[str, np.ndarray]:
    """Param tree -> ``{"norm/mu": ..., "layers/0/w": ...}`` numpy arrays:
    each leaf under the path of its dict keys and list indices."""
    flat: dict[str, np.ndarray] = {}

    def walk(node: Any, path: str) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))
        else:
            flat[path] = host_leaf(node)

    walk(tree, "")
    return flat


def from_jax_model_params(name: str, tree: Any,
                          device: "str | torch.device" = "cpu") -> dict:
    """The reference's params of model ``name`` (a pytree of numpy arrays,
    or anything ``np.asarray`` takes) -> the port's, on ``device``. For
    ``mlp_q8``, ``from_jax_q8_params``; for any other model (``mlp``,
    ``logreg``, ``modelfull``, ``gbt``, ``gbt_mxu``, or an inference graph's
    ``{node: params}``) the same tree with floats float32 and integers
    (``feature``, a q8 node's ``wq``) of their own type."""
    if name == "mlp_q8":
        return from_jax_q8_params(tree, device)
    return to_device(tree, device)


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
