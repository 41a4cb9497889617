"""Gradient-boosted tree ensembles as dense tensor programs: the port of
ccfd_tpu/models/trees.py (models ``gbt`` and ``gbt_mxu``).

Every tree is embedded into a complete binary tree of static depth D,
stored as three dense arrays (heap layout: the children of node i are
2i+1 and 2i+2):

    feature   (T, 2^D - 1) int32   split feature id per internal node
    threshold (T, 2^D - 1) float32 split threshold per internal node
    leaf      (T, 2^D)     float32 leaf values (learning rate folded in)

plus ``base`` (a float32 scalar). A row goes right where ``x > threshold``
(sklearn's ``x <= threshold`` goes left), so a dead slot (threshold +inf)
always goes left. D is read off the leaf array's shape.

Two evaluations of the same params, as in the reference:

- ``logits`` (``gbt``): all T trees descend in lockstep, D levels of
  gathers (``leaf_indices``);
- ``logits_mxu`` (``gbt_mxu``): gather-free. One matmul against a one-hot
  (F, T * (2^D - 1)) matrix reads every node's feature value for every row,
  one comparison gives every node's decision, and the D levels and the leaf
  sum are one-hot masks and sums (``leaf_indices_mxu``). Every mask is
  built by comparison with an ``arange``, never ``F.one_hot``, which on
  CUDA checks its range on the host and syncs at each level. The selection
  matmul is exact only in true float32 (one nonzero product a sum), so on
  the card it raises when TF32 is on. Non-finite features map to
  +/-3e38 first (NaN to -3e38), so NaN and inf rows descend as in the
  gather form and ``inf * 0`` never poisons a row.

``feature`` stays int32 in the params and is cast to int64 where torch
indexes with it. ``from_sklearn_hgb`` and ``from_sklearn_gbt`` read a
fitted estimator's attributes (``_predictors[..].nodes``,
``_baseline_prediction``, ``estimators_[..].tree_``, ``learning_rate``,
``predict``, ``decision_function``) and import nothing of scikit-learn.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.device import require_full_f32

Params = Mapping[str, Any]

# what non-finite features map to before the selection matmul
_BIG = 3.0e38


def num_internal(depth: int) -> int:
    return (1 << depth) - 1


def init_empty(n_trees: int, depth: int, base: float = 0.0) -> dict:
    """All-zero ensemble (every tree returns 0): every slot dead."""
    return {
        "feature": torch.zeros((n_trees, num_internal(depth)), dtype=torch.int32),
        "threshold": torch.full((n_trees, num_internal(depth)), float("inf")),
        "leaf": torch.zeros((n_trees, 1 << depth)),
        "base": torch.tensor(base, dtype=torch.float32),
    }


def depth_of(params: Params) -> int:
    return int(params["leaf"].shape[-1]).bit_length() - 1


def leaf_indices(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, F) -> (B, T) int64: the leaf each row reaches in each tree, by
    the lockstep gather descent."""
    feat, thr = params["feature"].long(), params["threshold"]
    n_trees = feat.shape[0]
    depth = depth_of(params)
    tree_ids = torch.arange(n_trees, device=x.device)[None, :]
    idx = torch.zeros((x.shape[0], n_trees), dtype=torch.long, device=x.device)
    for _ in range(depth):
        xv = torch.gather(x, 1, feat[tree_ids, idx])  # (B, T)
        idx = 2 * idx + 1 + (xv > thr[tree_ids, idx]).long()
    return idx - num_internal(depth)


def _leaf_sum(params: Params, leaf_idx: torch.Tensor) -> torch.Tensor:
    leaf = params["leaf"]
    tree_ids = torch.arange(leaf.shape[0], device=leaf.device)[None, :]
    return params["base"] + leaf[tree_ids, leaf_idx].sum(dim=-1)


def logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, F) -> (B,) raw ensemble scores (base + sum of leaf values)."""
    return _leaf_sum(params, leaf_indices(params, x))


@torch.no_grad()
def apply(params: Params, x: torch.Tensor, compute_dtype: Any = None) -> torch.Tensor:
    """proba_1 per row: (B, F) -> (B,). ``compute_dtype`` is accepted for
    the registry's signature and ignored: the trees compare float32."""
    del compute_dtype
    return torch.sigmoid(logits(params, x))


def _onehot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``idx[..., None] == arange(n)`` as ``dtype``: a one-hot without a
    host range check."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def leaf_indices_mxu(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, F) -> (B, T) int64 leaf indices by the gather-free evaluation."""
    require_full_f32(x, "gbt_mxu's selection matmul")
    feat, thr = params["feature"], params["threshold"]
    n_trees, n_int = feat.shape
    depth = depth_of(params)
    x_safe = torch.nan_to_num(x, nan=-_BIG, posinf=_BIG, neginf=-_BIG)
    # (F, T*nI): column j selects node j's split feature
    onehot = _onehot(feat.reshape(-1).long(), x.shape[1], x.dtype).T
    xv = (x_safe @ onehot).reshape(x.shape[0], n_trees, n_int)
    dec = (xv > thr[None]).to(torch.int32)  # (B, T, nI)
    del xv
    idx = torch.zeros((x.shape[0], n_trees), dtype=torch.long, device=x.device)
    for _ in range(depth):
        # dec[b, t, idx[b, t]] without a gather: a one-hot mask and a sum
        d = (dec * _onehot(idx, n_int, dec.dtype)).sum(dim=-1)
        idx = 2 * idx + 1 + d
    return idx - n_int


def logits_mxu(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, F) -> (B,) raw scores, gather-free: the leaf values selected by
    a one-hot mask and summed over leaves, then over trees. The sum over
    leaves holds one nonzero term, so it is exact, and the sum over trees
    is the gather form's own reduction: where the two reach the same
    leaves they agree bit for bit."""
    leaf = params["leaf"]
    leaf_mask = _onehot(leaf_indices_mxu(params, x), leaf.shape[1], leaf.dtype)
    return params["base"] + (leaf[None] * leaf_mask).sum(dim=-1).sum(dim=-1)


@torch.no_grad()
def apply_mxu(params: Params, x: torch.Tensor, compute_dtype: Any = None) -> torch.Tensor:
    """proba_1 per row via the gather-free evaluation."""
    del compute_dtype
    return torch.sigmoid(logits_mxu(params, x))


def apply_numpy(params: Params, x: np.ndarray) -> np.ndarray:
    """Pure-numpy forward, ``apply`` without a device (the lockstep descent
    with numpy gathers); ``params`` hold host arrays."""
    from ccfd_tpu_torch.utils.metrics_math import stable_sigmoid

    feat = np.asarray(params["feature"])
    if not np.issubdtype(feat.dtype, np.integer):
        feat = feat.astype(np.int64)
    thr = np.asarray(params["threshold"])
    leaf = np.asarray(params["leaf"])
    x = np.asarray(x, np.float32)
    n_trees = leaf.shape[0]
    depth = depth_of(params)
    tree_ids = np.arange(n_trees)[None, :]
    idx = np.zeros((x.shape[0], n_trees), np.int32)
    for _ in range(depth):
        xv = np.take_along_axis(x, feat[tree_ids, idx], axis=1)
        idx = 2 * idx + 1 + (xv > thr[tree_ids, idx]).astype(np.int32)
    leaf_idx = idx - num_internal(depth)
    z = float(params["base"]) + leaf[tree_ids, leaf_idx].sum(axis=-1)
    return stable_sigmoid(z.astype(np.float32))


def _embed_tree(children_left: np.ndarray, children_right: np.ndarray,
                feature: np.ndarray, threshold: np.ndarray, value: np.ndarray,
                depth: int, scale: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One source tree -> (feature, threshold, leaf) of the complete tree of
    ``depth``. An early leaf propagates its value to every leaf slot below
    it; its internal slots stay dead (feature 0, threshold +inf)."""
    n_int = num_internal(depth)
    f = np.zeros(n_int, np.int32)
    t = np.full(n_int, np.inf, np.float32)
    leaves = np.zeros(1 << depth, np.float32)

    def rec(node: int, pos: int, level: int) -> None:
        is_leaf = children_left[node] == -1
        if level == depth:
            if not is_leaf:
                raise ValueError(f"source tree deeper than depth={depth}")
            leaves[pos - n_int] = scale * float(value[node])
            return
        if is_leaf:
            rec(node, 2 * pos + 1, level + 1)
            rec(node, 2 * pos + 2, level + 1)
            return
        f[pos] = int(feature[node])
        t[pos] = float(threshold[node])
        rec(int(children_left[node]), 2 * pos + 1, level + 1)
        rec(int(children_right[node]), 2 * pos + 2, level + 1)

    rec(0, 0, 0)
    return f, t, leaves


def _stacked(fs: list, ts: list, ls: list, base: float) -> dict:
    return {"feature": torch.from_numpy(np.stack(fs)),
            "threshold": torch.from_numpy(np.stack(ts)),
            "leaf": torch.from_numpy(np.stack(ls)),
            "base": torch.tensor(base, dtype=torch.float32)}


def from_sklearn_hgb(clf: Any, max_embed_depth: int = 10) -> dict:
    """Convert a fitted binary HistGradientBoostingClassifier.

    raw_score(x) = baseline + sum_t tree_t(x); leaf values already carry
    the shrinkage. The missing-value branch is not embedded (the pipeline
    zero-fills bad cells at decode); categorical splits are refused. The
    embedding is 2^depth nodes a tree, so a tree deeper than
    ``max_embed_depth`` is refused."""
    if getattr(clf, "n_trees_per_iteration_", 1) != 1:
        raise ValueError("from_sklearn_hgb supports binary classifiers "
                         "only (one tree per boosting iteration)")
    adapters = []
    max_depth_seen = 0
    for pred in (p[0] for p in clf._predictors):
        nodes = pred.nodes
        if np.any(nodes["is_categorical"]):
            raise ValueError("categorical splits are not embeddable")
        is_leaf = nodes["is_leaf"].astype(bool)
        cl = np.where(is_leaf, -1, nodes["left"].astype(np.int64))
        cr = np.where(is_leaf, -1, nodes["right"].astype(np.int64))

        def tree_depth(node: int = 0, cl=cl, cr=cr) -> int:
            if cl[node] == -1:
                return 0
            return 1 + max(tree_depth(int(cl[node])), tree_depth(int(cr[node])))

        max_depth_seen = max(max_depth_seen, tree_depth())
        adapters.append((cl, cr, nodes["feature_idx"].astype(np.int64),
                         nodes["num_threshold"].astype(np.float64),
                         nodes["value"].astype(np.float64)))
    if max_depth_seen > max_embed_depth:
        raise ValueError(
            f"HGB tree depth {max_depth_seen} > {max_embed_depth}: the "
            "dense embedding is 2^depth nodes/tree — retrain with "
            "max_depth bounded (e.g. 6-8) for a servable model")
    depth = max(max_depth_seen, 1)
    embedded = [_embed_tree(*a, depth, scale=1.0) for a in adapters]
    base = float(np.asarray(clf._baseline_prediction).reshape(()))
    return _stacked(*zip(*embedded), base)


def from_sklearn_gbt(clf: Any) -> dict:
    """Convert a fitted binary GradientBoostingClassifier: score(x) =
    init prior + lr * sum_t tree_t(x), the learning rate folded into the
    leaves and the prior into ``base``."""
    trees = [e[0].tree_ for e in clf.estimators_]
    depth = max(t.max_depth for t in trees)
    lr = float(clf.learning_rate)
    embedded = [_embed_tree(t.children_left, t.children_right, t.feature, t.threshold,
                            t.value.reshape(-1), depth, scale=lr) for t in trees]
    # the init prior, recovered from one probe row (robust across versions)
    probe = np.zeros((1, clf.n_features_in_), dtype=np.float64)
    tree_sum = lr * sum(float(e[0].predict(probe)[0]) for e in clf.estimators_)
    base = float(np.asarray(clf.decision_function(probe)).reshape(())) - tree_sum
    return _stacked(*zip(*embedded), base)
