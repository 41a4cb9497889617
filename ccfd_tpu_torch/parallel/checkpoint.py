"""Model checkpoints in the reference's npz form.

The port of ccfd_tpu/parallel/checkpoint.py's ``CheckpointManager`` on its
numpy path. A step is a directory ``<root>/step_<N>`` holding

- ``params.npz``: one array per leaf, ``leaf_0`` ... ``leaf_<n-1>``, in
  ``jax.tree.flatten`` order of the param tree (dict keys sorted, lists in
  order), framed under a sha256 (``runtime/durability.py``);
- ``treedef.json``: ``{"n_leaves": n}``, framed the same way.

For the MLP, ``{"layers": [{"b", "w"} x 3], "norm": {"mu", "sigma"}}``,
the leaves are ``layers/0/b, layers/0/w, layers/1/b, layers/1/w,
layers/2/b, layers/2/w, norm/mu, norm/sigma``; for the int8 tree each layer
is ``b, scale, wq``. So a step the port writes restores in the reference's
``CheckpointManager(use_orbax=False)`` and the other way round.

``restore`` verifies before it loads: a step whose ``params.npz`` fails
its checksum or does not load is quarantined (the step dir renamed
``*.corrupt``) and raises ``CorruptArtifactError``; callers fall back to
``newest_verified_step``. ``keep`` and ``pinned`` bound garbage collection
as in the reference.

Orbax is not ported: ``use_orbax=True`` is refused, and a step dir without
``params.npz`` (the reference's default orbax form, e.g. the repo's
``checkpoints/step_1200``) raises ``NotImplementedError`` naming orbax
before anything on disk is touched.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import shutil
import zipfile
from typing import Any, Iterable

import numpy as np
import torch

from ccfd_tpu_torch.runtime.durability import (
    CorruptArtifactError,
    note,
    read_artifact,
    sweep_tmp,
    verify_file,
    write_artifact,
)

log = logging.getLogger(__name__)


def _step_dirs(root: str) -> list[tuple[int, str]]:
    out = []
    if not os.path.isdir(root):
        return out
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def flatten(tree: Any) -> list[Any]:
    """The leaves of a tree of dicts and lists in ``jax.tree.flatten``
    order: dict keys sorted, list items in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in flatten(item)]
    return [tree]


def unflatten(like: Any, leaves: list[Any]) -> Any:
    """``leaves`` (in :func:`flatten` order) rebuilt into ``like``'s
    structure. Raises ``ValueError`` when the counts differ."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(item) for item in node]
        try:
            return next(it)
        except StopIteration:
            raise ValueError(f"{len(leaves)} leaves for a tree of "
                             f"{len(flatten(like))}") from None

    out = build(like)
    if next(it, None) is not None:
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(flatten(like))}")
    return out


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, use_orbax: bool | None = None):
        if use_orbax:
            raise NotImplementedError(
                "use_orbax=True: orbax checkpoints are not ported; the port "
                "reads and writes the reference's npz form (use_orbax=False)")
        self.root = root
        self.keep = keep
        self.use_orbax = False
        # steps garbage collection never deletes beyond the newest-``keep``
        # window (the reference's lifecycle pins its champion here)
        self.pinned: set[int] = set()
        os.makedirs(root, exist_ok=True)
        # a crash mid-save leaves orphan tmp debris in the step dirs
        sweep_tmp(root, *(p for _s, p in _step_dirs(root)))

    # -- save -------------------------------------------------------------
    def save(self, step: int, params: Any) -> str:
        path = os.path.join(self.root, f"step_{step}")
        os.makedirs(path, exist_ok=True)
        leaves = [_host(leaf) for leaf in flatten(params)]
        buf = io.BytesIO()
        np.savez(buf, **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
        write_artifact(os.path.join(path, "params.npz"), buf.getvalue(),
                       artifact="checkpoint", retain=0)
        write_artifact(os.path.join(path, "treedef.json"),
                       json.dumps({"n_leaves": len(leaves)}).encode(),
                       artifact="checkpoint", retain=0)
        self._gc()
        return path

    # -- verification -----------------------------------------------------
    def _step_path(self, step: int) -> str | None:
        match = [p for s, p in _step_dirs(self.root) if s == step]
        return match[0] if match else None

    @staticmethod
    def _npz(step: int, path: str) -> str:
        """The step's ``params.npz``; a step without one is in orbax form."""
        npz = os.path.join(path, "params.npz")
        if not os.path.exists(npz):
            raise NotImplementedError(
                f"checkpoint step {step} at {path} has no params.npz: it is an "
                "orbax step (the reference's default form), and orbax is not "
                "ported; write the step with use_orbax=False")
        return npz

    def verify_step(self, step: int) -> bool | None:
        """True when the step's ``params.npz`` verifies (or predates the
        framing: legacy, nothing to check against), False when it fails its
        checksum, None when no such step exists."""
        path = self._step_path(step)
        if path is None:
            return None
        return bool(verify_file(self._npz(step, path)))

    def newest_verified_step(self, prefer: Iterable[int] = ()) -> int | None:
        """The first step that verifies, trying ``prefer`` in order first
        and then every step newest-first."""
        seen: set[int] = set()
        steps = [s for s, _p in _step_dirs(self.root)]
        for s in list(prefer) + sorted(steps, reverse=True):
            if s is None or s in seen or s not in steps:
                continue
            seen.add(s)
            if self.verify_step(s):
                return s
        return None

    def quarantine_step(self, step: int) -> str | None:
        """Move a corrupt step dir out of the listing (``*.corrupt``) so a
        restart never re-reads it; returns the new path."""
        path = self._step_path(step)
        if path is None:
            return None
        dest = f"{path}.corrupt"
        try:
            # ccfd-lint: disable=durability-seam -- quarantine rename (the sanctioned exception): counted via note() below
            os.replace(path, dest)
        except OSError:
            return None
        note("corrupt", artifact="checkpoint")
        log.error("corrupt checkpoint step %d quarantined to %s", step, dest)
        return dest

    # -- restore ----------------------------------------------------------
    def latest_step(self) -> int | None:
        dirs = _step_dirs(self.root)
        return dirs[-1][0] if dirs else None

    def restore(self, like: Any, step: int | None = None,
                verify: bool = True) -> tuple[Any, int] | None:
        """Params structured like ``like`` (CPU tensors of the stored
        dtypes), and their step; None when the root holds no step.

        With ``verify`` (default), a step whose ``params.npz`` fails its
        checksum, or whose bytes no longer load, is quarantined and raises
        :class:`CorruptArtifactError`."""
        dirs = _step_dirs(self.root)
        if not dirs:
            return None
        if step is None:
            step, path = dirs[-1]
        else:
            path = self._step_path(step)
            if path is None:
                raise FileNotFoundError(f"no checkpoint for step {step} in {self.root}")
        npz = self._npz(step, path)
        try:
            raw = read_artifact(npz, artifact="checkpoint", fallback=False,
                                quarantine=False)
            with np.load(io.BytesIO(raw)) as data:
                leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
        except (CorruptArtifactError, zipfile.BadZipFile, ValueError, KeyError) as e:
            # quarantine the whole step dir (params + treedef move together)
            if verify:
                self.quarantine_step(step)
                raise CorruptArtifactError(
                    f"checkpoint step {step} unreadable: {e!r}") from e
            raise
        return unflatten(like, [torch.from_numpy(leaf) for leaf in leaves]), step

    def _gc(self) -> None:
        dirs = _step_dirs(self.root)
        for step, path in dirs[: -self.keep] if self.keep else []:
            if step in self.pinned:
                continue
            shutil.rmtree(path, ignore_errors=True)
