"""Port's checkpoints (parallel/checkpoint.py, runtime/durability.py) vs the
JAX reference's npz form (ccfd_tpu/parallel/checkpoint.py with
``use_orbax=False``, ccfd_tpu/runtime/durability.py).

Each side restores the other's step leaf for leaf and bit for bit, the
frame bytes are the reference's, corruption is quarantined, and an orbax
step (a copy of the repo's ``checkpoints/step_1200`` in ``tmp_path``) is
refused before anything on disk moves.
"""

import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ccfd_tpu.models import mlp as jax_mlp
from ccfd_tpu.ops import quant as jax_quant
from ccfd_tpu.parallel.checkpoint import CheckpointManager as JaxCheckpointManager
from ccfd_tpu.runtime import durability as jax_durability
from ccfd_tpu_torch.parallel import checkpoint
from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
from ccfd_tpu_torch.params import MLP_LIKE, from_jax_params
from ccfd_tpu_torch.runtime import durability
from tests.torch_helpers import mlp_tree

REPO = Path(__file__).resolve().parents[1]
Q8_LIKE = {"norm": {"mu": None, "sigma": None},
           "layers": [{"wq": None, "scale": None, "b": None} for _ in range(3)]}


def _tree(kind: str) -> dict:
    """The reference's tree (numpy leaves): the f32 MLP or its int8 form."""
    X = np.random.default_rng(1).normal(size=(64, 30)).astype(np.float32)
    tree = mlp_tree(X, hidden=32, seed=2)
    if kind == "q8":
        tree = jax.tree.map(np.asarray, jax_quant.quantize_mlp(tree))
    return tree


def _port(tree: dict) -> dict:
    """The same tree as the port's CPU tensors (int8 kept for ``wq``)."""
    return {"norm": {k: torch.from_numpy(np.array(v)) for k, v in tree["norm"].items()},
            "layers": [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def _flat(tree: dict) -> dict:
    out = {f"norm/{k}": v for k, v in tree["norm"].items()}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers/{i}/{k}": v for k, v in layer.items()})
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _bit_equal(a: dict, b: dict) -> None:
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def test_leaf_order_is_jax_flatten_order():
    tree = _tree("mlp")
    assert checkpoint.flatten(MLP_LIKE) == [None] * 8
    names = checkpoint.flatten({"layers": [{k: f"layers/{i}/{k}" for k in layer}
                                           for i, layer in enumerate(tree["layers"])],
                                "norm": {k: f"norm/{k}" for k in tree["norm"]}})
    assert names == ["layers/0/b", "layers/0/w", "layers/1/b", "layers/1/w",
                     "layers/2/b", "layers/2/w", "norm/mu", "norm/sigma"]
    leaves = checkpoint.flatten(tree)
    assert [np.asarray(a).tobytes() for a in leaves] == \
        [np.asarray(a).tobytes() for a in jax.tree.leaves(tree)]
    with pytest.raises(ValueError):
        checkpoint.unflatten(MLP_LIKE, leaves[:-1])


@pytest.mark.parametrize("kind", ["mlp", "q8"])
def test_save_restore_round_trip(tmp_path, kind):
    tree = _port(_tree(kind))
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(7, tree)
    assert sorted(os.listdir(path)) == ["params.npz", "treedef.json"]
    got, step = mgr.restore(MLP_LIKE if kind == "mlp" else Q8_LIKE)
    assert step == 7
    _bit_equal(got, tree)
    assert mgr.verify_step(7) is True and mgr.verify_step(8) is None


@pytest.mark.parametrize("kind", ["mlp", "q8"])
def test_reference_restores_the_ports_step(tmp_path, kind):
    tree = _tree(kind)
    CheckpointManager(str(tmp_path)).save(3, _port(tree))
    like = (jax_mlp.init(jax.random.PRNGKey(0), hidden=32) if kind == "mlp"
            else jax_quant.quantize_mlp(jax_mlp.init(jax.random.PRNGKey(0), hidden=32)))
    got, step = JaxCheckpointManager(str(tmp_path), use_orbax=False).restore(like)
    assert step == 3
    _bit_equal(jax.tree.map(np.asarray, got), tree)


@pytest.mark.parametrize("kind", ["mlp", "q8"])
def test_port_restores_the_references_step(tmp_path, kind):
    tree = _tree(kind)
    JaxCheckpointManager(str(tmp_path), use_orbax=False).save(4, tree)
    got, step = CheckpointManager(str(tmp_path)).restore(MLP_LIKE if kind == "mlp" else Q8_LIKE)
    assert step == 4
    _bit_equal(got, tree)
    if kind == "mlp":  # and the port serves it as its own params
        _bit_equal(from_jax_params(got), _port(tree))


def test_frame_bytes_are_the_references():
    for payload in (b"", b"x", os.urandom(4096)):
        assert durability.frame(payload) == jax_durability.frame(payload)
        assert durability.parse_frame(jax_durability.frame(payload)) == (payload, True)
        assert jax_durability.parse_frame(durability.frame(payload)) == (payload, True)
    assert durability.parse_frame(b"legacy bytes") == (b"legacy bytes", False)
    torn = durability.frame(b"abcdef")[:-1]
    assert durability.parse_frame(torn) == (None, True)


def test_gc_keeps_the_newest_and_the_pinned(tmp_path):
    tree = _port(_tree("mlp"))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.pinned.add(1)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert [s for s, _ in checkpoint._step_dirs(str(tmp_path))] == [1, 3, 4]
    assert mgr.latest_step() == 4


def test_corrupt_step_is_quarantined_and_skipped(tmp_path):
    tree = _port(_tree("mlp"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    mgr.save(2, tree)
    npz = tmp_path / "step_2" / "params.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    assert mgr.verify_step(2) is False
    assert mgr.newest_verified_step() == 1
    assert mgr.newest_verified_step(prefer=[2, 1]) == 1
    before = durability.counts().get("corrupt", {}).get("checkpoint", 0)
    with pytest.raises(durability.CorruptArtifactError):
        mgr.restore(MLP_LIKE)
    assert not (tmp_path / "step_2").exists() and (tmp_path / "step_2.corrupt").is_dir()
    # as in the reference, the failed read and the quarantine each count
    assert durability.counts()["corrupt"]["checkpoint"] == before + 2
    got, step = mgr.restore(MLP_LIKE)
    assert step == 1
    _bit_equal(got, tree)


def test_artifact_falls_back_to_its_last_good_generation(tmp_path):
    """A port-written artifact with generations: the corrupt main file is
    quarantined and the newest generation serves, on both sides."""
    path = str(tmp_path / "doc.bin")
    assert durability.write_artifact(path, b"one", retain=2)
    assert durability.write_artifact(path, b"two", retain=2)
    assert len(durability._generations(path)) == 2
    assert jax_durability.read_artifact(path, quarantine=False) == b"two"
    with open(path, "r+b") as f:
        f.seek(12)
        f.write(b"!")
    assert durability.verify_file(path) is False
    assert durability.read_artifact(path) == b"two"
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    with pytest.raises(FileNotFoundError):
        durability.read_artifact(str(tmp_path / "never"))


def test_start_up_sweep_removes_orphan_tmp_files(tmp_path):
    step = tmp_path / "step_1"
    step.mkdir()
    (step / "params.npz.123.0.tmp").write_bytes(b"torn")
    (tmp_path / "x.tmp").write_bytes(b"torn")
    CheckpointManager(str(tmp_path))
    assert not list(tmp_path.rglob("*.tmp"))


def test_orbax_step_is_refused_before_anything_moves(tmp_path):
    src = REPO / "checkpoints" / "step_1200"
    dst = tmp_path / "step_1200"
    shutil.copytree(src, dst)
    listing = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*"))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1200
    with pytest.raises(NotImplementedError, match="orbax"):
        mgr.restore(MLP_LIKE)
    with pytest.raises(NotImplementedError, match="orbax"):
        mgr.restore(MLP_LIKE, verify=False)
    with pytest.raises(NotImplementedError, match="orbax"):
        mgr.verify_step(1200)
    assert sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")) == listing
    with pytest.raises(NotImplementedError, match="orbax"):
        CheckpointManager(str(tmp_path / "other"), use_orbax=True)
