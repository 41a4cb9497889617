"""The port's committed params file vs the JAX package's orbax checkpoint,
and the copies of the reference's numpy-only modules the port keeps."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ccfd_tpu.cli import _restore_mlp_checkpoint
from ccfd_tpu.config import Config as JaxConfig
from ccfd_tpu.data import ccfd as jax_ccfd
from ccfd_tpu.data import surrogate as jax_surrogate
from ccfd_tpu.utils.metrics_math import stable_sigmoid as jax_stable_sigmoid
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data import ccfd, surrogate
from ccfd_tpu_torch.params import (
    DEFAULT_PARAMS,
    flatten,
    from_jax_params,
    load_params,
    save_params,
    to_numpy,
)
from ccfd_tpu_torch.utils.metrics_math import stable_sigmoid
from tests.torch_helpers import mlp_tree

REPO = Path(__file__).resolve().parents[1]


def test_committed_npz_equals_the_orbax_checkpoint_bit_for_bit():
    ref = jax.tree.map(np.asarray, _restore_mlp_checkpoint(str(REPO / "checkpoints")))
    with np.load(DEFAULT_PARAMS) as z:
        got = {k: z[k] for k in z.files}
    want = flatten(ref)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.astype(np.float32).tobytes(), k
    loaded = to_numpy(load_params())
    assert loaded["layers"][1]["w"].tobytes() == np.asarray(ref["layers"][1]["w"]).tobytes()


def test_from_jax_params_to_numpy_round_trips():
    tree = mlp_tree(np.random.default_rng(0).normal(size=(64, 30)).astype(np.float32), hidden=32)
    params = from_jax_params(tree)
    assert params["layers"][0]["w"].dtype == torch.float32
    back = to_numpy(params)
    for k, v in flatten(tree).items():
        np.testing.assert_array_equal(flatten(back)[k], v)


def test_save_load_round_trips(tmp_path):
    tree = mlp_tree(np.ones((4, 30), np.float32), hidden=16, seed=3)
    save_params(tree, tmp_path / "p.npz")
    got = to_numpy(load_params(tmp_path / "p.npz"))
    for k, v in flatten(tree).items():
        np.testing.assert_array_equal(flatten(got)[k], v)


def test_data_copies_match_the_reference():
    assert ccfd.FEATURE_NAMES == jax_ccfd.FEATURE_NAMES and ccfd.NUM_FEATURES == 30
    a, b = ccfd.synthetic_dataset(n=500, seed=4), jax_ccfd.synthetic_dataset(n=500, seed=4)
    np.testing.assert_array_equal(a.X, b.X)
    np.testing.assert_array_equal(a.y, b.y)
    s, r = surrogate.kaggle_surrogate(n=3000), jax_surrogate.kaggle_surrogate(n=3000)
    assert surrogate.fingerprint(s) == jax_surrogate.fingerprint(r)


def test_load_csv_matches_the_reference(tmp_path):
    ds = jax_ccfd.synthetic_dataset(n=20, seed=1)
    path = tmp_path / "creditcard.csv"
    path.write_bytes(jax_ccfd.to_csv_bytes(ds))
    got, ref = ccfd.load_csv(str(path)), jax_ccfd.load_csv(str(path))
    np.testing.assert_array_equal(got.X, ref.X)
    np.testing.assert_array_equal(got.y, ref.y)
    np.testing.assert_array_equal(ccfd.load_dataset(str(path)).X, ref.X)
    with pytest.raises(FileNotFoundError):
        ccfd.load_dataset(str(tmp_path / "missing.csv"))


def test_stable_sigmoid_matches_the_reference():
    z = np.linspace(-120, 120, 1001, dtype=np.float32)
    np.testing.assert_array_equal(stable_sigmoid(z), jax_stable_sigmoid(z))


@pytest.mark.parametrize("env", [
    {},
    {"CCFD_MODEL": "mlp", "CCFD_DTYPE": "float32", "CCFD_BATCH_SIZES": "8,64",
     "CCFD_BATCH_DEADLINE_MS": "0.5", "CCFD_BATCH_WORKERS": "2",
     "CCFD_DYNAMIC_BATCHING": "off", "SELDON_TOKEN": "t",
     "CCFD_SERVE_HOST": "127.0.0.1", "CCFD_SERVE_PORT": "9001"},
])
def test_config_parses_like_the_reference(env):
    got, ref = Config.from_env(env), JaxConfig.from_env(env)
    for field in ("model_name", "compute_dtype", "batch_sizes", "batch_deadline_ms",
                  "batch_workers", "dynamic_batching", "seldon_token",
                  "serve_host", "serve_port"):
        assert getattr(got, field) == getattr(ref, field), field
