"""The port's ``mlp_q8`` path on the CPU: the Scorer on both wires, the
REST server, ``serve`` and ``quantize``, held against the JAX package.

``Scorer(model_name="mlp_q8", device="cpu")`` runs the plain versions of
kernels B3 (int8 wire, the default) and B2 (``q8_wire="f32"``) through the
bucket/pad path; the answers agree with JAX ``quant.apply`` to 1e-5
(evaluated op by op, see tests/test_torch_quant.py for why).
"""

import http.client
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.cli import _restore_q8_checkpoint
from ccfd_tpu.data.ccfd import synthetic_dataset
from ccfd_tpu.data.surrogate import kaggle_surrogate as jax_kaggle_surrogate
from ccfd_tpu.models import mlp as jax_mlp
from ccfd_tpu.ops import quant as jax_quant
from ccfd_tpu.utils.metrics_math import roc_auc as jax_roc_auc
from ccfd_tpu_torch.cli import build_server, main
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.ops import fused_mlp_q8, quant
from ccfd_tpu_torch.params import flatten, load_params, save_params, to_numpy
from ccfd_tpu_torch.serving.scorer import Scorer
from ccfd_tpu_torch.serving.server import PredictionServer
from tests.torch_helpers import mlp_tree

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data():
    X = synthetic_dataset(n=600, fraud_rate=0.2, seed=9).X
    return X, mlp_tree(X, hidden=64, seed=9)


def _jax_apply(tree_or_qp, x, quantize=True) -> np.ndarray:
    qp = jax_quant.quantize_mlp(tree_or_qp) if quantize else tree_or_qp
    with jax.disable_jit():
        return np.asarray(jax_quant.apply(qp, jnp.asarray(x)))


@pytest.mark.parametrize("wire", ["int8", "f32"])
def test_scorer_matches_jax_quant_apply_on_both_wires(data, wire):
    X, tree = data
    s = Scorer(model_name="mlp_q8", params=quant.quantize_mlp(tree),
               batch_sizes=(64, 256), device="cpu", q8_wire=wire)
    assert s.fused and s.int8_wire == (wire == "int8")
    x = X[:100]  # a full 64 bucket + a padded 64 bucket
    ref = _jax_apply(tree, x)
    got = s.score(x)
    assert got.shape == (100,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.score_pipelined(X[:300], depth=2),
                               _jax_apply(tree, X[:300]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.score(X[:7]), ref[:7], rtol=0, atol=1e-6)


def test_executable_grid_and_no_launches_on_cpu(data):
    X, tree = data
    before = (fused_mlp_q8.launches.value, fused_mlp_q8.launches_preq.value)
    s = Scorer(model_name="mlp_q8", params=quant.quantize_mlp(tree),
               batch_sizes=(16, 128), device="cpu")
    s.score(X[:10])
    s.score(X[:300])  # 128 + 128 + 44
    grid = s.executable_grid()
    assert grid["model"] == "mlp_q8" and grid["fused"] and grid["int8_wire"]
    assert grid["dispatches"] == {"16": 1, "128": 3}
    f32 = Scorer(model_name="mlp_q8", params=quant.quantize_mlp(tree),
                 batch_sizes=(16,), device="cpu", q8_wire="f32")
    assert not f32.executable_grid()["int8_wire"]
    bf16 = Scorer(params=tree, batch_sizes=(16,), device="cpu")
    assert not bf16.executable_grid()["int8_wire"]
    assert (fused_mlp_q8.launches.value, fused_mlp_q8.launches_preq.value) == before


def test_default_params_are_a_quantized_seeded_mlp():
    s = Scorer(model_name="mlp_q8", batch_sizes=(16,), device="cpu", seed=4)
    assert s.params["layers"][0]["wq"].dtype == torch.int8
    assert s.score(np.zeros((3, 30), np.float32)).shape == (3,)


def test_swap_params_refolds_the_quantization_grid(data):
    """A publish must re-pair the host's quantization grid with the new
    kernel weights; params that do not fold raise before the flip."""
    X, tree = data
    s = Scorer(model_name="mlp_q8", params=quant.quantize_mlp(tree),
               batch_sizes=(64,), device="cpu")
    before = s.score(X[:64])
    new = mlp_tree(X, hidden=64, seed=11)
    new["norm"]["mu"] = new["norm"]["mu"] + 3.0  # a different normalizer
    new["norm"]["sigma"] = new["norm"]["sigma"] * 2.0
    s.swap_params(quant.quantize_mlp(new))
    np.testing.assert_allclose(s.score(X[:64]), _jax_apply(new, X[:64]), rtol=0, atol=1e-5)
    for bad in (new, quant.quantize_mlp(mlp_tree(X, hidden=1088))):  # f32 tree; too wide
        with pytest.raises(ValueError):
            s.swap_params(bad)
    np.testing.assert_allclose(s.score(X[:64]), _jax_apply(new, X[:64]), rtol=0, atol=1e-5)
    assert np.abs(s.score(X[:64]) - before).max() > 1e-3


def test_rejects_an_unknown_wire(data):
    with pytest.raises(ValueError, match="q8_wire"):
        Scorer(model_name="mlp_q8", params=quant.quantize_mlp(data[1]),
               device="cpu", q8_wire="bf16")


@pytest.mark.parametrize("env,want", [
    ({}, "int8"), ({"CCFD_Q8_WIRE": "f32"}, "f32"), ({"CCFD_Q8_WIRE": "int8"}, "int8"),
    ({"CCFD_Q8_WIRE": "anything"}, "int8"),
])
def test_config_reads_the_wire_as_the_reference_scorer_does(env, want):
    assert Config.from_env(env).q8_wire == want


def _post(port, payload, path="/api/v0.1/predictions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST" if payload is not None else "GET", path,
                     None if payload is None else json.dumps(payload))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("wire", ["int8", "f32"])
def test_rest_post_to_the_q8_server(wire):
    """The code path of ``CCFD_MODEL=mlp_q8 python -m ccfd_tpu_torch serve
    --device cpu``: the committed checkpoint, quantized, through the REST
    contract; the answer is the reference's checkpoints_q8 model."""
    x = jax_kaggle_surrogate(n=200, seed=3).X
    srv = build_server(Config(model_name="mlp_q8", batch_sizes=(16, 128), q8_wire=wire),
                       device="cpu")
    port = srv.start("127.0.0.1", 0)
    try:
        assert srv.scorer.executable_grid()["int8_wire"] == (wire == "int8")
        status, body = _post(port, {"data": {"ndarray": x[:37].tolist()}})
        assert status == 200
        out = json.loads(body)
        assert out["meta"] == {"model": "mlp_q8"}
        arr = np.asarray(out["data"]["ndarray"])
        assert arr.shape == (37, 2)
        ref_qp = _restore_q8_checkpoint(str(REPO / "checkpoints_q8"))
        np.testing.assert_allclose(arr[:, 1], _jax_apply(ref_qp, x[:37], False),
                                   rtol=0, atol=1e-5)
        status, body = _post(port, None, "/prometheus")
        text = body.decode()
        for kernel in ("fused_mlp_bf16", "fused_mlp_q8", "fused_mlp_q8_preq",
                       "fused_mlp_q8_preq.cluster"):
            assert f'ccfd_kernel_launches{{kernel="{kernel}"}}' in text, kernel
    finally:
        srv.stop()


def test_serve_takes_a_q8_params_file(tmp_path, data):
    X, tree = data
    save_params(quant.quantize_mlp(tree), tmp_path / "q8.npz")
    srv = build_server(Config(model_name="mlp_q8", batch_sizes=(16,)), device="cpu",
                       params_path=str(tmp_path / "q8.npz"))
    got = np.asarray(srv.predict_ndarray([], X[:5].tolist())["data"]["ndarray"])[:, 1]
    np.testing.assert_allclose(got, _jax_apply(tree, X[:5]), rtol=0, atol=1e-5)
    srv.stop()


def test_quantize_end_to_end(tmp_path, monkeypatch, capsys):
    """``python -m ccfd_tpu_torch quantize`` writes the reference's int8
    params and prints the reference's evidence on the same sample."""
    monkeypatch.setenv("CCFD_SURROGATE_ROWS", "3000")
    monkeypatch.delenv("CCFD_CSV", raising=False)
    out = tmp_path / "q8.npz"
    assert main(["quantize", "--out", str(out), "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref_qp = jax.tree.map(np.asarray, _restore_q8_checkpoint(str(REPO / "checkpoints_q8")))
    got = flatten(load_params(out))
    for k, v in flatten(ref_qp).items():
        assert got[k].tobytes() == v.tobytes(), k
    # the reference's evidence, computed as its cmd_quantize does
    ds = jax_kaggle_surrogate(n=3000)
    te = np.random.default_rng(0).permutation(ds.n)[:600]
    f32 = to_numpy(load_params())
    p32 = np.asarray(jax_mlp.apply(f32, ds.X[te]))
    p8 = jax_quant.apply_numpy(ref_qp, ds.X[te])
    assert doc["eval_rows"] == 600
    assert doc["auc_int8"] == round(jax_roc_auc(ds.y[te], p8), 6)
    # the f32 side is the bf16-served mlp graph: port and reference agree
    # to 1e-4 in p (tests/test_torch_mlp.py), so AUC and the delta to 1e-3
    assert abs(doc["auc_f32"] - jax_roc_auc(ds.y[te], p32)) <= 1e-3
    assert abs(doc["max_prob_delta"] - float(np.abs(p8 - p32).max())) <= 1e-3
    assert main(["quantize", "--params", str(out), "--out", str(tmp_path / "again.npz"),
                 "--device", "cpu"]) == 2


def test_quantize_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["quantize", "--out", str(tmp_path / "q8.npz")])
    assert not (tmp_path / "q8.npz").exists()


def test_unquantized_server_reports_all_kernel_gauges(data):
    X, tree = data
    srv = PredictionServer(Scorer(params=tree, batch_sizes=(16,), device="cpu"),
                           Config(dynamic_batching=False))
    port = srv.start("127.0.0.1", 0)
    try:
        _post(port, {"data": {"ndarray": X[:2].tolist()}})
        text = _post(port, None, "/prometheus")[1].decode()
        gauges = {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
                  if ln.startswith("ccfd_kernel_launches{")}
        assert sorted(gauges) == sorted(
            f'ccfd_kernel_launches{{kernel="{k}"}}'
            for k in ("fused_mlp_bf16", "fused_mlp_q8", "fused_mlp_q8_preq",
                      "fused_mlp_q8_preq.cluster", "fused_mlp_bf16.cluster"))
    finally:
        srv.stop()
