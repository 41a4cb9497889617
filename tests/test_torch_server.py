"""The port's Seldon REST server on the CPU, on an ephemeral port.

Answers are held against the JAX Scorer on its fused path (the Pallas
kernel in interpret mode) at 1e-5: the REST layer adds nothing to the
numbers but the JSON round trip of float32 values.
"""

import http.client
import json

import numpy as np
import pytest
import torch

from ccfd_tpu.serving.scorer import Scorer as JaxScorer
from ccfd_tpu_torch.cli import build_parser, build_server
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.params import from_jax_params
from ccfd_tpu_torch.serving.scorer import Scorer
from ccfd_tpu_torch.serving.server import PredictionServer
from tests.torch_helpers import mlp_tree


@pytest.fixture(scope="module")
def rows():
    return kaggle_surrogate(n=400, seed=11).X


@pytest.fixture(scope="module")
def tree(rows):
    return mlp_tree(rows, hidden=64, seed=11)


@pytest.fixture(scope="module")
def server(tree):
    scorer = Scorer(params=from_jax_params(tree), batch_sizes=(16, 128), device="cpu")
    srv = PredictionServer(scorer, Config())
    port = srv.start("127.0.0.1", 0)
    yield srv, port
    srv.stop()


def _request(port, method, path, payload=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        body = None if payload is None else (
            payload if isinstance(payload, bytes) else json.dumps(payload))
        conn.request(method, path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_predictions_contract_and_parity_with_jax_scorer(server, rows, tree):
    _srv, port = server
    x = rows[:37]
    status, body = _request(port, "POST", "/api/v0.1/predictions",
                            {"data": {"names": list(FEATURE_NAMES), "ndarray": x.tolist()}})
    assert status == 200
    out = json.loads(body)
    assert out["data"]["names"] == ["proba_0", "proba_1"]
    assert out["meta"] == {"model": "mlp"}
    arr = np.asarray(out["data"]["ndarray"])
    assert arr.shape == (37, 2)
    np.testing.assert_allclose(arr.sum(1), 1.0, atol=1e-12)
    ref = JaxScorer(model_name="mlp", params=tree, batch_sizes=(16, 128),
                    use_fused=True, host_tier_rows=0).score(x)
    np.testing.assert_allclose(arr[:, 1], ref, rtol=0, atol=1e-5)


def test_predict_alias_and_names_remap(server, rows):
    _srv, port = server
    x = rows[:5]
    _, canon = _request(port, "POST", "/predict", {"data": {"ndarray": x.tolist()}})
    order = list(reversed(FEATURE_NAMES))
    remapped = x[:, ::-1].tolist()
    status, body = _request(port, "POST", "/api/v0.1/predictions",
                            {"data": {"names": order, "ndarray": remapped}})
    assert status == 200
    np.testing.assert_array_equal(json.loads(body)["data"]["ndarray"],
                                  json.loads(canon)["data"]["ndarray"])


def test_errors(server):
    _srv, port = server
    assert _request(port, "POST", "/api/v0.1/predictions", b"{nope")[0] == 400
    assert _request(port, "POST", "/api/v0.1/predictions", {"data": {}})[0] == 400
    assert _request(port, "POST", "/api/v0.1/predictions",
                    {"data": {"ndarray": [["a", "b"]]}})[0] == 400
    assert _request(port, "POST", "/elsewhere", {"data": {"ndarray": []}})[0] == 404
    assert _request(port, "GET", "/nothing")[0] == 404
    assert _request(port, "PUT", "/predict", {})[0] == 405


def test_health_and_prometheus(server, rows):
    srv, port = server
    x = rows[:3]
    _request(port, "POST", "/api/v0.1/predictions", {"data": {"ndarray": x.tolist()}})
    status, body = _request(port, "GET", "/health/status")
    assert status == 200 and json.loads(body)["status"] == "ok"
    status, body = _request(port, "GET", "/prometheus")
    text = body.decode()
    assert status == 200
    for series in (
        'seldon_api_executor_client_requests_seconds_count{endpoint="/api/v0.1/predictions"}',
        'seldon_api_executor_client_requests_seconds_bucket{endpoint="/api/v0.1/predictions",le="+Inf"}',
        'seldon_api_executor_server_requests_total{code="200"}',
        'ccfd_kernel_launches{kernel="fused_mlp_bf16"}',
        "serving_batcher_dispatches_total",
    ):
        assert series in text, series
    gauges = {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
              if ln and not ln.startswith("#")}
    assert gauges["Amount"] == pytest.approx(float(x[-1, FEATURE_NAMES.index("Amount")]))
    assert gauges["V17"] == pytest.approx(float(x[-1, FEATURE_NAMES.index("V17")]))
    assert gauges["V10"] == pytest.approx(float(x[-1, FEATURE_NAMES.index("V10")]))
    assert 0.0 <= gauges["proba_1"] <= 1.0


def test_scoring_faults_answer_500_not_400(tree, rows):
    class BrokenScorer(Scorer):
        def score(self, x):
            raise ValueError("kernel weight w1: want bfloat16 (use pack_for_kernel)")

    scorer = BrokenScorer(params=tree, batch_sizes=(16,), device="cpu")
    for batching in (False, True):
        srv = PredictionServer(scorer, Config(dynamic_batching=batching))
        port = srv.start("127.0.0.1", 0)
        try:
            payload = {"data": {"ndarray": rows[:2].tolist()}}
            assert _request(port, "POST", "/api/v0.1/predictions", payload)[0] == 500
            assert _request(port, "POST", "/api/v0.1/predictions",
                            {"data": {"ndarray": [["a", "b"]]}})[0] == 400
        finally:
            srv.stop()


def test_token_auth(tree, rows):
    scorer = Scorer(params=tree, batch_sizes=(16,), device="cpu")
    srv = PredictionServer(scorer, Config(seldon_token="sekrit", dynamic_batching=False))
    port = srv.start("127.0.0.1", 0)
    try:
        payload = {"data": {"ndarray": rows[:2].tolist()}}
        assert _request(port, "POST", "/api/v0.1/predictions", payload)[0] == 401
        assert _request(port, "POST", "/api/v0.1/predictions", payload,
                        {"Authorization": "Bearer wrong"})[0] == 401
        assert _request(port, "POST", "/api/v0.1/predictions", payload,
                        {"Authorization": "Bearer sekrit"})[0] == 200
    finally:
        srv.stop()


def test_restart_after_stop_serves_again(tree, rows):
    srv = PredictionServer(Scorer(params=tree, batch_sizes=(16,), device="cpu"))
    srv.start("127.0.0.1", 0)
    srv.stop()
    port = srv.start("127.0.0.1", 0)
    try:
        assert _request(port, "POST", "/predict",
                        {"data": {"ndarray": rows[:2].tolist()}})[0] == 200
    finally:
        srv.stop()


def test_serve_builds_from_the_committed_checkpoint_on_cpu(rows):
    srv = build_server(Config(batch_sizes=(16,)), device="cpu")
    assert srv.scorer.fused and str(srv.scorer.device) == "cpu"
    p = srv.predict_ndarray([], rows[:4].tolist())["data"]["ndarray"]
    assert len(p) == 4
    srv.stop()


def test_serve_defaults_to_the_card(rows):
    args = build_parser().parse_args(["serve"])
    assert args.device is None and args.params is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_server(Config(batch_sizes=(16,)), device=args.device)
