"""The port's native REST front (native/httpfront.cpp driven by
serving/native_front.py) against the JAX package's ``PredictionServer`` on
its own native front, on loopback, on the CPU with the real g++ build.

Status codes and bodies must match for the canonical payload, a ``names``
payload, malformed JSON, a missing matrix, bearer-token auth and
/prometheus; probabilities agree to 1e-5 (the port's plain B1 against the
reference's Pallas kernel in interpret mode). The reference's front scores
small requests inline on the CPU, so its inline cap is set explicitly
(CCFD_INLINE_ROWS=0) wherever the two are compared. The port's front has
no inline model: every canonical request, however small, reaches the
Scorer. Every client call has a timeout and every server stops in a
``finally``.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu.serving.server import PredictionServer as RefServer
from ccfd_tpu_torch import native
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.ops import quant
from ccfd_tpu_torch.params import from_jax_params
from ccfd_tpu_torch.serving.native_front import NativeFront
from ccfd_tpu_torch.serving.scorer import Scorer
from ccfd_tpu_torch.serving.server import PredictionServer
from ccfd_tpu_torch.utils.fasthttp import FastHTTPServer
from tests.torch_helpers import mlp_tree

BUCKETS = (16, 128)


@pytest.fixture(scope="module")
def rows():
    return kaggle_surrogate(n=400, seed=13).X


@pytest.fixture(scope="module")
def tree(rows):
    return mlp_tree(rows, hidden=64, seed=13)


@pytest.fixture(scope="module")
def port_scorer(tree):
    return Scorer(params=from_jax_params(tree), batch_sizes=BUCKETS, device="cpu")


@pytest.fixture(scope="module")
def ref_scorer(tree):
    s = RefScorer(model_name="mlp", params=tree, batch_sizes=BUCKETS, use_fused=True,
                  host_tier_rows=0)
    s.warmup()
    return s


def _call(port, method, path, payload=None, token=None, raw=None):
    hdr = {"Content-Type": "application/json"}
    if token:
        hdr["Authorization"] = f"Bearer {token}"
    body = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", body, hdr, method=method)
    try:
        with urllib.request.urlopen(req, timeout=20) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class Both:
    """A port server and a reference server, started on ephemeral ports."""

    def __init__(self, port_scorer, ref_scorer, token=""):
        self.port = PredictionServer(port_scorer, Config(seldon_token=token))
        self.ref = RefServer(ref_scorer, RefConfig(native_front=True, seldon_token=token))
        self.ports = []

    def __enter__(self):
        self.ports = [self.port.start("127.0.0.1", 0), self.ref.start("127.0.0.1", 0)]
        assert isinstance(self.port._httpd, NativeFront)
        assert type(self.ref._httpd).__name__ == "NativeFront"
        return self

    def __exit__(self, *exc):
        self.port.stop()
        self.ref.stop()

    def call(self, *args, **kw):
        return [_call(p, *args, **kw) for p in self.ports]


@pytest.fixture
def no_ref_inline(monkeypatch):
    monkeypatch.setenv("CCFD_INLINE_ROWS", "0")


def _proba(body):
    out = json.loads(body)
    assert out["data"]["names"] == ["proba_0", "proba_1"]
    arr = np.asarray(out["data"]["ndarray"], np.float64)
    np.testing.assert_allclose(arr.sum(1), 1.0, atol=1e-9)
    return arr[:, 1], out["meta"]


@pytest.mark.parametrize("n,path", [(1, "/api/v0.1/predictions"), (16, "/predict"),
                                    (37, "/api/v0.1/predictions"), (300, "/predict")])
def test_canonical_payload_matches_the_reference(port_scorer, ref_scorer, rows, no_ref_inline,
                                                 n, path):
    x = rows[:n]
    with Both(port_scorer, ref_scorer) as both:
        (s1, b1), (s2, b2) = both.call("POST", path, {"data": {"ndarray": x.tolist()}})
    assert s1 == s2 == 200
    (p1, m1), (p2, m2) = _proba(b1), _proba(b2)
    assert m1 == m2 == {"model": "mlp"} and p1.shape == (n,)
    np.testing.assert_allclose(p1, p2, rtol=0, atol=1e-5)


def test_misc_routes_match_the_reference(port_scorer, ref_scorer, rows, no_ref_inline):
    x = rows[:5]
    order = list(reversed(FEATURE_NAMES))
    cases = [
        ({"data": {"names": order, "ndarray": x[:, ::-1].tolist()}}, None),  # names remap
        ({"data": {"ndarray": [x[0].tolist()[:2], x[1].tolist()]}}, None),  # ragged rows
        (None, b"{not json"),
        ({"data": {}}, None),
    ]
    with Both(port_scorer, ref_scorer) as both:
        for payload, raw in cases:
            (s1, b1), (s2, b2) = both.call("POST", "/predict", payload, raw=raw)
            assert s1 == s2, (payload, raw, b1, b2)
            if s1 == 200:
                np.testing.assert_allclose(_proba(b1)[0], _proba(b2)[0], rtol=0, atol=1e-5)
            else:
                assert s1 == 400 and json.loads(b1) == json.loads(b2)
        (s1, _), (s2, _) = both.call("POST", "/api/v9/bogus", {})
        assert s1 == s2 == 404
        (s1, b1), (s2, b2) = both.call("GET", "/health/status")
        assert s1 == s2 == 200 and json.loads(b1) == json.loads(b2)


def test_bearer_token_and_prometheus_match_the_reference(port_scorer, ref_scorer, rows,
                                                         no_ref_inline):
    body = {"data": {"ndarray": rows[:4].tolist()}}
    with Both(port_scorer, ref_scorer, token="tk") as both:
        assert [s for s, _ in both.call("POST", "/predict", body)] == [401, 401]
        got = both.call("POST", "/predict", body, token="tk")
        assert [s for s, _ in got] == [200, 200]
        np.testing.assert_allclose(_proba(got[0][1])[0], _proba(got[1][1])[0], atol=1e-5)
        named = {"data": {"names": ["Amount"], "ndarray": [[5.0]]}}
        assert [s for s, _ in both.call("POST", "/predict", named, token="tk")] == [200, 200]
        scrapes = [b.decode() for s, b in both.call("GET", "/prometheus")]
    for text in scrapes:
        for series in ('seldon_api_executor_server_requests_total{code="401"} 1.0',
                       'seldon_api_executor_server_requests_total{code="200"}',
                       'seldon_api_executor_client_requests_seconds_count{endpoint="/predict"}',
                       "proba_1 "):
            assert series in text, series
    port_text = scrapes[0]
    for series in ("ccfd_dispatch_timeouts_total 0.0", "ccfd_device_wedged 0.0",
                   'ccfd_kernel_launches{kernel="fused_mlp_bf16"}'):
        assert series in port_text, series


def test_the_default_transport_is_the_native_front_and_0_selects_python(port_scorer, rows):
    assert Config.from_env({}).native_front and not Config.from_env(
        {"CCFD_NATIVE_FRONT": "0"}).native_front
    srv = PredictionServer(port_scorer, Config.from_env({"CCFD_NATIVE_FRONT": "0"}))
    port = srv.start("127.0.0.1", 0)
    try:
        assert isinstance(srv._httpd, FastHTTPServer) and srv.transport == "python"
        status, body = _call(port, "POST", "/predict", {"data": {"ndarray": rows[:2].tolist()}})
        assert status == 200 and _proba(body)[0].shape == (2,)
    finally:
        srv.stop()


def test_a_front_that_cannot_bind_or_build_raises(port_scorer, monkeypatch):
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen(1)
        srv = PredictionServer(port_scorer, Config())
        with pytest.raises(OSError, match="failed to bind"):
            srv.start("127.0.0.1", busy.getsockname()[1])
        srv.stop()

    def no_build():
        raise RuntimeError("native build failed: g++ exited 1")

    monkeypatch.setattr(native, "lib", no_build)
    srv = PredictionServer(port_scorer, Config())
    with pytest.raises(RuntimeError, match="native build failed"):
        srv.start("127.0.0.1", 0)
    assert srv._httpd is None
    srv.stop()


@pytest.mark.parametrize("model", ["mlp", "mlp_q8"])
def test_every_canonical_request_reaches_the_scorer(tree, rows, model):
    """However small, each POST is one Scorer.score of its rows (where the
    reference's front would score it inline on the host), with the
    Scorer's own probabilities."""
    params = from_jax_params(tree)
    if model == "mlp_q8":
        params = quant.quantize_mlp(params)
    scorer = Scorer(model_name=model, params=params, batch_sizes=BUCKETS, device="cpu")
    srv = PredictionServer(scorer, Config(dynamic_batching=False, batch_workers=1))
    port = srv.start("127.0.0.1", 0)
    try:
        d0 = scorer.dispatch_total()
        posted = 0
        for n in (1, 16, 64):
            x = rows[posted:posted + n]
            status, body = _call(port, "POST", "/predict", {"data": {"ndarray": x.tolist()}})
            assert status == 200
            np.testing.assert_allclose(_proba(body)[0], scorer.score(x), rtol=0, atol=0)
            posted += n
        assert scorer.dispatch_total() == d0 + 6  # three POSTs, three checks
        text = _call(port, "GET", "/prometheus")[1].decode()
        assert 'ccfd_front_requests_total{queue="predict"} 3.0' in text
    finally:
        srv.stop()


def test_concurrent_clients_through_the_takers(port_scorer, rows):
    srv = PredictionServer(port_scorer, Config())
    port = srv.start("127.0.0.1", 0)
    errs = []

    def worker(i):
        try:
            for j in range(10):
                x = rows[(i * 10 + j) % 300:(i * 10 + j) % 300 + 4]
                status, body = _call(port, "POST", "/api/v0.1/predictions",
                                     {"data": {"ndarray": x.tolist()}})
                assert status == 200
                np.testing.assert_allclose(_proba(body)[0], port_scorer.score(x), atol=1e-6)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(repr(e))

    try:
        d0 = port_scorer.dispatch_total()
        ths = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not errs, errs[:3]
        text = _call(port, "GET", "/prometheus")[1].decode()
        m = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
             if ln and not ln.startswith("#")}
        assert m["serving_batcher_rows_total"] == 6 * 10 * 4
        # every POST decoded in C++; the misc queue held the scrape alone
        assert m['ccfd_front_requests_total{queue="predict"}'] == 60
        assert m['ccfd_front_requests_total{queue="misc"}'] == 1
        # each taken block one Scorer.score: the checks' own calls come on top
        assert 0 < m["serving_batcher_dispatches_total"] <= port_scorer.dispatch_total() - d0
    finally:
        srv.stop()
