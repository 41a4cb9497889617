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
``finally``. Traced (the server's ``tracer``), each take is one
``serve.take`` trace on the C++ front's clock, the Scorer's steps among
its children, while the same Scorer called by anyone else (the router)
records none; untraced, no span is made. An idle traced front keeps no
trace in a tail-sampling sink.
"""

import json
import socket
import threading
import time
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
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.observability import trace
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


class _TakeLog:
    """The native library with each take's C++ request ids and enqueue
    stamps (CLOCK_MONOTONIC ms) logged."""

    def __init__(self, lib):
        self._lib = lib
        self.takes: list[tuple[list[int], list[float]]] = []

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def ccfd_front_take(self, h, rows, max_rows, meta, enq, max_reqs, timeout_ms):
        n = self._lib.ccfd_front_take(h, rows, max_rows, meta, enq, max_reqs, timeout_ms)
        if n > 0:
            self.takes.append(([meta[3 * i] for i in range(n)], [enq[i] for i in range(n)]))
        return n


def _post_concurrently(port, rows, clients=6, each=5):
    """``clients`` threads posting ``each`` requests of 1-16 rows; returns
    the rows posted."""
    errs, posted = [], []

    def worker(i):
        try:
            for j in range(each):
                n = 1 + (i * each + j) % 16
                x = rows[(i * 40 + j) % 300:(i * 40 + j) % 300 + n]
                status, _ = _call(port, "POST", "/api/v0.1/predictions",
                                  {"data": {"ndarray": x.tolist()}})
                assert status == 200
                posted.append(len(x))
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(repr(e))

    ths = [threading.Thread(target=worker, args=(i,)) for i in range(clients)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ths) and not errs, errs[:3]
    return sum(posted)


TAKE_CHILDREN = {"front.queue", "scorer.prep", "scorer.launch", "scorer.wait",
                 "scorer.readback", "front.respond"}


def test_each_take_of_a_traced_serve_is_one_trace_on_the_fronts_clock(tree, rows, monkeypatch):
    log = _TakeLog(native.lib())
    monkeypatch.setattr(native, "lib", lambda: log)
    scorer = Scorer(params=from_jax_params(tree), batch_sizes=BUCKETS, device="cpu")
    rec = trace.SpanRecorder()
    srv = PredictionServer(scorer, Config(batch_workers=2),
                           tracer=trace.Tracer(Registry(), "seldon", sink=rec))
    cpu0 = time.process_time_ns()
    port = srv.start("127.0.0.1", 0)
    try:
        posted = _post_concurrently(port, rows)
        text = _call(port, "GET", "/prometheus")[1].decode()
    finally:
        srv.stop()
    cpu1 = time.process_time_ns()
    spans = rec.spans()
    # the same Scorer called as the router calls it records nothing
    scorer.score(rows[:16])
    assert len(rec.spans()) == len(spans)
    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    roots = [s for s in spans if s["name"] == "serve.take"]
    assert len(roots) == len(log.takes) > 0
    assert sum(r["attrs"]["rows"] for r in roots) == posted
    by_ids = {tuple(r["attrs"]["ids"]): r for r in roots}
    launched, steps_cpu_us = 0, []
    for ids, enq in log.takes:
        root = by_ids[tuple(ids)]
        assert root["parent_id"] is None and root["attrs"]["requests"] == len(ids)
        children = [s for s in by_trace[root["trace_id"]] if s is not root]
        assert {c["name"] for c in children} == TAKE_CHILDREN and len(children) == 6
        assert all(c["parent_id"] == root["span_id"] for c in children)
        named = {c["name"]: c for c in children}
        assert named["scorer.prep"]["attrs"]["rows"] == root["attrs"]["rows"]
        # each Scorer step carries its thread's CPU time
        steps_cpu_us += [named[n]["attrs"]["cpu_us"] for n in
                         ("scorer.prep", "scorer.launch", "scorer.wait", "scorer.readback")]
        assert named["scorer.launch"]["attrs"]["bucket"] == scorer.bucket(root["attrs"]["rows"])
        launched += named["scorer.launch"]["attrs"]["bucket"]
        queue = named["front.queue"]
        for stamp_ms in enq:
            assert queue["start_ns"] <= int(stamp_ms * 1e6) <= queue["end_ns"]
        assert queue["start_ns"] == root["start_ns"] and queue["attrs"]["wait_ms"] >= 0
        # the take's steps in order, inside the take
        order = [named[n] for n in ("front.queue", "scorer.prep", "scorer.launch",
                                    "scorer.wait", "scorer.readback", "front.respond")]
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(order, order[1:]))
        assert order[-1]["end_ns"] == root["end_ns"]
    # the steps' CPU time is part of the process's (a thread CPU clock may
    # step by a scheduler tick, so one step may read more than its wall)
    assert min(steps_cpu_us) >= 0 and sum(steps_cpu_us) * 1e3 <= cpu1 - cpu0
    # a taker with nothing to take has no parent
    assert all(s["parent_id"] is None for s in spans if s["name"] == "front.take_wait")
    assert f'ccfd_scorer_rows{{rows="handed"}} {float(posted)}' in text
    assert f'ccfd_scorer_rows{{rows="launched"}} {float(launched)}' in text


def test_without_a_tracer_no_span_is_made(port_scorer, rows, monkeypatch):
    made = []
    init = trace.Span.__init__

    def counted(self, *a, **kw):
        made.append(1)
        init(self, *a, **kw)

    monkeypatch.setattr(trace.Span, "__init__", counted)
    srv = PredictionServer(port_scorer, Config(batch_workers=2))
    assert srv.tracer is None
    port = srv.start("127.0.0.1", 0)
    try:
        assert _post_concurrently(port, rows, clients=3, each=3) > 0
    finally:
        srv.stop()
    assert made == []


def test_an_idle_traced_front_keeps_no_trace_in_a_tail_sampling_sink(port_scorer):
    """The operator's sink keeps any span over ``slow_s`` as a slow trace:
    a taker's 200 ms take timeouts reach it as no span at all."""
    sink = trace.SpanSink(sample=0.0, slow_s=0.05, registry=Registry())
    srv = PredictionServer(port_scorer, Config(batch_workers=2),
                           tracer=trace.Tracer(Registry(), "seldon", sink=sink))
    port = srv.start("127.0.0.1", 0)
    try:
        time.sleep(0.7)  # each taker times out three times
        assert _call(port, "GET", "/health/status")[0] == 200
    finally:
        srv.stop()
    sink.flush(0.0)
    assert sink.traces() == []
