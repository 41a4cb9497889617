"""The Scorer's dispatch deadline, and the reference's host paths round
the kernel that the port leaves out, against the JAX package on the CPU.

The deadline is off unless the environment sets it (config.py). Set, it
runs on a scripted slow device path: the scorer's dispatch is held past
the deadline, the timeout is counted, the device is marked wedged, and
every ``score`` raises ``ScorerTimeout`` (no host fallback) until the
wedge probe gets through; the REST server answers 503 on either transport,
as the reference does for a model with no host forward, and the router's
ladder counts the batch on its host tier. The host latency tier and the
front's inline model are refused by name when set (test_torch_roles.py);
their auto value is off, so every request dispatches to the device. The
router's dispatch watchdog keeps its own resolution, pinned here.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.serving.dispatch import ScorerTimeout as RefScorerTimeout
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu.serving.server import PredictionServer as RefServer
from ccfd_tpu_torch.cli import build_router, make_scorer
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.params import from_jax_params
from ccfd_tpu_torch.serving.dispatch import ScorerTimeout
from ccfd_tpu_torch.serving.scorer import Scorer
from ccfd_tpu_torch.serving.server import PredictionServer
from tests.torch_helpers import mlp_tree

BUCKETS = (16, 128)


@pytest.fixture(scope="module")
def rows():
    return kaggle_surrogate(n=300, seed=17).X


@pytest.fixture(scope="module")
def tree(rows):
    return mlp_tree(rows, hidden=32, seed=17)


def _post(port, rows, timeout=20):
    body = json.dumps({"data": {"ndarray": np.asarray(rows).tolist()}}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v0.1/predictions", body,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/prometheus", timeout=20) as r:
        text = r.read().decode()
    return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
            if ln and not ln.startswith("#")}


@pytest.mark.parametrize("env", [{}, {"CCFD_DISPATCH_DEADLINE_MS": ""},
                                 {"CCFD_HOST_TIER_ROWS": "0", "CCFD_DISPATCH_DEADLINE_MS": "0",
                                  "CCFD_INLINE_ROWS": "0"},
                                 {"CCFD_HOST_TIER_ROWS": "-1", "CCFD_INLINE_ROWS": "-1"}])
def test_every_policy_is_off_unless_set(tree, rows, env):
    cfg = Config.from_env(env)
    assert cfg.unported() == []  # 0 and the auto value are off, not refused
    assert cfg.scorer_dispatch_deadline_ms(on_card=True) == 0.0
    scorer = make_scorer(cfg, from_jax_params(tree), "cpu")
    assert scorer._dispatcher is None and not scorer.wedged
    d0 = scorer.dispatch_total()
    scorer.score(rows[:5])
    assert scorer.dispatch_total() == d0 + 1 and scorer.dispatch_timeouts == 0


def test_the_config_resolves_the_knobs_as_documented():
    cfg = Config.from_env({"CCFD_DISPATCH_DEADLINE_MS": "-1", "SELDON_TIMEOUT": "750"})
    assert cfg.scorer_dispatch_deadline_ms(on_card=True) == 750.0
    assert cfg.scorer_dispatch_deadline_ms(on_card=False) == 0.0
    cfg = Config.from_env({"CCFD_DISPATCH_DEADLINE_MS": "250"})
    assert cfg.scorer_dispatch_deadline_ms(on_card=False) == 250.0
    assert cfg.unported() == []


@pytest.mark.parametrize("env,on_card,want", [
    ({}, True, 5000.0), ({}, False, 0.0),  # unset: the reference's auto
    ({"CCFD_DISPATCH_DEADLINE_MS": "-1"}, True, 5000.0),
    ({"CCFD_DISPATCH_DEADLINE_MS": "0"}, True, 0.0),
    ({"CCFD_DISPATCH_DEADLINE_MS": "50"}, False, 50.0),
    ({"CCFD_DISPATCH_DEADLINE_MS": "50", "CCFD_OVERLOAD_DISPATCH_DEADLINE_MS": "80"}, True, 80.0),
    ({"SELDON_TIMEOUT": "700"}, True, 700.0),
])
def test_the_router_watchdog_keeps_its_resolution(env, on_card, want):
    assert Config.from_env(env).watchdog_deadline_ms(on_card) == want


@pytest.mark.parametrize("n", [1, 16, 64])
def test_small_requests_dispatch_to_the_device(tree, rows, n):
    """Where the reference's host tier would score them in numpy, the port
    dispatches every request to the (plain) kernel, with the same
    probabilities as the reference's device path."""
    port = make_scorer(Config.from_env({"CCFD_HOST_TIER_ROWS": "-1"}), from_jax_params(tree),
                       "cpu")
    ref = RefScorer(model_name="mlp", params=tree, batch_sizes=BUCKETS, use_fused=True,
                    host_tier_rows=0)
    d0 = port.dispatch_total()
    x = rows[:n]
    np.testing.assert_allclose(port.score(x), ref.score(x), rtol=0, atol=1e-5)
    assert port.dispatch_total() == d0 + 1


class Held:
    """A scripted slow device path: while ``hold`` is set every dispatch of
    the wrapped scorer waits (at most 30 s) for ``release``."""

    def __init__(self):
        self.hold, self.release = threading.Event(), threading.Event()

    def wrap(self, fn):
        def held(*a, **kw):
            if self.hold.is_set():
                self.release.wait(timeout=30.0)
            return fn(*a, **kw)
        return held


def _deadline_pair(tree):
    """The port's Scorer and the reference's, both on a 150 ms deadline and
    held by one ``Held``; the reference's host forward is taken away, so it
    takes its ScorerTimeout branch, which is the port's only one."""
    port = Scorer(params=from_jax_params(tree), batch_sizes=BUCKETS, device="cpu",
                  dispatch_deadline_ms=150.0)
    ref = RefScorer(model_name="mlp", params=tree, batch_sizes=BUCKETS, use_fused=False,
                    host_tier_rows=0, dispatch_deadline_ms=150.0)
    ref.spec = dataclasses.replace(ref.spec, apply_numpy=None)
    with ref._lock:
        ref._host_params = None
    held = Held()
    port._launch = held.wrap(port._launch)
    ref._apply = held.wrap(ref._apply)
    port.warmup()
    ref.warmup()
    return port, ref, held


def test_a_timeout_raises_and_the_wedge_refuses_as_the_reference(tree, rows):
    port, ref, held = _deadline_pair(tree)
    try:
        x = rows[:40]
        d0 = port.dispatch_total()
        port.score(x)  # within the deadline: the device path
        assert port.dispatch_total() == d0 + 1
        assert port.dispatch_timeouts == 0 and not port.wedged
        held.hold.set()
        for s, timeout in ((port, ScorerTimeout), (ref, RefScorerTimeout)):
            t0 = time.perf_counter()
            with pytest.raises(timeout):
                s.score(x)  # the timeout
            with pytest.raises(timeout):
                s.score(rows[:7])  # already wedged: refused, no new dispatch
            assert time.perf_counter() - t0 < 5.0  # bounded by the deadline
        assert port.wedged and ref._wedge.wedged
        assert port.dispatch_timeouts == ref.dispatch_timeouts == 1
    finally:
        held.release.set()


def test_a_wedge_clears_once_the_probe_gets_through(tree, rows):
    port = Scorer(params=from_jax_params(tree), batch_sizes=BUCKETS, device="cpu",
                  dispatch_deadline_ms=100.0)
    held = Held()
    port._launch = held.wrap(port._launch)
    port._wedge._probe_interval_s = 0.05
    held.hold.set()
    try:
        with pytest.raises(ScorerTimeout):
            port.score(rows[:20])
        assert port.wedged
    finally:
        held.hold.clear()
        held.release.set()
    deadline = time.monotonic() + 10
    while port.wedged and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not port.wedged
    d0 = port.dispatch_total()
    port.score(rows[:20])
    assert port.dispatch_total() == d0 + 1  # back on the device path


@pytest.mark.parametrize("native_front", [True, False])
def test_scorer_timeout_answers_503_as_the_reference(tree, rows, native_front):
    port, ref, held = _deadline_pair(tree)
    servers = [PredictionServer(port, Config(native_front=native_front)),
               RefServer(ref, RefConfig(native_front=native_front))]
    ports = [s.start("127.0.0.1", 0) for s in servers]
    held.hold.set()
    try:
        for p in ports:
            for n in (40, 5):  # the timeout, then a refusal while wedged
                t0 = time.perf_counter()
                status, out = _post(p, rows[:n])
                assert time.perf_counter() - t0 < 5.0
                assert status == 503 and "scoring unavailable" in out["error"]
        m = _scrape(ports[0])
        assert m["ccfd_dispatch_timeouts_total"] == 1.0 and m["ccfd_device_wedged"] == 1.0
        assert m['seldon_api_executor_server_requests_total{code="503"}'] == 2.0
    finally:
        held.release.set()
        for s in servers:
            s.stop()


def test_the_router_roles_ladder_takes_a_timed_out_batch(tree, rows, monkeypatch):
    """The router role's local Scorer on a deadline: a timed-out batch falls
    to the ladder's host tier, counted there, and the timeout shows on the
    role's /prometheus."""
    monkeypatch.setattr("ccfd_tpu_torch.cli.served_params",
                        lambda cfg, path=None: from_jax_params(tree))
    cfg = Config.from_env({"KIE_SERVER_URL": "http://127.0.0.1:1", "CCFD_TRACE_SAMPLE": "0",
                           "CCFD_DISPATCH_DEADLINE_MS": "150", "CCFD_OVERLOAD": "0",
                           "CCFD_BATCH_SIZES": "16,128"})
    router, registry, _sink, collectors = build_router(cfg, device="cpu")
    scorer = router.score.__self__
    held = Held()
    scorer._launch = held.wrap(scorer._launch)
    x = rows[:20]
    for c in collectors:
        c()
    assert registry.counter("ccfd_dispatch_timeouts_total").value() == 0
    held.hold.set()
    try:
        proba, fired = router._score_tiered(x, [None] * len(x))
        for c in collectors:
            c()
        assert registry.gauge("ccfd_device_wedged").value() == 1.0
    finally:
        held.release.set()
    np.testing.assert_allclose(proba, scorer.host_score(x), rtol=0, atol=0)
    assert fired is None
    assert registry.counter("ccfd_dispatch_timeouts_total").value() == 1
    assert registry.counter("router_degraded_total").value({"tier": "host"}) == len(x)
