"""The REST batcher's overload policies (serving/batcher.py) against the
reference's: scripted arrivals on a scripted clock give the same shed set,
the same shed order, the same exceptions (at submit and on the futures),
the same dispatched batches and the same counters.

Each scenario parks the one batcher worker inside a dispatch, queues the
script's requests (rows, priority) at the script's clock readings, moves
the clock to the release time and lets the worker go: it takes the queue,
drops the stale front under CoDel and dispatches the rest. ``time.
perf_counter`` is the scripted clock for both batchers; ``deadline_ms=0``
keeps the worker from waiting for company. Request i's rows carry i, and
the score function returns column 0, so every answer names its request.

Also: the server's wiring (the two knobs, the shed counter labelled by
priority and ``stage="batcher"``, the ``x-ccfd-priority`` header reaching
the batcher, a shed request answering 429).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from ccfd_tpu.serving import batcher as ref_batcher_mod
from ccfd_tpu_torch.serving import batcher as port_batcher_mod
from tests import torch_helpers  # noqa: F401  (one intra-op thread)

BULK, NORMAL, CRITICAL = 0, 1, 2

# (name, max_queue_rows, codel target ms, [(rows, priority, t_ms)], release ms)
SCENARIOS = [
    ("bound_evicts_lower_front_first", 64, 0.0,
     [(16, BULK, 0), (16, NORMAL, 1), (16, BULK, 2), (16, CRITICAL, 3),
      (16, CRITICAL, 4), (32, NORMAL, 5), (8, BULK, 6), (48, CRITICAL, 7)], 8),
    ("bound_refuses_the_cheapest_arrival", 32, 0.0,
     [(16, CRITICAL, 0), (16, NORMAL, 1), (8, NORMAL, 2), (8, BULK, 3),
      (24, CRITICAL, 4)], 5),
    ("lone_oversize_admits_into_an_empty_queue", 16, 0.0,
     [(40, BULK, 0), (8, BULK, 1), (8, CRITICAL, 2)], 3),
    ("codel_drops_by_class_target", 0, 10.0,
     [(16, BULK, 0), (16, NORMAL, 0), (16, CRITICAL, 0), (16, BULK, 15),
      (16, NORMAL, 12), (16, CRITICAL, 22), (16, BULK, 31)], 35),
    ("codel_fresh_head_keeps_everything", 0, 10.0,
     [(16, BULK, 30), (16, NORMAL, 31), (16, CRITICAL, 32)], 35),
    ("codel_and_bound_together", 48, 5.0,
     [(16, BULK, 0), (16, NORMAL, 1), (16, BULK, 2), (16, CRITICAL, 8),
      (16, NORMAL, 9), (16, BULK, 11), (32, CRITICAL, 12)], 14),
]


class Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _drive(mod, monkeypatch, max_queue_rows, codel_ms, script, release_ms) -> dict:
    from ccfd_tpu_torch.runtime.overload import DeadlinePolicy

    clock = Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    entered, gate = threading.Event(), threading.Event()
    dispatched: list[list[int]] = []
    sheds: list[tuple[int, int]] = []

    def score(x: np.ndarray) -> np.ndarray:
        if not entered.is_set():
            entered.set()
            gate.wait(10)
        dispatched.append(sorted({int(v) for v in x[:, 0]}))
        return x[:, 0].astype(np.float32)

    codel = DeadlinePolicy(codel_ms / 1e3) if codel_ms > 0 else None
    b = mod.DynamicBatcher(score, max_batch=1024, deadline_ms=0.0, workers=1,
                           codel=codel, max_queue_rows=max_queue_rows,
                           on_shed=lambda rows, pri: sheds.append((rows, pri)))
    try:
        parked = b.submit(np.full((1, 30), -1.0, np.float32), priority=CRITICAL)
        assert entered.wait(10)
        at_submit, futures = {}, {}
        for i, (rows, pri, t_ms) in enumerate(script):
            clock.t = 1000.0 + t_ms / 1e3
            try:
                futures[i] = b.submit(np.full((rows, 30), float(i), np.float32),
                                      priority=pri)
            except Exception as e:  # noqa: BLE001 - the shed is the result
                at_submit[i] = (type(e).__name__, str(e))
        clock.t = 1000.0 + release_ms / 1e3
        gate.set()
        parked.result(10)
        outcomes = {}
        for i, f in futures.items():
            try:
                got = f.result(10)
                assert set(np.asarray(got).tolist()) == {float(i)}
                outcomes[i] = "answered"
            except Exception as e:  # noqa: BLE001
                outcomes[i] = (type(e).__name__, str(e))
        deadline = time.monotonic() + 10
        while b.qsize() and time.monotonic() < deadline:
            pass
    finally:
        gate.set()
        b.stop()
    return {"at_submit": at_submit, "outcomes": outcomes, "sheds": sheds,
            "dispatched": dispatched[1:], "shed_rows": b.shed_rows,
            "dispatches": b.dispatches, "rows": b.rows}


@pytest.mark.parametrize("name,max_rows,codel_ms,script,release", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_scripted_overload_matches_the_reference(monkeypatch, name, max_rows, codel_ms,
                                                 script, release):
    ref = _drive(ref_batcher_mod, monkeypatch, max_rows, codel_ms, script, release)
    port = _drive(port_batcher_mod, monkeypatch, max_rows, codel_ms, script, release)
    assert port == ref
    shed = len(ref["at_submit"]) + sum(o != "answered" for o in ref["outcomes"].values())
    assert shed > 0 or name == "codel_fresh_head_keeps_everything"


def test_overload_shed_is_the_ports_and_carries_retry_after():
    from ccfd_tpu.runtime.overload import OverloadShed as RefShed
    from ccfd_tpu_torch.runtime.overload import OverloadShed

    e, r = OverloadShed("x"), RefShed("x")
    assert isinstance(e, RuntimeError) and e.retry_after_s == r.retry_after_s == 0.1
    assert OverloadShed("y", retry_after_s=2).retry_after_s == 2.0


def _server(env: dict):
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.serving.scorer import Scorer
    from ccfd_tpu_torch.serving.server import PredictionServer
    from tests.torch_helpers import mlp_tree

    X = np.random.default_rng(0).normal(size=(256, 30)).astype(np.float32)
    scorer = Scorer("mlp", params=mlp_tree(X), batch_sizes=(16, 128), device="cpu")
    return PredictionServer(scorer, Config.from_env({"CCFD_NATIVE_FRONT": "0", **env})), X


def test_server_wires_the_knobs_and_labels_the_sheds():
    srv, X = _server({"CCFD_OVERLOAD_SERVE_CODEL_TARGET_MS": "3",
                      "CCFD_OVERLOAD_REST_QUEUE_ROWS": "4096"})
    try:
        b = srv.batcher
        assert b._codel.target_s == pytest.approx(0.003) and b._max_queue_rows == 4096
        b._on_shed(16, BULK)
        b._on_shed(4, CRITICAL)
        c = srv.registry.counter("ccfd_shed_total")
        assert c.value({"priority": "bulk", "stage": "batcher"}) == 16
        assert c.value({"priority": "critical", "stage": "batcher"}) == 4
    finally:
        srv.stop()
    off, _ = _server({})
    try:
        assert off.batcher._codel is None and off.batcher._max_queue_rows == 0
    finally:
        off.stop()


def test_header_priority_reaches_the_batcher_and_a_shed_answers_429(monkeypatch):
    import json

    from ccfd_tpu_torch.runtime.overload import OverloadShed

    srv, X = _server({"CCFD_OVERLOAD_REST_QUEUE_ROWS": "64"})
    seen = []

    def score(x, priority=1):
        seen.append(priority)
        if priority == BULK:
            raise OverloadShed("serving batcher queue full", retry_after_s=0.5)
        return srv.scorer.score(x)

    monkeypatch.setattr(srv.batcher, "score", score)
    body = json.dumps({"data": {"ndarray": X[:4].tolist()}}).encode()
    try:
        for header, code in ((b"critical", 200), (b"bulk", 429), (None, 200)):
            headers = {b"x-ccfd-priority": header} if header else {}
            out = srv._http_handler("POST", "/api/v0.1/predictions", headers, body)
            assert out[0] == code
            if code == 429:
                assert out[3] == {"Retry-After": "1"}
                assert json.loads(out[2])["retry_after_s"] == 0.5
    finally:
        srv.stop()
    assert seen == [CRITICAL, BULK, NORMAL]
