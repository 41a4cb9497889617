"""The port's bulk replay plane against the reference's.

``ccfd_tpu_torch/replay/service.py``, the overload plane's bulk ceiling,
the audit plane's row capture and the router's stamping seam. The
classification, the verdict tap, the ceiling's admit and shed sequence,
the durable cursor and the commands are held against the reference's on
the same inputs (equal, no tolerance). The window drives run on the port's
own stack on the CPU: a Platform whose router scores through B1's plain
version, recorded with row capture armed and re-driven through the bus
under bulk admission; parity is byte-stable on the score (the reference's
conservation law: zero divergences, drops and ghosts). The CPU's plain
B1 rounds a row by its bucket's matmul shape (1 ulp in p on ~0.2% of rows
between buckets 16 and 1,024), so these drives serve one bucket; on the
card B1 is checked bit-equal across buckets (chip_smoke.py ``rollout`` (b)).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest

from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.replay.service import (
    CAUSE_CHAMPION_HASH,
    ReplayKilled,
    ReplayVerdictTap,
    bundle_window,
    classify_divergence,
)
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)
ROWS = 1_200


def _rec(i: int, proba: float = 0.5, **over) -> dict:
    row = [0.0] * len(FEATURE_NAMES)
    row[0] = proba
    base = {"tx": f"tx-{i}", "uid": f"0:{i}", "seq": i, "ts": 100.0 + i, "proba": proba,
            "rule": "none", "branch": "legit", "tier": "device", "threshold": 0.5,
            "hash": "h1", "row": row}
    base.update(over)
    return base


# -- classification, the bundle bracket, the tap ---------------------------------

PAIRS = [
    ({}, {}), ({}, {"hash": "h2"}), ({}, {"proba": 0.7}),
    ({}, {"proba": 0.7, "hash": "h2"}), ({}, {"proba": 0.7, "tier": "host"}),
    ({}, {"threshold": 0.6}), ({}, {"rule": "fraud"}), ({}, {"branch": "fraud"}),
    ({"hash": None}, {"proba": 0.7, "hash": "h2"}), ({"tier": "rules"}, {"proba": 0.9}),
    ({"threshold": None}, {"threshold": None, "proba": 0.3}),
]


def test_classify_divergence_and_bundle_window_are_the_references():
    from ccfd_tpu.replay.service import bundle_window as ref_bundle
    from ccfd_tpu.replay.service import classify_divergence as ref_classify

    for a, b in PAIRS:
        rec, rep = _rec(0, **a), _rec(0, **b)
        assert classify_divergence(rec, rep) == ref_classify(rec, rep), (a, b)
    for bundle in ({"decisions": [{"seq": 5}, {"seq": 2}, {"x": 1}, {"seq": "9"}]},
                   {"decisions": []}, {}, {"decisions": [{"seq": None}]}):
        assert bundle_window(bundle) == ref_bundle(bundle)


def test_the_verdict_tap_splits_live_from_replay_as_the_references():
    from ccfd_tpu.metrics.prom import Registry as RefRegistry
    from ccfd_tpu.replay.service import ReplayVerdictTap as RefTap
    from ccfd_tpu_torch.metrics.prom import Registry

    class Inner:
        capture_rows = True

        def __init__(self):
            self.got = []

        def record_batch(self, rows, **kw):
            self.got.append(([r["tx"] for r in rows], kw))

    out = {}
    for side, tap_cls, reg in (("port", ReplayVerdictTap, Registry()),
                               ("ref", RefTap, RefRegistry())):
        inner, sunk = Inner(), []
        tap = tap_cls(inner=inner, registry=reg)
        assert tap.capture_rows is True
        rows = [{"tx": "a"}, {"tx": "b", "replay": {"w": "w", "uid": "0:1"}}, {"tx": "c"}]
        tap.record_batch([dict(r) for r in rows], tier="device", threshold=0.5)  # orphaned
        tap.arm(lambda rs, **kw: sunk.append(([r["tx"] for r in rs], kw)))
        tap.record_batch([dict(r) for r in rows], tier="host", cause="quarantine")
        tap.arm(lambda rs, **kw: 1 / 0)  # a failing sink never raises into routing
        tap.record_batch([dict(r) for r in rows])
        out[side] = (inner.got, sunk, [reg.counter("ccfd_replay_verdicts_total").value(
            labels={"fate": f}) for f in ("joined", "orphaned")])
    assert out["port"] == out["ref"]
    assert out["port"][2] == [2, 1]


# -- the overload plane's bulk ceiling ------------------------------------------

class _R:
    def __init__(self, pri: str, i: int):
        self.headers = {"priority": pri}
        self.value = i


@pytest.mark.parametrize("ceiling", [1.0, 0.5, 0.25, 0.0])
def test_the_bulk_ceilings_admit_and_shed_sequence_is_the_references(ceiling):
    from ccfd_tpu.metrics.prom import Registry as RefRegistry
    from ccfd_tpu.runtime import overload as ref_ov
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.runtime import overload as ov

    rng = np.random.default_rng(int(ceiling * 100))
    polls = [[_R(str(rng.choice(["bulk", "normal", "critical", "bulk"])), i)
              for i in range(int(rng.integers(20, 160)))] for _ in range(6)]
    out = {}
    for side, mod, reg in (("port", ov, Registry()), ("ref", ref_ov, RefRegistry())):
        ctl = mod.OverloadControl(reg, mod.AdaptiveInflightBudget(100, registry=reg))
        ctl.set_bulk_ceiling(ceiling)
        seq = []
        for recs in polls:
            keep, shed = ctl.admit(recs)
            seq.append(([r.value for r in keep], shed, ctl.budget.limit))
            ctl.budget.release(len(keep))
        gate = mod.AdmissionGate(mod.AdaptiveInflightBudget(100, registry=reg), reg)
        gate.set_bulk_ceiling(ceiling)
        admits = [gate.try_admit(n, p) for n, p in ((10, 0), (30, 0), (20, 1), (50, 2), (10, 0))]
        out[side] = (seq, admits, ctl.bulk_ceiling, gate.bulk_ceiling, reg.render())
    assert out["port"][:4] == out["ref"][:4]
    for name in ("ccfd_shed_total", "ccfd_admission_total", "ccfd_bulk_ceiling"):
        got = sorted(ln for ln in out["port"][4].splitlines() if ln.startswith(name))
        want = sorted(ln for ln in out["ref"][4].splitlines() if ln.startswith(name))
        assert got == want, name


# -- the durable cursor ------------------------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_side_resumes_the_others_replay_cursor(tmp_path, writer):
    from ccfd_tpu.config import Config as RefConfig
    from ccfd_tpu.replay.service import ReplayService as RefService
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.replay.service import ReplayService

    mk = {"ref": lambda: RefService(RefConfig(), None, None, state_dir=str(tmp_path)),
          "port": lambda: ReplayService(Config(), None, None, state_dir=str(tmp_path))}
    w = mk[writer]()
    doc = {"window_id": "w/1", "total": 12, "next": 8,
           "counts": {"match": 7, "divergence": 1, "drop": 0},
           "causes": {CAUSE_CHAMPION_HASH: 1}, "findings": [{"kind": "divergence"}],
           "last_seq": 41}
    w._commit_cursor("w/1", doc)
    r = mk["port" if writer == "ref" else "ref"]()
    assert r._cursor_path("w/1") == w._cursor_path("w/1")
    assert r._load_cursor("w/1", 12) == doc
    assert r._load_cursor("w/1", 13) is None  # another window under the id


# -- the window on the port's stack --------------------------------------------

def _replay_platform(tmp_path, replay_dir=None):
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    cr = {"spec": {
        "store": {"enabled": False}, "bus": {"partitions": 2},
        "scorer": {"enabled": True, "model": "mlp", "train_steps": 0},
        "engine": {"enabled": True}, "notify": {"enabled": False},
        "router": {"enabled": True}, "retrain": {"enabled": False},
        "producer": {"enabled": False}, "monitoring": {"enabled": False},
        "health": {"enabled": False}, "incident": {"enabled": False},
        "capacity": {"enabled": False}, "analytics": {"enabled": False},
        "investigator": {"enabled": False}, "heal": {"enabled": False},
        "lifecycle": {"enabled": True, "state_dir": str(tmp_path / "lc")},
        "audit": {"dir": str(tmp_path / "audit")},
        "replay": {"enabled": True, "dir": replay_dir or str(tmp_path / "cursor"),
                   "batch": 128, "timeout_s": 10.0},
    }}
    return Platform(PlatformSpec.from_cr(cr, cfg=Config(batch_sizes=(1024,))),
                    device="cpu").up()


def _record(p, n: int = ROWS, seed: int = 5) -> list:
    """Produce ``n`` surrogate transactions and wait until each is routed;
    the window's records, read back off the audit segments."""
    from ccfd_tpu_torch.data.ccfd import Dataset, iter_transactions
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

    ds = kaggle_surrogate(n=n, seed=seed)
    rows = list(iter_transactions(Dataset(X=ds.X, y=ds.y)))
    base = p.broker.end_offsets(p.cfg.kafka_topic)
    recorded = p.audit.counts()["recorded"]
    for i in range(0, n, 200):
        p.broker.produce_batch(p.cfg.kafka_topic, rows[i:i + 200],
                               [r["id"] for r in rows[i:i + 200]])
    assert p.wait_routed(60) and sum(p.broker.end_offsets(p.cfg.kafka_topic)) == sum(base) + n
    # the router counts a batch routed before it records the batch's
    # decisions: wait for the records themselves, then flush them
    deadline = time.monotonic() + 60
    while p.audit.counts()["recorded"] < recorded + n:
        assert time.monotonic() < deadline, "the window's records did not land"
        time.sleep(0.01)
    p.audit.flush()
    return p.audit.scan_window()


def test_a_recorded_window_replays_with_parity_then_classifies_a_promotion(tmp_path):
    from ccfd_tpu_torch.params import to_numpy

    p = _replay_platform(tmp_path)
    try:
        recs = _record(p)
        assert len(recs) == ROWS and all(r.get("row") is not None for r in recs)
        assert {r["version"] for r in recs} == {1}
        rep = p.replay.run_window(window_id="clean")
        assert (rep["total"], rep["match"], rep["divergence"], rep["drop"], rep["ghost"]) == (
            ROWS, ROWS, 0, 0, 0), rep["findings"][:3]
        assert rep["parity"] is True and p.status()["replay"]["last_report"] == rep
        # the replayed verdicts never entered the provenance log
        p.audit.flush()
        assert len(p.audit.scan_window()) == ROWS
        reg = p.registries["replay"]
        assert reg.counter("ccfd_replay_rows_total").value(labels={"outcome": "match"}) == ROWS
        assert reg.counter("ccfd_replay_windows_total").value(labels={"result": "clean"}) == 1
        # the bulk rows were admitted at bulk priority under the ceiling
        router = p.registries["router"]
        assert router.counter("ccfd_admission_total").value(labels={
            "stage": "bus", "priority": "bulk", "decision": "admit"}) >= ROWS
        assert p._overload.bulk_ceiling == 1.0  # restored after the window
        # a promoted champion: every divergence is the champion's hash
        lc = p.lifecycle
        new = to_numpy(p.scorer.params)  # the output layer negated: p -> 1 - p
        new["layers"][-1] = {k: -v for k, v in new["layers"][-1].items()}
        with lc._mu:
            lc.submit_candidate(new)
            lc._promote(lc.evaluator.snapshot())
        assert lc.champion == 2
        rep2 = p.replay.run_window(window_id="after-promote")
        assert rep2["drop"] == rep2["ghost"] == 0
        assert rep2["divergence"] > 0.9 * ROWS
        assert rep2["causes"] == {CAUSE_CHAMPION_HASH: rep2["divergence"]}
    finally:
        p.down()


@pytest.mark.parametrize("event,batch,resumed", [("committed", 2, 384), ("produced", 3, 384)])
def test_a_killed_window_resumes_exactly_once(tmp_path, event, batch, resumed):
    p = _replay_platform(tmp_path)
    try:
        recs = _record(p)

        def kill(ev, bi):
            if ev == event and bi == batch:
                raise ReplayKilled()

        p.replay.crash_hook = kill
        with pytest.raises(ReplayKilled):
            p.replay.run_window(window_id="killed")
        p.replay.crash_hook = None
        if event == "produced":
            time.sleep(1.0)  # the dead worker's batch lands in its join
        rep = p.replay.run_window(window_id="killed")
        assert rep["resumed_at"] == resumed
        assert rep["total"] == rep["match"] == len(recs) == ROWS
        assert rep["parity"] is True and rep["divergence"] == rep["drop"] == 0
    finally:
        p.down()


def test_a_torn_cursor_falls_back_a_generation(tmp_path):
    state = str(tmp_path / "cursor")
    p = _replay_platform(tmp_path, replay_dir=state)
    try:
        _record(p)

        def kill(ev, bi):
            if ev == "committed" and bi == 3:
                raise ReplayKilled()

        p.replay.crash_hook = kill
        with pytest.raises(ReplayKilled):
            p.replay.run_window(window_id="torn")
        p.replay.crash_hook = None
        cur = p.replay._cursor_path("torn")
        gens = sorted((f for f in os.listdir(state)
                       if f.startswith(os.path.basename(cur) + ".g")),
                      key=lambda f: int(f.rsplit(".g", 1)[1]))
        assert len(gens) >= 2
        for victim in (cur, os.path.join(state, gens[-1])):
            with open(victim, "wb") as f:
                f.write(b"CCFDSUM1 torn-mid-write")
        rep = p.replay.run_window(window_id="torn")
        assert rep["resumed_at"] == 3 * 128  # one batch earlier than the kill
        assert rep["match"] == rep["total"] == ROWS and rep["parity"] is True
    finally:
        p.down()


# -- the commands --------------------------------------------------------------------

def test_the_replay_command_summarizes_and_backtests_as_the_references(tmp_path, capsys):
    from ccfd_tpu.cli import main as ref_main
    from ccfd_tpu_torch.cli import main

    p = _replay_platform(tmp_path)
    try:
        recs = _record(p, n=600)
    finally:
        p.down()
    audit = str(tmp_path / "audit")
    docs = []
    for fn in (main, ref_main):
        assert fn(["replay", "--dir", audit]) == 0
        docs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert docs[0] == docs[1] == {"records": 600, "rescorable": 600,
                                  "seq": [recs[0]["seq"], recs[-1]["seq"]],
                                  "tiers": {"device": 600}}
    docs = []
    for fn in (main, ref_main):
        assert fn(["replay", "--dir", audit, "--what-if-threshold", "0.05",
                   "--since-seq", "100", "--until-seq", "399", "--json"]) == 0
        d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        d.pop("elapsed_s"), d.pop("rows_per_s")
        docs.append(d)
    assert docs[0] == docs[1] and docs[0]["total"] == 300
    assert main(["replay"]) == 2


def test_the_replay_command_re_drives_a_window_live(tmp_path, capsys):
    from ccfd_tpu_torch.cli import main

    p = _replay_platform(tmp_path)
    try:
        _record(p, n=400)
    finally:
        p.down()
    os.environ["CCFD_BATCH_SIZES"] = "1024"
    try:
        assert main(["replay", "--dir", str(tmp_path / "audit"), "--live", "--device", "cpu",
                     "--state-dir", str(tmp_path / "live-cursor")]) == 0
    finally:
        del os.environ["CCFD_BATCH_SIZES"]
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["parity"] is True and rep["match"] == rep["total"] == 400
