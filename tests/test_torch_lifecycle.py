"""The port's model lifecycle against the reference's.

``ccfd_tpu_torch/lifecycle/`` (versions, shadow, evaluator, controller),
the Scorer's challenger slot, ``params.params_fingerprint``, the online
trainer's hand-off and the operator's ``lifecycle`` block, each held
against the reference's on the same seeded inputs. Both stacks serve
through the scorer's numpy host forward (as the reference's own tests do),
so the shadow pairs, the labels and every gate's evidence are the same on
both sides, and the controller's stage sequence must be equal step for
step. Tolerances: the fingerprint, the lineage and the stage sequence
exact; the challenger slot 1e-5 in p; the evaluator's snapshot (AUC,
precision, alert rates, PSI) 1e-6; the canary split row for row.
"""

from __future__ import annotations

import dataclasses
import json
import os
import types

import numpy as np
import pytest

from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)
BUCKETS = (16, 128, 1024, 4096)


@pytest.fixture(scope="module")
def champion(dataset):
    """The reference's fit_mlp on the suite's dataset, as numpy."""
    import jax

    from ccfd_tpu.parallel.train import TrainConfig, fit_mlp

    p = fit_mlp(dataset.X, dataset.y, steps=100, seed=0, tc=TrainConfig(compute_dtype="float32"))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _copy(params):
    return {"norm": dict(params["norm"]), "layers": [dict(layer) for layer in params["layers"]]}


def _degraded(params):
    """The output layer negated: p' = 1 - p, the ranking inverted."""
    p = _copy(params)
    p["layers"][-1] = {"w": -p["layers"][-1]["w"], "b": -p["layers"][-1]["b"]}
    return p


def _improved(params, bias=0.01):
    """A monotone logit shift: the same ranking, measurably other scores."""
    p = _copy(params)
    p["layers"][-1] = {"w": p["layers"][-1]["w"], "b": p["layers"][-1]["b"] + np.float32(bias)}
    return p


class _Side:
    """One package's lifecycle stack over the same params and streams."""

    def __init__(self, pkg: str, tmp, params, guardrails=None, breaker=None, persist=True):
        if pkg == "ref":
            from ccfd_tpu.bus.broker import Broker
            from ccfd_tpu.config import Config
            from ccfd_tpu.lifecycle import controller, evaluator, shadow, versions
            from ccfd_tpu.metrics.prom import Registry
            from ccfd_tpu.parallel.checkpoint import CheckpointManager
            from ccfd_tpu.serving.scorer import Scorer

            self.scorer = Scorer(model_name="mlp", params=params, batch_sizes=BUCKETS,
                                 compute_dtype="float32")
            ckpt = CheckpointManager(str(tmp / "ckpt"), keep=8, use_orbax=False)
        else:
            from ccfd_tpu_torch.bus.broker import Broker
            from ccfd_tpu_torch.config import Config
            from ccfd_tpu_torch.lifecycle import controller, evaluator, shadow, versions
            from ccfd_tpu_torch.metrics.prom import Registry
            from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
            from ccfd_tpu_torch.serving.scorer import Scorer

            self.scorer = Scorer(model_name="mlp", params=params, batch_sizes=BUCKETS,
                                 compute_dtype="float32", device="cpu")
            ckpt = CheckpointManager(str(tmp / "ckpt"), keep=8)
        self.mod = controller
        self.cfg = Config()
        self.broker = Broker()
        self.reg = Registry()
        self.store = versions.VersionStore(str(tmp / "versions.json") if persist else None)
        # no sampling budget: the tap's token bucket reads the wall clock
        self.shadow = shadow.ShadowTap(self.scorer, self.broker, self.cfg.shadow_topic,
                                       self.reg, max_rows_per_s=0)
        self.ev = evaluator.ShadowEvaluator(self.cfg, self.broker, self.scorer, self.reg)
        g = guardrails or dict(min_labels=32, min_shadow_rows=256, canary_min_labels=16,
                               max_score_psi=5.0, min_submit_interval_s=0.0)
        self.ctl = controller.LifecycleController(
            self.cfg, self.scorer, store=self.store, checkpoints=ckpt, shadow=self.shadow,
            evaluator=self.ev, guardrails=controller.Guardrails(**g), registry=self.reg,
            breaker=breaker)
        self.served = self.ctl.wrap_score(self.scorer.host_score)

    def counters(self) -> dict:
        return {n: self.reg.counter(f"ccfd_lifecycle_{n}_total").value()
                for n in ("promotions", "rollbacks", "rejections", "candidates")}

    def state(self, versions) -> tuple:
        return (self.ctl.stage, self.ctl.candidate, self.ctl.champion,
                tuple(self.store.get(v).stage for v in versions),
                self.scorer.challenger_version, self.ctl.gate.active,
                tuple(sorted(self.counters().items())))

    def pump(self, X, y, rng, labels: bool = True) -> None:
        """One scripted step: a served batch, the tap's drain, labels, a
        controller cycle."""
        self.served(X[rng.integers(0, len(X), size=256)])
        self.shadow.step()
        if labels:
            for j in rng.integers(0, len(X), size=16):
                self.broker.produce(self.cfg.labels_topic, {
                    "transaction": dict(zip(FEATURE_NAMES, map(float, X[j]))),
                    "label": int(y[j])})
        self.ctl.step()


# -- params_fingerprint -------------------------------------------------------

@pytest.mark.parametrize("tree", ["checkpoint", "int8", "seeded"])
def test_params_fingerprint_is_the_references_byte_for_byte(tree, dataset):
    from ccfd_tpu.parallel.partition import params_fingerprint as ref_fp
    from ccfd_tpu_torch.ops import quant
    from ccfd_tpu_torch.params import load_params, params_fingerprint, to_numpy

    if tree == "checkpoint":
        port = load_params()
    elif tree == "int8":
        port = quant.quantize_mlp(load_params())
    else:
        port = torch_helpers.mlp_tree(dataset.X, hidden=64)
    host = to_numpy(port)
    assert params_fingerprint(port) == params_fingerprint(host) == ref_fp(host)
    # a retyped leaf is another tree
    host["norm"]["mu"] = host["norm"]["mu"].astype(np.float64)
    assert params_fingerprint(host) == ref_fp(host) != params_fingerprint(port)


# -- versions.py ---------------------------------------------------------------

def _write_lineage(store) -> None:
    v1 = store.create(parent=None)
    store.set_checkpoint(v1.version, 1, checkpoint_hash="a" * 64)
    store.set_stage(v1.version, "CHAMPION", reason="bootstrap")
    v2 = store.create(parent=1, label_watermark=40)
    store.set_stage(v2.version, "SHADOW")
    store.set_stage(v2.version, "REJECTED", reason="auc", metrics={"auc": 0.5, "psi": None})
    store.record_event(None, "storage_pin", {"reason": "drill"})


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_sides_version_store_reads_the_others_lineage(tmp_path, writer):
    from ccfd_tpu.lifecycle.versions import VersionStore as Ref
    from ccfd_tpu_torch.lifecycle.versions import VersionStore as Port

    path = str(tmp_path / "versions.json")
    W, R = (Ref, Port) if writer == "ref" else (Port, Ref)
    w = W(path)
    _write_lineage(w)
    r = R(path)
    assert [v.to_dict() for v in r.versions()] == [v.to_dict() for v in w.versions()]
    assert r.audit_trail() == w.audit_trail()
    assert r.champion().version == 1 and r.in_stage("REJECTED")[0].version == 2
    nv = r.create(parent=1)
    assert nv.version == 3  # the counter survives the hand-over


def test_version_store_quarantines_a_torn_lineage_as_the_reference(tmp_path):
    from ccfd_tpu.lifecycle.versions import VersionStore as Ref
    from ccfd_tpu_torch.lifecycle.versions import VersionStore as Port

    out = {}
    for name, cls in (("ref", Ref), ("port", Port)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "versions.json")
        _write_lineage(cls(path))
        with open(path, "r+b") as f:
            f.seek(40)
            f.write(b"\x00garbage\x00")
        s = cls(path)
        out[name] = ([v.stage for v in s.versions()], sorted(os.listdir(d)))
    assert out["port"] == out["ref"]


# -- the Scorer's challenger slot ---------------------------------------------

def test_the_challenger_slot_matches_the_references(champion, dataset, tmp_path):
    ref = _Side("ref", tmp_path / "r", champion).scorer
    port = _Side("port", tmp_path / "p", champion).scorer
    x = dataset.X[:512]
    for s in (ref, port):
        with pytest.raises(RuntimeError):
            s.challenger_score(x)
        s.install_challenger(7, _degraded(champion))
    assert port.challenger_version == ref.challenger_version == 7
    got, want = port.challenger_score(x), ref.challenger_score(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, 1.0 - port.host_score(x), rtol=0, atol=1e-5)
    # the champion's path is untouched by the slot
    np.testing.assert_allclose(port.score(x), port.host_score(x), rtol=0, atol=1e-5)
    port.clear_challenger(version=3)  # a stale clear keeps the newer candidate
    assert port.challenger_version == 7
    port.clear_challenger(version=7)
    assert port.challenger_version is None


# -- the shadow tap and the evaluator ------------------------------------------

def test_shadow_pairs_and_the_evaluators_snapshot_match_the_references(
        champion, dataset, tmp_path):
    sides = {k: _Side(k, tmp_path / k, champion) for k in ("ref", "port")}
    x, y = dataset.X, dataset.y
    snaps, pairs = {}, {}
    for k, s in sides.items():
        s.scorer.install_challenger(3, _improved(champion, bias=0.5))
        s.shadow.arm(3)
        s.ev.begin(3)
        tap_out = s.broker.consumer("t", (s.cfg.shadow_topic,))
        s.served(x[:700])
        s.served(x[700:1500])
        assert s.shadow.step() == 1500
        pairs[k] = [r.value for r in tap_out.poll(10, 0.0)]
        for i in range(0, 400):
            s.broker.produce(s.cfg.labels_topic, {
                "transaction": dict(zip(FEATURE_NAMES, map(float, x[i]))),
                "label": int(y[i])})
        s.ev.poll()
        snaps[k] = s.ev.snapshot()
        s.ev.close()
    assert len(pairs["port"]) == len(pairs["ref"]) == 2
    for a, b in zip(pairs["port"], pairs["ref"]):
        assert a["version"] == b["version"] == 3
        for key in ("champion", "challenger"):
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5)
    got, want = snaps["port"], snaps["ref"]
    assert (got.version, got.n_labels, got.n_shadow_rows) == (want.version, want.n_labels,
                                                                want.n_shadow_rows)
    for f in ("auc_champion", "auc_challenger", "precision_champion", "precision_challenger",
              "alert_rate_champion", "alert_rate_challenger", "alert_rate_delta", "score_psi"):
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-6, f
    assert got.to_dict().keys() == want.to_dict().keys()


def test_the_shadow_taps_bounded_queue_drops_as_the_references(champion, dataset, tmp_path):
    drops = {}
    for k in ("ref", "port"):
        s = _Side(k, tmp_path / k, champion)
        tap = type(s.shadow)(s.scorer, s.broker, s.cfg.shadow_topic, s.reg,
                             max_queued_batches=4, max_rows_per_s=0, max_queued_rows=40)
        served = tap.wrap(s.scorer.host_score)
        s.scorer.install_challenger(1, _degraded(champion))
        tap.arm(1)
        for n in (8, 8, 8, 8, 8, 50, 12, 12):
            served(dataset.X[:n])
        drops[k] = (tap.qsize(),
                    s.reg.counter("ccfd_lifecycle_shadow_dropped_total").value())
    assert drops["port"] == drops["ref"]


# -- the canary gate ---------------------------------------------------------------

@pytest.mark.parametrize("weight", [0.1, 0.5])
def test_the_canary_gates_split_is_the_references_row_for_row(champion, dataset, tmp_path,
                                                              weight):
    from ccfd_tpu.serving.graph import hash_split_arms_numpy as ref_arms
    from ccfd_tpu_torch.serving.graph import hash_split_arms_numpy

    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

    x = np.concatenate([dataset.X, kaggle_surrogate(n=4096, seed=3).X]).astype(np.float32)
    out, arms = {}, {}
    for k in ("ref", "port"):
        s = _Side(k, tmp_path / k, champion)
        s.scorer.install_challenger(5, _improved(champion, bias=2.0))
        s.ctl.gate.activate(weight)
        served = s.ctl.gate.wrap(s.scorer.host_score)
        out[k] = served(x)
        arms[k] = s.reg.counter("ccfd_lifecycle_canary_rows_total").value(
            labels={"arm": "challenger"})
    got = hash_split_arms_numpy(x, (1.0 - weight, weight))
    np.testing.assert_array_equal(got, ref_arms(x, (1.0 - weight, weight)))
    assert 0 < got.sum() < len(x) and arms["port"] == arms["ref"] == got.sum()
    np.testing.assert_allclose(out["port"], out["ref"], rtol=0, atol=1e-5)


# -- the controller's state machine ----------------------------------------------

def _scenario(name: str, side: _Side, champion, X, y) -> list:
    """Drive ``side`` through a scripted candidate stream; the state after
    every step."""
    rng = np.random.default_rng(7)
    trace = []
    if name == "reject":
        vs = [side.ctl.submit_candidate(_degraded(champion), label_watermark=40)]
        for _ in range(8):
            side.pump(X, y, rng)
            trace.append(side.state(vs))
    elif name == "promote":
        vs = [side.ctl.submit_candidate(_improved(champion), label_watermark=80)]
        for _ in range(24):
            side.pump(X, y, rng)
            trace.append(side.state(vs))
    elif name == "rollback_on_breaker":
        vs = [side.ctl.submit_candidate(_improved(champion), label_watermark=80)]
        for _ in range(24):
            side.pump(X, y, rng, labels=side.ctl.stage == side.mod.STAGE_SHADOW)
            trace.append(side.state(vs))
            if side.ctl.stage == side.mod.STAGE_CANARY:
                break
        side.ctl.breaker.state = "open"
        side.ctl.step()
        trace.append(side.state(vs))
    else:  # "supersede": a newer candidate before a verdict, then pacing
        vs = [side.ctl.submit_candidate(_improved(champion, 0.01), label_watermark=10)]
        side.pump(X, y, rng)
        vs.append(side.ctl.submit_candidate(_improved(champion, 0.02), label_watermark=20))
        trace.append(side.state(vs))
        side.ctl.guardrails = dataclasses.replace(side.ctl.guardrails, min_submit_interval_s=1e9)
        vs.append(side.ctl.submit_candidate(_improved(champion, 0.03), label_watermark=30))
        trace.append(side.state(vs))
        for _ in range(6):
            side.pump(X, y, rng)
            trace.append(side.state(vs))
    lineage = [(v.version, v.parent, v.stage, v.label_watermark, v.checkpoint_step,
                v.checkpoint_hash) for v in side.store.versions()]
    events = [(e["version"], e["event"], e["detail"].get("from"), e["detail"].get("to"))
              for e in side.store.audit_trail()]
    return trace + [lineage, events, side.ctl.serving_consistent()]


@pytest.mark.parametrize("scenario", ["reject", "promote", "rollback_on_breaker", "supersede"])
def test_the_controllers_stage_sequence_is_the_references_step_for_step(
        champion, dataset, tmp_path, scenario):
    out, params = {}, {}
    for k in ("ref", "port"):
        breaker = types.SimpleNamespace(state="closed")
        s = _Side(k, tmp_path / k, champion, breaker=breaker)
        out[k] = _scenario(scenario, s, champion, dataset.X, dataset.y)
        params[k] = s.scorer.host_score(dataset.X[:256])
        s.ctl.close()
    assert out["port"] == out["ref"]
    final_stage = out["port"][-3][-1][2]
    want = {"reject": "REJECTED", "promote": "CHAMPION", "rollback_on_breaker": "ROLLED_BACK",
            "supersede": "REJECTED"}
    if scenario != "supersede":
        assert final_stage == want[scenario], out["port"][-3]
    # serving after the scenario: the same tree on both sides
    np.testing.assert_allclose(params["port"], params["ref"], rtol=0, atol=1e-6)


def test_a_promoted_candidate_serves_bit_for_bit_and_survives_a_restart(
        champion, dataset, tmp_path):
    from ccfd_tpu.lifecycle.controller import LifecycleController as RefController
    from ccfd_tpu.lifecycle.versions import VersionStore as RefStore
    from ccfd_tpu.parallel.partition import params_fingerprint as ref_fp
    from ccfd_tpu_torch.params import params_fingerprint

    side = _Side("port", tmp_path, champion)
    rng = np.random.default_rng(1)
    v = side.ctl.submit_candidate(_improved(champion), label_watermark=80)
    for _ in range(24):
        side.pump(dataset.X, dataset.y, rng)
        if side.store.get(v).stage == "CHAMPION":
            break
    rec = side.store.get(v)
    assert rec.stage == "CHAMPION"
    # the served params are the promoted checkpoint, bit for bit
    assert params_fingerprint(side.scorer.params) == rec.checkpoint_hash
    assert ref_fp(_improved(champion)) == rec.checkpoint_hash
    side.ctl.close()
    # the reference's controller boots on the port's lineage and checkpoints
    ref = _Side("ref", tmp_path / "fresh", champion)  # a scorer on the OLD champion
    from ccfd_tpu.parallel.checkpoint import CheckpointManager

    store = RefStore(str(tmp_path / "versions.json"))
    ctl = RefController(ref.cfg, ref.scorer, store=store,
                        checkpoints=CheckpointManager(str(tmp_path / "ckpt"), keep=8,
                                                      use_orbax=False),
                        shadow=ref.shadow, evaluator=ref.ev)
    assert ctl.champion == v
    assert ref_fp(ref.scorer.params) == rec.checkpoint_hash
    ctl.close()
    # and the port's, in a new process's state, re-asserts it too
    port = _Side("port", tmp_path, champion)
    assert port.ctl.champion == v
    assert params_fingerprint(port.scorer.params) == rec.checkpoint_hash
    port.ctl.close()


# -- the trainer's hand-off ----------------------------------------------------------

def test_the_trainer_hands_candidates_to_the_lifecycle_as_the_references(champion, dataset):
    from ccfd_tpu.bus.broker import Broker as RefBroker
    from ccfd_tpu.config import Config as RefConfig
    from ccfd_tpu.parallel.online import OnlineTrainer as RefTrainer
    from ccfd_tpu.parallel.train import TrainConfig as RefTC
    from ccfd_tpu.serving.scorer import Scorer as RefScorer
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.params import to_numpy
    from ccfd_tpu_torch.parallel.online import OnlineTrainer
    from ccfd_tpu_torch.parallel.train import TrainConfig
    from ccfd_tpu_torch.serving.scorer import Scorer

    class Stub:
        def __init__(self, host):
            self.host = host
            self.submissions = []

        def submit_candidate(self, params, label_watermark=0):
            self.submissions.append((self.host(params), label_watermark))
            return len(self.submissions)

    out = {}
    for k in ("ref", "port"):
        if k == "ref":
            import jax

            cfg, broker = RefConfig(retrain_min_labels=8, retrain_batch=32), RefBroker()
            scorer = RefScorer(model_name="mlp", params=champion, batch_sizes=BUCKETS,
                               compute_dtype="float32")
            stub = Stub(lambda p: jax.tree.map(np.asarray, p))
            tr = RefTrainer(cfg, broker, scorer, scorer.params, tc=RefTC(compute_dtype="float32"),
                            steps_per_round=2, seed=0, lifecycle=stub)
        else:
            cfg, broker = Config(retrain_min_labels=8, retrain_batch=32), Broker()
            scorer = Scorer(model_name="mlp", params=champion, batch_sizes=BUCKETS,
                            compute_dtype="float32", device="cpu")
            stub = Stub(to_numpy)
            tr = OnlineTrainer(cfg, broker, scorer, scorer.params,
                               tc=TrainConfig(compute_dtype="float32"), steps_per_round=2,
                               seed=0, lifecycle=stub)
        before = scorer.host_score(dataset.X[:32]).copy()
        for i in range(16):
            broker.produce(cfg.labels_topic, {
                "transaction": dict(zip(FEATURE_NAMES, map(float, dataset.X[i]))),
                "label": int(dataset.y[i])})
        assert tr.step() is True
        # governed: no direct swap, serving untouched until a promotion
        np.testing.assert_array_equal(scorer.host_score(dataset.X[:32]), before)
        assert tr.registry.counter("retrain_param_swaps_total").value() == 0
        out[k] = stub.submissions
        tr.close()
    assert len(out["port"]) == len(out["ref"]) == 1
    assert out["port"][0][1] == out["ref"][0][1] == 16  # the label watermark
    (gp, _), (wp, _) = out["port"][0], out["ref"][0]
    for a, b in zip(gp["layers"], wp["layers"]):
        np.testing.assert_allclose(a["w"], b["w"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(a["b"], b["b"], rtol=0, atol=1e-5)


def test_a_reject_rebases_the_trainer_onto_the_champion(champion, dataset, tmp_path):
    side = _Side("port", tmp_path, champion)
    got = []
    side.ctl.trainer_rebase = got.append
    rng = np.random.default_rng(7)
    side.ctl.submit_candidate(_degraded(champion))
    for _ in range(8):
        side.pump(dataset.X, dataset.y, rng)
    assert len(got) == 1
    for a, b in zip(got[0]["layers"], champion["layers"]):
        np.testing.assert_array_equal(a["w"], b["w"])
    side.ctl.close()


# -- the operator and the commands ------------------------------------------------

def _lifecycle_cr(tmp_path, **over):
    spec = {
        "store": {"enabled": False}, "bus": {"partitions": 2},
        "scorer": {"enabled": True, "model": "mlp", "train_steps": 0},
        "engine": {"enabled": True}, "notify": {"enabled": True, "seed": 0},
        "router": {"enabled": True}, "retrain": {"enabled": True, "interval_s": 0.1},
        "producer": {"enabled": False}, "monitoring": {"enabled": False},
        "health": {"enabled": False}, "heal": {"enabled": False},
        "incident": {"enabled": False}, "capacity": {"enabled": False},
        "analytics": {"enabled": False}, "investigator": {"enabled": False},
        "lifecycle": {"enabled": True, "state_dir": str(tmp_path / "lc")},
        "audit": {"dir": str(tmp_path / "audit")},
    }
    spec.update(over)
    return {"spec": spec}


@pytest.mark.parametrize("direct_swap", [False, True])
def test_the_operator_wires_the_lifecycle_as_the_reference(tmp_path, direct_swap):
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    cr = _lifecycle_cr(tmp_path, retrain={"enabled": True, "direct_swap": direct_swap})
    p = Platform(PlatformSpec.from_cr(cr, cfg=Config(batch_sizes=(16, 128))),
                 device="cpu").up()
    try:
        assert {"lifecycle", "lifecycle-shadow", "router", "retrain"} <= set(
            p.supervisor.status())
        lc = p.lifecycle
        # the router's lane: the canary gate outside the shadow tap, one
        # breaker shared with the ladder
        assert lc.breaker is p.router._breaker
        assert p.router.score.__wrapped__.__wrapped__ == p.scorer.score
        assert p.audit.lineage_fn() == (1, lc.store.champion().checkpoint_hash)
        assert lc.serving_consistent() and lc.champion == 1
        trainer = lc.trainer_rebase.__self__ if not direct_swap else None
        if trainer is not None:
            assert trainer.lifecycle is lc
        else:
            assert lc.trainer_rebase is None
    finally:
        p.down()
    assert os.path.exists(tmp_path / "lc" / "versions.json")


def test_the_lifecycle_command_and_the_audit_lineage_join_read_both_sides(
        tmp_path, capsys, champion, dataset):
    from ccfd_tpu.cli import main as ref_main
    from ccfd_tpu_torch.cli import main
    from ccfd_tpu_torch.observability.audit import AuditLog

    side = _Side("port", tmp_path / "lc", champion)
    rng = np.random.default_rng(1)
    v = side.ctl.submit_candidate(_improved(champion), label_watermark=80)
    for _ in range(24):
        side.pump(dataset.X, dataset.y, rng)
    side.ctl.close()
    assert side.store.get(v).stage == "CHAMPION"
    for fn in (main, ref_main):
        assert fn(["lifecycle", "--dir", str(tmp_path / "lc"), "--json"]) == 0
    port_doc, ref_doc = _two_json(capsys)
    assert port_doc == ref_doc
    assert main(["lifecycle", "--dir", str(tmp_path / "lc"), "--audit"]) == 0
    text = capsys.readouterr().out
    assert f"champion: v{v}" in text and "RETIRED" in text
    assert main(["lifecycle", "--dir", str(tmp_path / "nope")]) == 2
    # a decision stamped with the champion's lineage joins it
    rec = side.store.get(v)
    audit = AuditLog(dir=str(tmp_path / "audit"), fsync=False,
                     lineage_fn=lambda: (rec.version, rec.checkpoint_hash))
    audit.record_batch([{"tx": "tx-1", "uid": "0:1", "ts": 1.0, "proba": 0.25,
                         "rule": "standard", "branch": "standard", "pid": 1,
                         "priority": "normal"}])
    audit.flush()
    capsys.readouterr()
    docs = []
    for fn in (main, ref_main):
        assert fn(["audit", "tx-1", "--dir", str(tmp_path / "audit"), "--lifecycle-dir",
                   str(tmp_path / "lc"), "--json"]) == 0
        docs.append(json.loads(capsys.readouterr().out))
    assert docs[0]["lineage"] == docs[1]["lineage"]
    assert docs[0]["lineage"]["hash_parity"] is True
    assert docs[0]["lineage"]["version"]["stage"] == "CHAMPION"
    assert main(["audit", "tx-1", "--dir", str(tmp_path / "audit"), "--lifecycle-dir",
                 str(tmp_path / "lc")]) == 0
    assert f"lineage: v{v} stage=CHAMPION" in capsys.readouterr().out


def _two_json(capsys):
    out = capsys.readouterr().out
    dec = json.JSONDecoder()
    first, end = dec.raw_decode(out)
    second, _ = dec.raw_decode(out[end:].lstrip())
    return first, second
