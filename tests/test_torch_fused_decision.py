"""The port's decision plane (ops/fused_decision.py, serving/fused.py)
against the JAX package's, on the CPU.

- ``compile_rules``: every array bit-equal to the reference's.
- ``eval_plan``: torch ops against the reference's (XLA) and against
  ``RuleSet.evaluate``: fired indices equal on every row.
- ``FusedDecisionScorer.decide`` against the reference's (its Pallas
  kernels in interpret mode) for ``mlp``, ``mlp_q8`` on the int8 wire and
  ``mlp_q8`` on the f32 wire: proba to 1e-5 (the int8 paths through
  ``torch_helpers.assert_matches_jax``, see ROADMAP C2), fired equal on
  every row; and bit-equal to the port's own staged path.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.ops import fused_decision as ref_fd
from ccfd_tpu.ops import quant as jax_quant
from ccfd_tpu.router import rules as ref_rules
from ccfd_tpu.serving.fused import FusedDecisionScorer as RefPlane
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.ops import fused_decision as fd
from ccfd_tpu_torch.ops import quant
from ccfd_tpu_torch.process.fraud import build_engine
from ccfd_tpu_torch.router import rules as port_rules
from ccfd_tpu_torch.router.router import Router
from ccfd_tpu_torch.serving.fused import FusedDecisionScorer
from ccfd_tpu_torch.serving.scorer import Scorer
from tests.test_torch_rules import RULES_OBJ
from tests.torch_helpers import assert_matches_jax, mlp_tree

BUCKETS = (16, 128)
SIZES = (1, 7, 16, 100, 300)  # padded, bucket-exact, and two chunks of 128


@pytest.fixture(scope="module")
def data():
    X = kaggle_surrogate(n=2048, seed=5).X
    X[::9, 1] = np.float32(0.1)  # V1 == 0.1 rows for the == rule
    return X, mlp_tree(X, hidden=64, seed=2)


def _rule_sets(mod):
    return {"default": mod.default_rules(0.5), "json": mod.RuleSet.from_obj(RULES_OBJ)}


@pytest.mark.parametrize("which", ["default", "json"])
def test_compile_rules_is_bit_equal_to_the_reference(which):
    want = ref_fd.compile_rules(_rule_sets(ref_rules)[which])
    got = fd.compile_rules(_rule_sets(port_rules)[which])
    for k in ("sel", "idx", "op", "lo", "hi"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert got.processes == want.processes and got.names == want.names
    assert got.needs_features == want.needs_features == (which == "json")
    assert got.n_rules == want.n_rules


@pytest.mark.parametrize("which", ["default", "json"])
def test_eval_plan_matches_the_reference_and_evaluate(data, which):
    X, _ = data
    rng = np.random.default_rng(3)
    x = X[:700]
    proba = rng.random(700).astype(np.float32)
    proba[::17] = np.float32(0.5)
    plan = fd.compile_rules(_rule_sets(port_rules)[which])
    got = fd.eval_plan(plan, torch.from_numpy(x), torch.from_numpy(proba)).numpy()
    ref_plan = ref_fd.compile_rules(_rule_sets(ref_rules)[which])
    want = np.asarray(ref_fd.eval_plan(ref_plan, jnp.asarray(x), jnp.asarray(proba)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _rule_sets(port_rules)[which].evaluate(x, proba))
    assert len(set(got.tolist())) >= 2


def test_first_match_wins_on_ties():
    """argmax over the match matrix (cast to int32) returns the FIRST
    matching rule: rows matching rules 1, 2 and the default fire 1."""
    rules = port_rules.RuleSet([
        port_rules.Rule("hi", "fraud", when=(port_rules.Condition("proba", ">=", 0.9),),
                        salience=3),
        port_rules.Rule("mid", "fraud", when=(port_rules.Condition("proba", ">=", 0.5),),
                        salience=2),
        port_rules.Rule("low", "fraud", when=(port_rules.Condition("proba", ">=", 0.1),),
                        salience=2),
        port_rules.Rule("default", "standard")])
    proba = torch.tensor([0.95, 0.6, 0.2, 0.05, 0.5, 0.9], dtype=torch.float32)
    x = torch.zeros((6, 30))
    fired = fd.eval_plan(fd.compile_rules(rules), x, proba)
    assert fired.tolist() == [0, 1, 2, 3, 1, 0]
    m = torch.tensor([[False, True, True, True], [False, False, False, True]])
    assert torch.argmax(m.to(torch.int32), dim=1).tolist() == [1, 3]


def _ref_plane(model, params, rules, monkeypatch, wire):
    monkeypatch.setenv("CCFD_Q8_WIRE", wire)
    sc = RefScorer(model_name=model, params=params, batch_sizes=BUCKETS, host_tier_rows=0,
                   use_fused=True)  # the Pallas kernels, in interpret mode on the CPU
    sc.warmup()
    plane = RefPlane(sc, rules)
    assert plane.enabled
    plane.warmup()
    return plane


def _port_plane(model, params, rules, wire):
    sc = Scorer(model_name=model, params=params, batch_sizes=BUCKETS, device="cpu", q8_wire=wire)
    plane = FusedDecisionScorer(sc, rules)
    assert plane.enabled
    plane.warmup()
    return sc, plane


@pytest.mark.parametrize("model,wire", [("mlp", "int8"), ("mlp_q8", "int8"), ("mlp_q8", "f32")])
def test_decide_matches_the_reference_plane(data, monkeypatch, model, wire):
    X, tree = data
    q8 = model == "mlp_q8"
    ref_params = jax_quant.quantize_mlp(tree) if q8 else tree
    port_params = quant.quantize_mlp(tree) if q8 else tree
    ref = _ref_plane(model, ref_params, _rule_sets(ref_rules)["json"], monkeypatch, wire)
    assert ref.executable_grid()["forward"] == (
        "fused_kernel_int8_wire" if q8 and wire == "int8" else "fused_kernel")
    _sc, plane = _port_plane(model, port_params, _rule_sets(port_rules)["json"], wire)
    assert plane.executable_grid()["forward"] == ref.executable_grid()["forward"]
    for n in SIZES:
        x = X[1000:1000 + n]
        p_ref, f_ref = ref.decide(x)
        p, f = plane.decide(x)
        assert p.dtype == np.float32 and f.dtype == np.int64 and p.shape == f.shape == (n,)
        if q8:
            with jax.disable_jit():
                eager = np.asarray(jax_quant.apply(ref_params, jnp.asarray(x)))
            assert_matches_jax(p, eager, p_ref)
        else:
            np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(f, f_ref)
    assert plane.staged_fallbacks == ref.staged_fallbacks == 0


@pytest.mark.parametrize("which", ["default", "json"])
@pytest.mark.parametrize("model,wire", [("mlp", "int8"), ("mlp_q8", "int8"), ("mlp_q8", "f32")])
def test_decide_is_bit_equal_to_the_staged_path(data, model, wire, which):
    X, tree = data
    rules = _rule_sets(port_rules)[which]
    params = quant.quantize_mlp(tree) if model == "mlp_q8" else tree
    sc, plane = _port_plane(model, params, rules, wire)
    for n in SIZES:
        x = X[:n]
        p, f = plane.decide(x)
        staged = sc.score(x)
        assert p.tobytes() == staged.tobytes()
        np.testing.assert_array_equal(f, rules.evaluate(x, staged))
    grid = plane.executable_grid()
    assert grid["dispatches"] == {"16": 3, "128": 4}  # 300 rows: 128 + 128 + 44
    assert grid["host_syncs"] == 7 and grid["staged_fallbacks"] == 0
    assert grid["needs_features"] == (which == "json") and grid["enabled"]
    assert plane.decide(X[:0])[0].shape == (0,)


def _coded_rules():
    return port_rules.RuleSet([
        port_rules.Rule("coded", "fraud", salience=1, when_fn=lambda x, p: p > 0.7),
        port_rules.Rule("default", "standard")])


def test_a_when_fn_rule_serves_the_whole_set_staged(data, caplog):
    X, tree = data
    sc = Scorer(params=tree, batch_sizes=BUCKETS, device="cpu")
    with caplog.at_level(logging.WARNING):
        plane = FusedDecisionScorer(sc, _coded_rules(), registry=None)
    assert not plane.enabled
    assert "STAGED" in caplog.text
    p, f = plane.decide(X[:20])
    assert f is None and p.tobytes() == sc.score(X[:20]).tobytes()
    assert plane.staged_fallbacks == 1 and plane.executable_grid()["rules"] == 0
    with pytest.raises(RuntimeError, match="refused"):
        FusedDecisionScorer(sc, _coded_rules(), strict=True)


def test_swap_params_runs_the_grid_before_the_flip(data):
    X, tree = data
    sc, plane = _port_plane("mlp", tree, _rule_sets(port_rules)["default"], "int8")
    sc.add_prepublish_hook(plane.prepublish)
    warm = plane.warm_dispatches
    new = mlp_tree(X, hidden=64, seed=9)
    sc.swap_params(new)
    assert plane.warm_dispatches == warm + len(BUCKETS)
    assert plane.decide(X[:50])[0].tobytes() == sc.score(X[:50]).tobytes()

    def broken(staged):
        raise RuntimeError("grid did not run")

    sc.add_prepublish_hook(broken)
    before = sc.score(X[:50])
    with pytest.raises(RuntimeError, match="grid did not run"):
        sc.swap_params(mlp_tree(X, hidden=64, seed=10))
    assert sc.score(X[:50]).tobytes() == before.tobytes()  # the flip never happened


def test_router_guards_the_plane_and_the_rule_targets(data, caplog):
    X, tree = data
    cfg = Config()
    broker = Broker()
    engine = build_engine(cfg, broker)
    sc, plane = _port_plane("mlp", tree, _rule_sets(port_rules)["default"], "int8")
    with caplog.at_level(logging.WARNING):
        r = Router(cfg, broker, sc.score, engine, rules=port_rules.default_rules(0.5),
                   decision_fn=plane)
    assert r._decision_fn is None and "different RuleSet" in caplog.text
    same = Router(cfg, broker, sc.score, engine, rules=plane.rules, decision_fn=plane)
    assert same._decision_fn is plane
    unknown = port_rules.RuleSet([port_rules.Rule("x", "nowhere")])
    with pytest.raises(ValueError, match="unregistered processes"):
        Router(cfg, broker, sc.score, engine, rules=unknown)
