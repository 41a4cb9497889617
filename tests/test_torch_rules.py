"""The port's rule base (ccfd_tpu_torch/router/rules.py) against the JAX
package's (ccfd_tpu/router/rules.py) on the same seeded rows and
probabilities: fired indices equal on every row, rule order equal
(salience, then authoring order on ties), the same refusals."""

import json

import numpy as np
import pytest

from ccfd_tpu.router import rules as ref
from ccfd_tpu_torch.router import rules as port

# feature columns, ==, != and between, two salience ties, a default rule
RULES_OBJ = [
    {"name": "small", "process": "standard", "salience": 20,
     "when": [{"field": "Amount", "op": "between", "value": [0.0, 50.0]},
              {"field": "proba", "op": "<", "value": 0.9}]},
    {"name": "v14_low", "process": "fraud", "salience": 10,
     "when": [{"field": "V14", "op": "<", "value": -1.0},
              {"field": "proba", "op": ">=", "value": 0.3}]},
    {"name": "fraud", "process": "fraud", "salience": 10,
     "when": [{"field": "proba", "op": ">=", "value": 0.5}]},
    {"name": "v1_exact", "process": "fraud", "salience": 5,
     "when": [{"field": "V1", "op": "==", "value": 0.1}]},
    {"name": "v2_not", "process": "standard", "salience": 5,
     "when": [{"field": "V2", "op": "!=", "value": 0.25},
              {"field": "Time", "op": ">", "value": 100.0}]},
    {"name": "default", "process": "standard", "set_vars": {"tier": "std"}},
]


def _data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 30)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1]) * 60.0  # Amount
    x[:, 0] = np.abs(x[:, 0]) * 200.0  # Time
    x[::7, 1] = np.float32(0.1)  # V1 == 0.1 in float32, as Condition.mask casts
    x[::11, 2] = np.float32(0.25)
    proba = rng.random(n).astype(np.float32)
    proba[::13] = np.float32(0.5)  # exactly at the threshold
    return x, proba


@pytest.mark.parametrize("threshold", [0.5, 0.3, 0.9])
def test_default_rules_fire_as_the_reference(threshold):
    x, proba = _data(seed=1)
    want = ref.default_rules(threshold).evaluate(x, proba)
    got = port.default_rules(threshold).evaluate(x, proba)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {0, 1}


def test_json_rules_fire_as_the_reference_with_salience_ties(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(RULES_OBJ))
    r, p = ref.RuleSet.from_file(str(path)), port.RuleSet.from_file(str(path))
    # stable salience sort: the two rules at 10 keep their authoring order
    assert [q.name for q in p.rules] == [q.name for q in r.rules] == [
        "small", "v14_low", "fraud", "v1_exact", "v2_not", "default"]
    assert [dict(q.set_vars) for q in p.rules] == [dict(q.set_vars) for q in r.rules]
    for seed in range(3):
        x, proba = _data(seed=seed)
        want = r.evaluate(x, proba)
        np.testing.assert_array_equal(p.evaluate(x, proba), want)
    assert len(set(want.tolist())) >= 5  # most rules fire somewhere


@pytest.mark.parametrize("bad,match", [
    ({"field": "V99", "op": ">", "value": 1}, "unknown field"),
    ({"field": "V1", "op": "~", "value": 1}, "unknown op"),
    ({"field": "V1", "op": "between", "value": [1]}, "between"),
    ({"field": "V1", "op": ">", "value": "x"}, "non-numeric"),
])
def test_bad_conditions_raise_as_the_reference(bad, match):
    obj = [{"name": "r", "process": "fraud", "when": [bad]},
           {"name": "d", "process": "standard"}]
    with pytest.raises(ValueError, match=match):
        ref.RuleSet.from_obj(obj)
    with pytest.raises(ValueError, match=match):
        port.RuleSet.from_obj(obj)


@pytest.mark.parametrize("rules,match", [
    ([], "empty"),
    ([{"name": "a", "process": "fraud"}, {"name": "a", "process": "standard"}], "duplicate"),
    ([{"name": "a", "process": "fraud",
       "when": [{"field": "proba", "op": ">", "value": 0.5}]}], "no default rule"),
])
def test_bad_rule_bases_raise_as_the_reference(rules, match):
    for mod in (ref, port):
        with pytest.raises(ValueError, match=match):
            mod.RuleSet.from_obj(rules)


def test_when_fn_rules_evaluate_as_the_reference():
    def fn(x, proba):
        return x[:, 3] > 0

    mk = lambda mod: mod.RuleSet([  # noqa: E731
        mod.Rule("coded", process="fraud", salience=1, when_fn=fn),
        mod.Rule("default", process="standard")])
    x, proba = _data(seed=4)
    np.testing.assert_array_equal(mk(port).evaluate(x, proba), mk(ref).evaluate(x, proba))
    with pytest.raises(ValueError, match="callable"):
        port.Rule("bad", process="fraud", when_fn=3)
