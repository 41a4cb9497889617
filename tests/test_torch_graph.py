"""The port's inference graph (serving/graph.py) against
ccfd_tpu/serving/graph.py: every component on the same inputs, the
ensemble CR end to end with the same params (carried across by
``from_jax_model_params``), CR parsing and validation errors raised alike,
the built-in-name guard, the ``hash_split`` arms against the reference's
compiled router and numpy mirror, and a graph served by the Scorer with one
node swapped."""

import copy
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.cli import _restore_gbt_params
from ccfd_tpu.serving import graph as jax_graph
from ccfd_tpu.serving.scorer import Scorer as JaxScorer
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.params import from_jax_model_params, to_numpy
from ccfd_tpu_torch.serving import graph
from ccfd_tpu_torch.serving.scorer import Scorer

CR = pathlib.Path(__file__).resolve().parents[1] / "deploy" / "model" / "graph_ensemble.json"

# (kind, implementation, config) of every registered component
COMPONENTS = [
    ("TRANSFORMER", "standardize", "std"), ("TRANSFORMER", "identity", {}),
    ("TRANSFORMER", "clip", {"lo": -1.0, "hi": 2.0}), ("TRANSFORMER", "clip", {}),
    ("OUTPUT_TRANSFORMER", "identity", {}), ("OUTPUT_TRANSFORMER", "platt", {}),
    ("OUTPUT_TRANSFORMER", "platt", {"a": 1.7, "b": -0.4}),
    ("COMBINER", "average", {}), ("COMBINER", "max", {}),
    ("COMBINER", "weighted", {"weights": [3, 1, 2]}),
    ("ROUTER", "feature_threshold", {"feature": "Amount", "threshold": 50.0}),
    ("ROUTER", "feature_threshold", {"feature": 3, "threshold": 0.0}),
    ("ROUTER", "feature_threshold", {}),
    ("ROUTER", "hash_split", {"weights": [0.6, 0.3, 0.1]}),
]


@pytest.fixture(scope="module")
def rows():
    return kaggle_surrogate(n=1024, seed=13).X


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kind,impl,config", COMPONENTS,
                         ids=[f"{k}-{i}-{n}" for n, (k, i, _c) in enumerate(COMPONENTS)])
def test_every_component_matches_the_reference(rows, kind, impl, config):
    if config == "std":
        config = {"mean": rows.mean(0).tolist(),
                  "scale": [0.0] + rows.std(0)[1:].tolist()}  # a zero scale keeps 1
    rinit, rapply = jax_graph._KIND_REGISTRY[kind][impl]
    minit, mapply = graph._KIND_REGISTRY[kind][impl]
    ref_p = _np(rinit(jax.random.PRNGKey(0), config))
    my_p = minit(torch.Generator().manual_seed(0), config)
    assert sorted(ref_p) == sorted(my_p)
    for k in ref_p:
        np.testing.assert_array_equal(my_p[k].numpy(), ref_p[k], err_msg=k)
    rng = np.random.default_rng(1)
    p = rng.uniform(0, 1, size=(3, rows.shape[0])).astype(np.float32)
    p[:, :4] = [0.0, 1.0, 1e-9, 1.0 - 1e-9]  # the logit's clip at 1e-6
    if kind in ("TRANSFORMER", "ROUTER"):
        got = mapply(my_p, torch.from_numpy(rows), config).numpy()
        want = np.asarray(rapply(ref_p, jnp.asarray(rows), config))
    elif kind == "OUTPUT_TRANSFORMER":
        got = mapply(my_p, torch.from_numpy(p[0]), config).numpy()
        want = np.asarray(rapply(ref_p, jnp.asarray(p[0]), config))
    else:
        got = mapply(my_p, [torch.from_numpy(v) for v in p], config).numpy()
        want = np.asarray(rapply(ref_p, [jnp.asarray(v) for v in p], config))
    assert got.shape == want.shape and got.dtype == np.float32
    if impl == "hash_split":  # Kaggle-scale |h|: arms may differ at a boundary
        _assert_arms_agree(got.argmax(1), want.argmax(1), rows, config["weights"])
        got, want = got[got.argmax(1) == want.argmax(1)], want[got.argmax(1) == want.argmax(1)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _assert_arms_agree(got, want, x, weights):
    """Equal arms, except on rows whose u lies within HASH_SPLIT_MARGIN_ULPS
    of a boundary: on Kaggle-scale rows (Time to 1.7e5) float32 keeps u of
    |h| ~ 1e5 to ~0.008, and two summation orders of h differ by an ulp or
    two, as the reference's compiled router and its own numpy mirror do."""
    differ = np.asarray(got) != np.asarray(want)
    margin = graph.hash_split_margin_ulps(x, weights)
    assert (margin[differ] <= graph.HASH_SPLIT_MARGIN_ULPS).all(), margin[differ]
    assert differ.mean() < 0.05


def _cr(weights=None):
    cr = json.loads(CR.read_text())
    if weights is not None:
        blend = cr["spec"]["predictors"][0]["graph"]["children"][0]
        blend["parameters"][0]["value"] = json.dumps(weights)
    return cr


ROUTED = {"metadata": {"name": "routed"}, "spec": {"predictors": [{"graph": {
    "name": "ab", "type": "ROUTER", "implementation": "hash_split",
    "parameters": [{"name": "weights", "value": "[0.7, 0.3]", "type": "JSON"}],
    "children": [
        {"name": "trees", "type": "MODEL", "implementation": "gbt"},
        {"name": "std", "type": "TRANSFORMER", "implementation": "clip",
         "parameters": [{"name": "lo", "value": "-50", "type": "FLOAT"},
                        {"name": "hi", "value": "500", "type": "FLOAT"}],
         "children": [{"name": "modelfull", "type": "MODEL"}]}]}}]}}


@pytest.mark.parametrize("case", ["ensemble", "ensemble-blend", "routed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphs_end_to_end_match_the_reference(rows, case, dtype):
    cr = {"ensemble": _cr(), "ensemble-blend": _cr([0.4, 0.6]), "routed": ROUTED}[case]
    ref_g, my_g = jax_graph.InferenceGraph.from_cr(cr), graph.InferenceGraph.from_cr(cr)
    assert my_g.name == ref_g.name and my_g.node_names == ref_g.node_names
    ref_p = _np(ref_g.init(jax.random.PRNGKey(3)))
    if case == "routed":
        ref_p["trees"] = _np(_restore_gbt_params(""))  # the committed ensemble
        ref_p["modelfull"]["w"] = ref_p["modelfull"]["w"] * 30.0  # p spread over (0, 1)
    my_p = from_jax_model_params(my_g.name, ref_p)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    want = np.asarray(ref_g.build()(ref_p, jnp.asarray(rows), compute_dtype=jdt))
    got = my_g.build()(my_p, torch.from_numpy(rows), compute_dtype=tdt).numpy()
    same = np.ones(len(rows), bool)
    if case == "routed":  # the rows the two hashes put in different arms
        arms = (graph.hash_split_arms(torch.from_numpy(rows), my_p["ab"]["cum"]).numpy(),
                np.asarray(jax_graph._hash_split_weights(ref_p["ab"], jnp.asarray(rows),
                                                         {})).argmax(1))
        _assert_arms_agree(*arms, rows, [0.7, 0.3])
        same = arms[0] == arms[1]
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-5)
    assert want.std() > 1e-3  # the probabilities spread


def _raises(build):
    """(type, message) of what ``build(module, key)`` raises in each
    package, ``key`` its own seed (a PRNG key, a torch generator)."""
    out = []
    for mod, key in ((jax_graph, jax.random.PRNGKey(0)),
                     (graph, torch.Generator().manual_seed(0))):
        with pytest.raises(Exception) as err:
            build(mod, key)
        out.append((type(err.value), str(err.value)))
    return out


INVALID = {
    "model-with-child": lambda g, k: g.Node("m", "MODEL", children=(g.Node("c", "MODEL"),)),
    "transformer-no-child": lambda g, k: g.Node("t", "TRANSFORMER", "identity"),
    "combiner-one-child": lambda g, k: g.Node("c", "COMBINER", "average",
                                           (g.Node("m", "MODEL"),)),
    "unknown-type": lambda g, k: g.Node("x", "SPLITTER"),
    "duplicate-names": lambda g, k: g.InferenceGraph(g.Node(
        "e", "COMBINER", "average", (g.Node("m", "MODEL"), g.Node("m", "MODEL")))),
    "unknown-component": lambda g, k: g.InferenceGraph(g.Node(
        "e", "COMBINER", "nope", (g.Node("a", "MODEL"), g.Node("b", "MODEL")))).init(k),
    "threshold-three-children": lambda g, k: g.InferenceGraph(g.Node(
        "r", "ROUTER", "feature_threshold", tuple(g.Node(n, "MODEL") for n in "abc"))),
    "weights-for-children": lambda g, k: g.InferenceGraph(g.Node(
        "w", "COMBINER", "weighted", tuple(g.Node(n, "MODEL") for n in "abc"),
        config={"weights": [0.6, 0.4]})),
    "weighted-without-weights": lambda g, k: g.InferenceGraph(g.Node(
        "w", "COMBINER", "weighted", (g.Node("a", "MODEL"), g.Node("b", "MODEL")))).init(k),
    "hash-split-without-weights": lambda g, k: g.InferenceGraph(g.Node(
        "h", "ROUTER", "hash_split", (g.Node("a", "MODEL"), g.Node("b", "MODEL")))).init(k),
    "node-without-name": lambda g, k: g.InferenceGraph.from_cr({"type": "MODEL"}),
    "unknown-model": lambda g, k: g.InferenceGraph(g.Node("m", "MODEL", "seq_nope")).build(),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validation_errors_are_raised_alike(case):
    ref, mine = _raises(INVALID[case])
    assert mine[0] is not Exception and mine[0].__name__ == ref[0].__name__
    if case == "unknown-model":  # each registry lists its own models
        assert mine[1].startswith("\"model 'seq_nope'") and ref[1].startswith(
            "\"unknown model 'seq_nope'")
        return
    assert mine[1] == ref[1]


def test_cr_parameter_types_parse_alike(tmp_path):
    cr = {"metadata": {"name": "g"}, "spec": {"predictors": [{"graph": {
        "name": "cal", "type": "output_transformer", "implementation": "platt",
        "config": {"c": 1},
        "parameters": [
            {"name": "a", "value": "2.5", "type": "FLOAT"},
            {"name": "b", "value": "-1", "type": "INT"},
            {"name": "d", "value": "0.25", "type": "DOUBLE"},
            {"name": "on", "value": "Yes", "type": "BOOL"},
            {"name": "off", "value": "0", "type": "BOOL"},
            {"name": "w", "value": "[1, 2]", "type": "JSON"},
            {"name": "j", "value": {"k": 1}, "type": "JSON"},
            {"name": "s", "value": "text"},
        ],
        "children": [{"name": "modelfull"}],
    }}]}}
    path = tmp_path / "g.json"
    path.write_text(json.dumps(cr))
    mine, ref = graph.InferenceGraph.from_cr_file(str(path)), \
        jax_graph.InferenceGraph.from_cr_file(str(path))
    assert mine.name == ref.name == "g"
    assert mine.root == graph.Node(**{f: getattr(ref.root, f) for f in (
        "name", "type", "implementation", "config")},
        children=(graph.Node("modelfull", "MODEL"),))
    assert dict(mine.root.config) == {"c": 1, "a": 2.5, "b": -1, "d": 0.25, "on": True,
                                      "off": False, "w": [1, 2], "j": {"k": 1}, "s": "text"}
    bare = graph.InferenceGraph.from_cr(cr["spec"]["predictors"][0]["graph"])
    assert bare.name == "cal" == jax_graph.InferenceGraph.from_cr(
        cr["spec"]["predictors"][0]["graph"]).name


def test_a_graph_cannot_take_a_built_in_models_name():
    for name in ("mlp", "modelfull", "gbt"):
        ref, mine = _raises(lambda g, k, n=name: g.InferenceGraph(
            g.Node(n, "MODEL")).as_model_spec())
        assert mine == ref and "collides with a registered model" in mine[1]
    # re-registering a graph's own name (a CR reload) is allowed
    g = graph.InferenceGraph(graph.Node("modelfull", "MODEL"), name="reloadable")
    g.as_model_spec()
    assert g.as_model_spec().name == "reloadable"


HASH_WEIGHTS = ([0.9, 0.1], [0.5, 0.5], [0.6, 0.3, 0.1])


def test_hash_split_arms_equal_the_references():
    """On the reference test's rows and weights (tests/test_graph.py::
    test_hash_split_numpy_mirror_matches_compiled_router: 4,096 normal rows
    a weight set from default_rng(0)): the port's router, its numpy mirror,
    the reference's compiled router and its numpy mirror give every row the
    same arm."""
    rng = np.random.default_rng(0)
    for weights in HASH_WEIGHTS:
        x = rng.normal(size=(4096, 30)).astype(np.float32)
        ref_p = jax_graph._hash_split_init(None, {"weights": weights})
        compiled = np.asarray(jax.jit(
            lambda pp, xx: jax_graph._hash_split_weights(pp, xx, {}))(ref_p, jnp.asarray(x)))
        want = compiled.argmax(axis=1)
        np.testing.assert_array_equal(jax_graph.hash_split_arms_numpy(x, weights), want)
        my_p = graph._hash_split_init(None, {"weights": weights})
        onehot = graph._hash_split_weights(my_p, torch.from_numpy(x), {}).numpy()
        np.testing.assert_array_equal(onehot, compiled)
        np.testing.assert_array_equal(graph.hash_split_arms_numpy(x, weights), want)
        assert len(np.unique(want)) == len(weights)


def test_hash_split_arms_on_kaggle_scale_rows_differ_only_at_a_boundary():
    """On Kaggle-scale rows the reference's compiled router and its numpy
    mirror themselves differ on ~1% of rows; the port's router and mirror
    differ from each and from each other only where u lies within
    HASH_SPLIT_MARGIN_ULPS of a boundary."""
    x = kaggle_surrogate(n=4096, seed=17).X
    for weights in HASH_WEIGHTS:
        ref_p = jax_graph._hash_split_init(None, {"weights": weights})
        compiled = np.asarray(jax.jit(
            lambda pp, xx: jax_graph._hash_split_weights(pp, xx, {}))(
                ref_p, jnp.asarray(x))).argmax(axis=1)
        arms = [compiled, jax_graph.hash_split_arms_numpy(x, weights),
                graph.hash_split_arms(torch.from_numpy(x), graph._hash_split_init(
                    None, {"weights": weights})["cum"]).numpy(),
                graph.hash_split_arms_numpy(x, weights)]
        np.testing.assert_array_equal(arms[3], arms[1])  # the same numpy code
        for i in range(len(arms)):
            for j in range(i):
                _assert_arms_agree(arms[i], arms[j], x, weights)


def test_scorer_serves_a_graph_and_swaps_one_node(rows):
    ref_spec = jax_graph.load_graph_cr(str(CR))
    spec = graph.load_graph_cr(str(CR))
    assert spec.name == ref_spec.name == "ccfd-ensemble"
    ref_p = _np(ref_spec.init(jax.random.PRNGKey(5)))
    kw = dict(batch_sizes=(16, 64), compute_dtype="float32")
    ref = JaxScorer(model_name=spec.name, params=ref_p, use_fused=False, host_tier_rows=0,
                    **kw)
    mine = Scorer(model_name=spec.name, params=from_jax_model_params(spec.name, ref_p),
                  device="cpu", **kw)
    grid = mine.executable_grid()
    assert grid["model"] == "ccfd-ensemble" and not grid["fused"] and not grid["int8_wire"]
    assert not mine.has_host_forward
    x = rows[:37]  # not a bucket: padded
    np.testing.assert_allclose(mine.score(x), ref.score(x), rtol=0, atol=1e-6)
    # a retrain hot-swaps one node's weights; the rest of the tree stays
    new = copy.deepcopy(ref_p)
    new["modelfull"]["w"] = new["modelfull"]["w"] * -40.0
    ref.swap_params(new)
    before = mine.params["mlp"]["layers"][0]["w"]
    mine.swap_params(from_jax_model_params(spec.name, new))
    got = mine.score(x)
    np.testing.assert_allclose(got, ref.score(x), rtol=0, atol=1e-6)
    assert np.abs(got - Scorer(model_name=spec.name, params=from_jax_model_params(
        spec.name, ref_p), device="cpu", **kw).score(x)).max() > 0.01
    assert torch.equal(mine.params["mlp"]["layers"][0]["w"], before)
    assert to_numpy(mine.params)["modelfull"]["w"].tolist() == new["modelfull"]["w"].tolist()
    assert mine.executable_grid()["dispatches"] == {"64": 2}
