"""The port's model-aware entry points (cli.py) on the CPU: ``score``
against the reference's ``cmd_score`` (its JSON line and its output file),
``serve`` of a CCFD_GRAPH_CR graph and of ``CCFD_MODEL=gbt --gbt-dir``
answering a POST as the reference's Scorer, ``train --family hgb``, and
the router role's Scorer for a non-MLP model."""

import contextlib
import http.client
import io
import json
import pathlib
import shutil

import jax
import numpy as np
import pytest
import torch

from ccfd_tpu import cli as ref_cli
from ccfd_tpu.cli import _restore_gbt_params
from ccfd_tpu.serving.graph import load_graph_cr as jax_load_graph_cr
from ccfd_tpu.serving.scorer import Scorer as JaxScorer
from ccfd_tpu_torch.cli import build_parser, build_router, build_server, main, served_params
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.models.mlp import init as mlp_init
from ccfd_tpu_torch.ops.quant import quantize_mlp
from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
from ccfd_tpu_torch.params import flatten, from_jax_model_params, to_numpy

REPO = pathlib.Path(__file__).resolve().parents[1]
CR = REPO / "deploy" / "model" / "graph_ensemble.json"
GBT_DIR = REPO / "checkpoints_gbt"
BUCKETS = "16,1024"
SCORE_KEYS = ["rows", "seconds", "tx_s", "flagged_fraud", "fraud_threshold", "mean_proba",
              "output", "checkpoint"]


def _csv(path: pathlib.Path, x: np.ndarray) -> str:
    with open(path, "w") as f:
        f.write(",".join(FEATURE_NAMES + ("Class",)) + "\n")
        for row in x:
            f.write(",".join(repr(float(v)) for v in row) + ",0\n")
    return str(path)


def _json_line(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def csv_rows(tmp_path_factory):
    x = kaggle_surrogate(n=3000, seed=21).X
    return x, _csv(tmp_path_factory.mktemp("csv") / "rows.csv", x)


@pytest.mark.parametrize("model", ["mlp", "gbt", "gbt_mxu-empty", "mlp-no-rows"])
def test_score_matches_the_references_json_line_and_file(tmp_path, monkeypatch, csv_rows,
                                                          model):
    """The committed MLP checkpoint (the reference's orbax step_1200) and
    the committed tree artifact, read by each package from its own default
    place; gbt_mxu with no params (the reference's empty init); a 0-row
    CSV (mean_proba null). The MLP scores in float32: in bf16 the port
    scores through B1's folded normalizer, as the reference's Pallas kernel
    does on its accelerator, where the reference's CPU path runs the
    unfolded XLA graph (B1 against the reference's kernel:
    test_torch_scorer.py)."""
    x, csv = csv_rows
    if model == "mlp-no-rows":
        csv = _csv(tmp_path / "empty.csv", x[:0])
    monkeypatch.setenv("CCFD_MODEL", model.split("-")[0])
    monkeypatch.setenv("CCFD_DTYPE", "float32")
    monkeypatch.setenv("CCFD_BATCH_SIZES", BUCKETS)
    ref = _json_line(ref_cli.main, ["score", "--input", csv, "--output",
                                    str(tmp_path / "ref.csv"), "--checkpoint-dir",
                                    str(REPO / "checkpoints"), "--gbt-dir", str(GBT_DIR)])
    got = _json_line(main, ["score", "--input", csv, "--output", str(tmp_path / "port.csv"),
                            "--checkpoint-dir", str(tmp_path / "none"),
                            "--gbt-dir", str(GBT_DIR), "--device", "cpu"])
    assert list(got) == list(ref) == SCORE_KEYS
    assert got["output"] == str(tmp_path / "port.csv")
    for k in ("rows", "flagged_fraud", "fraud_threshold", "checkpoint"):
        assert got[k] == ref[k], k
    assert got["checkpoint"] is (model.split("-")[0] in ("mlp", "gbt"))
    assert got["tx_s"] >= 0 and got["seconds"] >= 0
    lines = [(tmp_path / f).read_text().splitlines() for f in ("port.csv", "ref.csv")]
    assert lines[0][0] == lines[1][0] == "proba_1"
    p, p_ref = (np.array([float(v) for v in ls[1:] if v], np.float64) for ls in lines)
    assert len(p) == len(p_ref) == got["rows"]
    if model == "mlp-no-rows":
        assert got["mean_proba"] is None is ref["mean_proba"] and got["rows"] == 0
        return
    np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-5)
    assert abs(got["mean_proba"] - ref["mean_proba"]) <= 1e-5
    assert p.std() > 1e-3 or model == "gbt_mxu-empty"


def test_score_serves_the_graph_cr_as_the_reference(tmp_path, monkeypatch, csv_rows):
    _x, csv = csv_rows
    monkeypatch.setenv("CCFD_GRAPH_CR", str(CR))
    monkeypatch.setenv("CCFD_BATCH_SIZES", BUCKETS)
    ref = _json_line(ref_cli.main, ["score", "--input", csv])
    got = _json_line(main, ["score", "--input", csv, "--device", "cpu"])
    assert list(got) == list(ref)
    assert (got["rows"], got["checkpoint"], got["output"]) == (ref["rows"], False, None)
    assert 0.0 < got["mean_proba"] < 1.0


def _post(port: int, x: np.ndarray) -> np.ndarray:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/api/v0.1/predictions",
                     json.dumps({"data": {"ndarray": x.tolist()}}))
        resp = conn.getresponse()
        assert resp.status == 200
        return np.asarray(json.loads(resp.read())["data"]["ndarray"])[:, 1]
    finally:
        conn.close()


@pytest.mark.parametrize("case", ["graph", "gbt"])
def test_serve_answers_as_the_references_scorer(tmp_path, case):
    """``serve`` (``build_server``, what the command runs, on its default
    front) with CCFD_GRAPH_CR, and with CCFD_MODEL=gbt and --gbt-dir: a
    POST of 16 rows equal to the reference's Scorer on the same params."""
    x = kaggle_surrogate(n=16, seed=23).X
    kw = dict(batch_sizes=(16, 64), compute_dtype="float32")
    if case == "graph":
        cfg = Config.from_env({"CCFD_GRAPH_CR": str(CR), "CCFD_DTYPE": "float32",
                               "CCFD_BATCH_SIZES": "16,64"})
        spec = jax_load_graph_cr(str(CR))
        ref_p = jax.tree.map(np.asarray, spec.init(jax.random.PRNGKey(9)))
        srv = build_server(cfg, device="cpu", params=from_jax_model_params(spec.name, ref_p))
        ref = JaxScorer(model_name=spec.name, params=ref_p, use_fused=False,
                        host_tier_rows=0, **kw)
    else:
        gbt_dir = tmp_path / "trees"
        shutil.copytree(GBT_DIR, gbt_dir)
        args = build_parser().parse_args(["serve", "--device", "cpu", "--gbt-dir",
                                          str(gbt_dir)])
        cfg = Config.from_env({"CCFD_MODEL": "gbt", "CCFD_DTYPE": "float32",
                               "CCFD_BATCH_SIZES": "16,64"})
        srv = build_server(cfg, device=args.device, gbt_dir=args.gbt_dir)
        ref = JaxScorer(model_name="gbt", params=_restore_gbt_params(str(gbt_dir)),
                        use_fused=False, host_tier_rows=0, **kw)
    assert srv.scorer.spec.name == ref.spec.name and not srv.scorer.fused
    port = srv.start("127.0.0.1", 0)
    try:
        got = _post(port, x)
    finally:
        srv.stop()
    np.testing.assert_allclose(got, ref.score(x), rtol=0, atol=1e-5)
    assert srv.scorer.dispatch_total() == 1


def test_serve_train_with_a_graph_and_train_hgb_exit_2(monkeypatch, capsys):
    monkeypatch.setenv("CCFD_GRAPH_CR", str(CR))
    assert main(["serve", "--device", "cpu", "--train"]) == 2
    assert "graph-shaped params" in capsys.readouterr().err
    monkeypatch.delenv("CCFD_GRAPH_CR")
    assert main(["train", "--device", "cpu", "--family", "hgb"]) == 2
    assert "--family hgb needs scikit-learn" in capsys.readouterr().err


def test_served_params_follow_the_model(tmp_path):
    """Each model gets its own params: the MLP family its checkpoint, gbt
    the tree artifact, the rest (and graphs) the Scorer's seeded init; the
    MLP checkpoint is never handed to another model."""
    mlp = served_params(Config(model_name="mlp"))
    assert set(mlp) == {"norm", "layers"}
    assert "wq" in served_params(Config(model_name="mlp_q8"))["layers"][0]
    # score --quantized-dir: the newest int8 step there
    q8 = quantize_mlp(mlp_init(torch.Generator().manual_seed(4)))
    CheckpointManager(str(tmp_path / "q8")).save(7, q8)
    got = served_params(Config(model_name="mlp_q8"), quantized_dir=str(tmp_path / "q8"))
    for k, v in flatten(q8).items():
        np.testing.assert_array_equal(flatten(got)[k], v)
    gbt = served_params(Config(model_name="gbt"), gbt_dir=str(GBT_DIR))
    ref = _restore_gbt_params(str(GBT_DIR))
    for k, v in to_numpy(gbt).items():
        np.testing.assert_array_equal(v, np.asarray(ref[k]))
    assert served_params(Config(model_name="gbt"), gbt_dir=str(tmp_path)) is None
    for name in ("logreg", "modelfull", "gbt_mxu", "ccfd-ensemble"):
        assert served_params(Config(model_name=name)) is None, name
    with pytest.raises(ValueError, match="--params holds MLP"):
        served_params(Config(model_name="gbt"), params_path=str(tmp_path / "p.npz"))


def test_router_role_scores_its_model_without_the_cr(monkeypatch):
    """The router role's Scorer serves CCFD_MODEL=modelfull with logreg
    params (as the reference's role builds ``Scorer(model_name=
    CCFD_MODEL)``) and does not load CCFD_GRAPH_CR."""
    cfg = Config.from_env({"KIE_SERVER_URL": "http://127.0.0.1:1", "CCFD_MODEL": "modelfull",
                           "CCFD_GRAPH_CR": str(CR), "CCFD_BATCH_SIZES": "16",
                           "CCFD_OVERLOAD": "0"})
    router, _registry, _sink, _collectors = build_router(cfg, device="cpu", workers=1)
    try:
        scorer = router.score.__self__
        assert scorer.spec.name == "modelfull"
        assert {k: tuple(v.shape) for k, v in scorer.params.items()} == {"w": (30,), "b": ()}
        x = kaggle_surrogate(n=16, seed=29).X
        ref = JaxScorer(model_name="modelfull", params=to_numpy(scorer.params),
                        batch_sizes=(16,), use_fused=False, host_tier_rows=0)
        np.testing.assert_allclose(router.score(x), ref.score(x), rtol=0, atol=1e-5)
        np.testing.assert_allclose(router._host_score(x), ref.score(x), rtol=0, atol=1e-5)
    finally:
        router.close()
