"""The port's training commands (cli.py) on the CPU: ``train`` against the
reference's ``cmd_train`` output, the checkpoint round trip into ``serve``
(``build_server``) and ``quantize``, ``serve --train``, the demo with its
online trainer, and the refusals of what is not ported."""

import contextlib
import dataclasses
import io
import json
import os

import pytest
import torch

from ccfd_tpu import cli as ref_cli
from ccfd_tpu_torch import cli
from ccfd_tpu_torch.cli import build_pipeline, build_server, main
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import synthetic_dataset
from ccfd_tpu_torch.ops import quant
from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
from ccfd_tpu_torch.params import DEFAULT_PARAMS, MLP_LIKE, load_params

ROWS = "2000"
TRAIN_KEYS = {"checkpoint", "rows", "steps", "source", "test_rows", "auc_mlp",
              "auc_sklearn_logreg"}


def _equal(a: dict, b: dict) -> bool:
    pairs = [(a["norm"][k], b["norm"][k]) for k in a["norm"]] + [
        (la[k], lb[k]) for la, lb in zip(a["layers"], b["layers"]) for k in la]
    return len(a["layers"]) == len(b["layers"]) and all(
        torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()) for x, y in pairs)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --device cpu --steps 5`` on a 2,000-row surrogate: (JSON, dir)."""
    ck = tmp_path_factory.mktemp("ck")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setenv("CCFD_SURROGATE_ROWS", ROWS)
        assert main(["train", "--device", "cpu", "--steps", "5",
                     "--checkpoint-dir", str(ck)]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), str(ck)


def test_train_prints_the_references_keys(trained, tmp_path, monkeypatch, capsys):
    doc, ck = trained
    assert set(doc) == TRAIN_KEYS
    assert doc["auc_sklearn_logreg"] is None
    assert doc["rows"] == int(ROWS) and doc["steps"] == 5 and doc["test_rows"] == 400
    assert doc["source"] == f"surrogate:v1:n={ROWS}"
    assert 0.5 < doc["auc_mlp"] <= 1.0
    assert doc["checkpoint"] == os.path.join(ck, "step_5")
    assert sorted(os.listdir(doc["checkpoint"])) == ["params.npz", "treedef.json"]
    # the reference's command prints the same keys for the same data
    monkeypatch.setenv("CCFD_SURROGATE_ROWS", ROWS)
    assert ref_cli.main(["train", "--steps", "2", "--checkpoint-dir", str(tmp_path)]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ref) == TRAIN_KEYS
    assert (ref["rows"], ref["test_rows"], ref["source"]) == (
        doc["rows"], doc["test_rows"], doc["source"])


def test_serve_serves_the_newest_train_step(trained, tmp_path):
    _doc, ck = trained
    step, _ = CheckpointManager(ck).restore(MLP_LIKE)
    srv = build_server(Config(), device="cpu", checkpoint_dir=ck)
    assert _equal(srv.scorer.params, step)
    assert not _equal(srv.scorer.params, load_params(DEFAULT_PARAMS))
    # --params wins over the directory; a missing directory keeps the
    # committed checkpoint and is not created
    srv = build_server(Config(), device="cpu", params_path=str(DEFAULT_PARAMS),
                       checkpoint_dir=ck)
    assert _equal(srv.scorer.params, load_params(DEFAULT_PARAMS))
    missing = tmp_path / "none"
    srv = build_server(Config(), device="cpu", checkpoint_dir=str(missing))
    assert _equal(srv.scorer.params, load_params(DEFAULT_PARAMS)) and not missing.exists()


def test_quantize_reads_the_newest_train_step(trained, tmp_path, monkeypatch, capsys):
    _doc, ck = trained
    monkeypatch.setenv("CCFD_SURROGATE_ROWS", ROWS)
    out = tmp_path / "q8.npz"
    assert main(["quantize", "--device", "cpu", "--checkpoint-dir", ck,
                 "--out", str(out)]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["source_step"] == 5 and doc["source"] == os.path.join(ck, "step_5")
    assert doc["max_prob_delta"] < 0.1
    step, _ = CheckpointManager(ck).restore(MLP_LIKE)
    assert _equal(load_params(out), quant.quantize_mlp(step))
    # train -> quantize -> CCFD_MODEL=mlp_q8 serve
    srv = build_server(Config(model_name="mlp_q8"), device="cpu", params_path=str(out))
    assert srv.scorer.spec.name == "mlp_q8" and _equal(srv.scorer.params, load_params(out))


def test_serve_train_serves_the_params_it_trained(monkeypatch):
    """``serve --train`` as ``cmd_serve`` wires it: ``train_mlp`` on the
    dataset, then ``build_server(params=...)``."""
    ds = synthetic_dataset(n=512, seed=4)
    params = cli.train_mlp(ds.X, ds.y, 5, "cpu")
    srv = build_server(Config(), device="cpu", params=params)
    assert _equal(srv.scorer.params, params)
    with pytest.raises(SystemExit):  # --train and --params name two sources
        main(["serve", "--device", "cpu", "--train", "--params", str(DEFAULT_PARAMS)])
    monkeypatch.setenv("CCFD_MODEL", "mlp_q8")
    assert main(["serve", "--device", "cpu", "--train"]) == 2  # as the reference


def test_unported_training_parts_are_refused_by_name(tmp_path, monkeypatch):
    # the tree family needs scikit-learn: exit 2, as the reference without it
    assert main(["train", "--device", "cpu", "--family", "hgb",
                 "--checkpoint-dir", str(tmp_path)]) == 2
    # --from-store is served since A14b: with no store at its endpoint it
    # fails before anything trains or is written
    with pytest.raises(OSError):
        main(["train", "--device", "cpu", "--from-store", "--store-url", "http://127.0.0.1:1",
              "--checkpoint-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    # the lifecycle's lineage store is ported (A12): a knob still refused
    # stands beside it, and the refusal comes before anything is written
    env = {"CCFD_LIFECYCLE_DIR": str(tmp_path / "lc"), "CCFD_HOST_TIER_ROWS": "64"}
    cfg = Config.from_env(env)
    with pytest.raises(NotImplementedError, match="CCFD_HOST_TIER_ROWS"):
        build_pipeline(cfg, synthetic_dataset(n=64), device="cpu",
                       params=load_params(DEFAULT_PARAMS))
    with pytest.raises(NotImplementedError, match="CCFD_HOST_TIER_ROWS"):
        build_server(cfg, device="cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="CCFD_HOST_TIER_ROWS"):
        main(["demo", "--device", "cpu", "--transactions", "10"])
    assert not (tmp_path / "lc").exists()


def test_train_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CCFD_SURROGATE_ROWS", "500")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "--steps", "1", "--checkpoint-dir", str(tmp_path)])


def test_demo_trains_and_reports_retrain_swaps(capsys):
    assert main(["demo", "--device", "cpu", "--transactions", "300", "--train-steps", "5",
                 "--reply-timeout", "0.2", "--drain-s", "20"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert isinstance(doc["retrain_swaps"], int)
    assert doc["transactions"] == 300 and doc["backend"] == "cpu"


def test_demo_hot_swaps_retrained_params_while_routing(monkeypatch):
    """The demo's trained path with the trainer's bar lowered: labels from
    resolved fraud cases are trained on and published while the router
    routes; the Scorer ends serving the trainer's last published params."""
    cfg = dataclasses.replace(Config.from_env({"CCFD_RETRAIN_MIN_LABELS": "4"}),
                              customer_reply_timeout_s=0.5)
    pipe = cli.build_demo(cfg, 2000, train_steps=50, device="cpu", seed=1)
    assert pipe.trainer is not None
    cli.run_demo(pipe, 2000, drain_s=30)
    summary = pipe.summary()
    assert summary["transactions"] == 2000
    assert summary["fraud_routed"] + summary["standard_routed"] == 2000
    assert summary["retrain_swaps"] >= 1, summary
    assert _equal(pipe.scorer.params, pipe.trainer.params)
    steps = pipe.reg_retrain.counter("retrain_steps_total").value()
    assert steps == 8 * summary["retrain_swaps"]
    pipe.trainer.close()
