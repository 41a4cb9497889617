"""What a user of the reference gets from the port: the same command lines,
the same int8 lifecycle, and the same platform where the reference's
operator degrades a CR instead of failing.

- **The command lines.** The reference's parser (``ccfd_tpu.cli.main``,
  caught at ``parse_args``) against the port's ``build_parser()``: every
  subcommand and flag of the reference is the port's, and every default is
  equal or in ``DIFFERENT_DEFAULTS`` with its reason.
- **The int8 lifecycle.** ``train`` (a checkpoint step) -> ``quantize
  --out-dir`` -> ``CCFD_MODEL=mlp_q8 serve --quantized-dir``, and the same
  with the default directory in a fresh working directory: ``serve``
  serves exactly the quantized step (``params_fingerprint``); its p lies
  within 1e-5 of the reference's ``quant.apply_numpy`` on the same f32
  params and equals the port's plain B3 bit for bit. With no step there,
  the committed checkpoint quantized.
- **The operator's degradations**, each on the same CR as the reference's
  ``Platform`` on the CPU: retrain under a seq scorer skipped; the
  decision plane with a seq scorer, without an in-process scorer, with the
  lifecycle and over a mesh serving the staged path; ``CCFD_GRAPH_CR``
  not read. The same services, no decision plane on either side, and the
  same routes and counters over 300 seeded transactions.
  ``scorer.fused_decision_strict`` raises the reference's message on both
  sides, and the port starts nothing.
- **The mesh clamp.** ``resolve_mesh_shape`` against the reference's
  ``_up_mesh`` over a grid of (devices, visible devices, fsdp, tp,
  seq_parallel) on the tests' 8 virtual CPU devices: the same served shape
  and the same warnings.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.platform.operator import Platform as RefPlatform
from ccfd_tpu.platform.operator import PlatformSpec as RefSpec
from ccfd_tpu_torch import cli
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec, resolve_mesh_shape
from tests import torch_helpers
from tests.test_platform import minimal_cr
from tests.test_torch_platform import OFF, _seeded_logreg, _serving, _settle

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)

# (subcommand, flag) -> (the port's default, why it differs from the reference's)
DIFFERENT_DEFAULTS = {
    **{(cmd, "--checkpoint-dir"): (
        cli.DEFAULT_CHECKPOINT_DIR,
        "the reference's ./checkpoints holds orbax steps the port does not read")
       for cmd in ("train", "serve", "quantize", "score", "doctor")},
    **{(cmd, "--quantized-dir"): (
        cli.Q8_DIR, "the reference's ./checkpoints_q8 holds an orbax step the port "
        "does not read") for cmd in ("serve", "score", "doctor")},
    ("quantize", "--out-dir"): (
        None, "bare, the port writes ./checkpoints_q8_torch; with --out alone it "
        "writes that file and no step"),
    ("up", "--file"): (cli.PORT_CR, "the port's CR, the reference's with the port's "
                       "paths; the reference's path is relative to its checkout"),
    ("manifests", "--file"): (cli.PORT_CR, "the same CR as up"),
    ("manifests", "--out"): (None, "required: the reference writes into its own "
                             "deploy/k8s, which the port leaves as it is"),
    ("serve", "--host"): (None, "resolved from CCFD_SERVE_HOST (default 0.0.0.0)"),
    ("serve", "--port"): (None, "resolved from CCFD_SERVE_PORT (default 8000)"),
}


def _subparsers(parser: argparse.ArgumentParser, prefix: str = "") -> dict:
    """{"cmd" or "cmd action": parser} of every (nested) subcommand."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                key = f"{prefix}{name}"
                out[key] = sub
                out.update(_subparsers(sub, key + " "))
    return out


def _flags(parser: argparse.ArgumentParser) -> dict:
    """{the longest option string, or a positional's dest: its default}."""
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        out[max(a.option_strings, key=len) if a.option_strings else a.dest] = a.default
    return out


def _reference_parser() -> argparse.ArgumentParser:
    from ccfd_tpu import cli as ref_cli

    class Built(Exception):
        pass

    got = {}

    def catch(self, args=None, namespace=None):
        got["parser"] = self
        raise Built

    with pytest.MonkeyPatch.context() as mp, pytest.raises(Built):
        mp.setattr(argparse.ArgumentParser, "parse_args", catch)
        ref_cli.main([])  # no subcommand: main goes straight to its parser
    return got["parser"]


def test_every_flag_of_the_reference_is_the_ports():
    ref = _subparsers(_reference_parser())
    port = _subparsers(cli.build_parser())
    missing = sorted(set(ref) - set(port))
    assert missing == [], missing
    seen = set()
    for cmd, ref_parser in ref.items():
        ref_flags, port_flags = _flags(ref_parser), _flags(port[cmd])
        assert set(ref_flags) <= set(port_flags), (cmd, set(ref_flags) - set(port_flags))
        for flag, default in ref_flags.items():
            if (cmd, flag) in DIFFERENT_DEFAULTS:
                seen.add((cmd, flag))
                assert port_flags[flag] == DIFFERENT_DEFAULTS[cmd, flag][0], (cmd, flag)
                assert default != port_flags[flag], (cmd, flag)
            else:
                assert port_flags[flag] == default, (cmd, flag, default, port_flags[flag])
    assert seen == set(DIFFERENT_DEFAULTS)  # every named difference is still one


# -- the int8 lifecycle --------------------------------------------------------

ROWS = "3000"


@pytest.fixture(scope="module")
def f32_step(tmp_path_factory):
    """A `train` step of seeded f32 MLP params (the reference's pytree in
    numpy, and the checkpoint directory holding it as step 5)."""
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
    from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
    from ccfd_tpu_torch.params import from_jax_params

    X = kaggle_surrogate(n=2000).X
    tree = torch_helpers.mlp_tree(X, hidden=256, seed=3)
    ck = str(tmp_path_factory.mktemp("ck") / "checkpoints_torch")
    CheckpointManager(ck).save(5, from_jax_params(tree))
    return tree, ck, np.ascontiguousarray(X[:16], np.float32)


def _served_by_serve(argv: list[str]):
    """The server ``cmd_serve`` builds for ``argv`` (caught before it
    listens)."""
    calls = {}

    class Built(Exception):
        pass

    def record(cfg, **kw):
        calls.update(cfg=cfg, **kw)
        raise Built

    with pytest.MonkeyPatch.context() as mp, pytest.raises(Built):
        mp.setattr(cli, "build_server", record)
        cli.main(["serve", *argv])
    return cli.build_server(calls.pop("cfg"), **calls)


def _quantize(argv: list[str], capsys) -> dict:
    assert cli.main(["quantize", "--device", "cpu", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _check_serves_the_step(srv, qd: str, tree: dict, x: np.ndarray) -> None:
    from ccfd_tpu.ops import quant as ref_quant
    from ccfd_tpu_torch.ops import fused_mlp_q8
    from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
    from ccfd_tpu_torch.params import Q8_LIKE, params_fingerprint

    step, n = CheckpointManager(qd).restore(Q8_LIKE)
    assert n == 5
    assert params_fingerprint(srv.scorer.params) == params_fingerprint(step)
    assert srv.scorer.int8_wire and srv.scorer.spec.name == "mlp_q8"
    p = srv.scorer.score(x)
    ref_qp = jax.tree.map(np.asarray, ref_quant.quantize_mlp(tree))
    np.testing.assert_allclose(p, ref_quant.apply_numpy(ref_qp, x), rtol=0, atol=1e-5)
    kq = fused_mlp_q8.pack_for_kernel(fused_mlp_q8.fold_for_kernel(step), "cpu")
    q, s = fused_mlp_q8.prequantize_rows_numpy(
        {k: kq[k] for k in ("mu", "sigma")}, x)
    plain, _z = fused_mlp_q8.fused_mlp_q8_preq_reference(kq, torch.from_numpy(q),
                                                         torch.from_numpy(s))
    assert plain.float().numpy().tobytes() == p.tobytes()


def test_quantize_out_dir_then_serve_quantized_dir(f32_step, tmp_path, monkeypatch, capsys):
    tree, ck, x = f32_step
    monkeypatch.setenv("CCFD_SURROGATE_ROWS", ROWS)
    monkeypatch.delenv("CCFD_CSV", raising=False)
    qd = str(tmp_path / "q8")
    doc = _quantize(["--checkpoint-dir", ck, "--out-dir", qd], capsys)
    assert doc["source_step"] == 5 and doc["checkpoint"] == os.path.join(qd, "step_5")
    assert doc["out"] is None and doc["serve_with"].endswith(f"--quantized-dir {qd}")
    monkeypatch.setenv("CCFD_MODEL", "mlp_q8")
    monkeypatch.setenv("CCFD_BATCH_SIZES", "16,128")
    srv = _served_by_serve(["--device", "cpu", "--quantized-dir", qd])
    _check_serves_the_step(srv, qd, tree, x)


def test_the_default_directory_round_trips(f32_step, tmp_path, monkeypatch, capsys):
    """Run bare, as the reference's run-book does: ``quantize`` writes
    ./checkpoints_q8_torch and ``serve`` reads it; with no step there it
    serves the committed checkpoint quantized, as the reference's default
    directory serves the reference's committed step."""
    from ccfd_tpu_torch.ops import quant
    from ccfd_tpu_torch.params import load_params, params_fingerprint

    tree, ck, x = f32_step
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CCFD_SURROGATE_ROWS", ROWS)
    monkeypatch.delenv("CCFD_CSV", raising=False)
    monkeypatch.setenv("CCFD_MODEL", "mlp_q8")
    monkeypatch.setenv("CCFD_BATCH_SIZES", "16,128")
    srv = _served_by_serve(["--device", "cpu"])
    assert params_fingerprint(srv.scorer.params) == \
        params_fingerprint(quant.quantize_mlp(load_params()))
    doc = _quantize(["--checkpoint-dir", ck], capsys)
    assert doc["checkpoint"] == os.path.join(cli.Q8_DIR, "step_5")
    assert doc["serve_with"] == "CCFD_MODEL=mlp_q8 python -m ccfd_tpu_torch serve"
    _check_serves_the_step(_served_by_serve(["--device", "cpu"]),
                           cli.Q8_DIR, tree, x)


def test_train_takes_the_references_hgb_flags(capsys):
    args = cli.build_parser().parse_args(["train", "--family", "hgb", "--hgb-depth", "6",
                                          "--gbt-dir", "elsewhere"])
    assert (args.hgb_depth, args.gbt_dir) == (6, "elsewhere")
    assert cli.main(["train", "--device", "cpu", "--family", "hgb", "--hgb-depth", "6"]) == 2
    assert "[train] --family hgb needs scikit-learn" in capsys.readouterr().err


# -- the operator's degradations -------------------------------------------------

N = 300
ENV = {"CCFD_BATCH_SIZES": "16,128", "CCFD_NATIVE_FRONT": "0", "CCFD_SEQ_LEN_BUCKETS": "4"}
SEQ = {"history_length": 8, "dtype": "float32"}
# the three reasons the decision plane serves the staged path, in the
# reference's words
NO_ROW_SCORER = "remote and seq scorers have no fusable decision program"
LIFECYCLE = "incompatible with the lifecycle serving lane"
MESH = "mesh-sharded scorer: the decision program has no shard_map composition yet"


def _rows() -> list[dict]:
    """N seeded transactions of 17 customers (the seq family's histories)."""
    from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES, load_dataset

    X = load_dataset().X[:N]
    return [{**{f: float(v) for f, v in zip(FEATURE_NAMES, row)}, "id": i % 17}
            for i, row in enumerate(X)]


def _run(p, cfg_topic: str) -> dict:
    """What a platform came up with, and its counters once N rows settled."""
    out = {"services": set(p.status()["services"]),
           "decision_fn": p.fused_decision is not None,
           "lifecycle": p.lifecycle is not None,
           "mesh": p.mesh.size if p.mesh is not None else None}
    if p.router is not None and p.scorer is not None:
        rows = _rows()
        p.broker.produce_batch(cfg_topic, rows, [r["id"] for r in rows])
        out["counters"] = _settle(p)
    return out


def _both(blocks: dict, env: dict | None = None) -> tuple[dict, dict, list, list]:
    """The reference's Platform and the port's on one CR (the tests' minimal
    CR with ``blocks``; logreg serving the same seeded params on both
    sides, a one-partition bus): what each came up with, and its warnings."""
    from ccfd_tpu.models import registry as ref_registry
    from ccfd_tpu_torch.data.ccfd import load_dataset
    from ccfd_tpu_torch.models import registry as port_registry

    env = {**ENV, **(env or {})}
    w, b = _seeded_logreg(load_dataset().X[:N])
    cr = minimal_cr(**{**OFF, "bus": {"partitions": 1}, "tracing": {"json_logs": False},
                       **blocks})
    import jax.numpy as jnp

    with _serving(ref_registry, {"w": jnp.asarray(w), "b": jnp.asarray(b)}), \
            torch_helpers.warnings_of("ccfd_tpu.platform.operator", "ccfd_tpu.serving.fused") as ref_said:
        cfg = RefConfig.from_env(env)
        ref = RefPlatform(RefSpec.from_cr(cr, cfg=cfg)).up(wait_ready_s=60)
        try:
            ref_out = _run(ref, cfg.kafka_topic)
        finally:
            ref.down()
    with _serving(port_registry, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}), \
            torch_helpers.warnings_of("ccfd_tpu_torch.platform.operator",
                      "ccfd_tpu_torch.serving.fused") as port_said:
        cfg = Config.from_env(env)
        spec = PlatformSpec.from_cr(cr, cfg=cfg)
        assert spec.refused() == []
        port = Platform(spec, device="cpu").up(wait_ready_s=60)
        try:
            port_out = _run(port, cfg.kafka_topic)
        finally:
            port.down()
    return ref_out, port_out, ref_said, port_said


CASES = [
    # retrain under a seq scorer: skipped, no retrain service
    ("seq.retrain", {"scorer": {"enabled": True, "model": "seq", **SEQ},
                     "retrain": {"enabled": True}}, {}, "skipping retrain"),
    # the decision plane with a seq scorer: staged
    ("seq_q8.fused_decision", {"scorer": {"enabled": True, "model": "seq_q8",
                                          "fused_decision": True, **SEQ}}, {}, NO_ROW_SCORER),
    # without an in-process scorer (the router on SELDON_URL): staged
    ("remote.fused_decision", {"scorer": {"enabled": False, "fused_decision": True}},
     {"SELDON_URL": "http://127.0.0.1:9"}, NO_ROW_SCORER),
    # with the lifecycle: staged
    ("lifecycle.fused_decision", {"scorer": {"enabled": True, "model": "logreg",
                                             "fused_decision": True},
                                  "lifecycle": {"enabled": True}}, {}, LIFECYCLE),
    # over a mesh of two devices (the port: two logical CPU shards): the
    # plane declines the mesh scorer
    ("mesh.fused_decision", {"scorer": {"enabled": True, "model": "logreg",
                                        "fused_decision": True},
                             "mesh": {"devices": 2}}, {}, MESH),
    # CCFD_GRAPH_CR is not the operator's: scorer.model is served
    ("CCFD_GRAPH_CR", {"scorer": {"enabled": True, "model": "logreg"}},
     {"CCFD_GRAPH_CR": "deploy/model/graph_ensemble.json"}, None),
]


@pytest.mark.parametrize("blocks,env,warning", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_the_operator_degrades_as_the_references(blocks, env, warning):
    ref, port, ref_said, port_said = _both(blocks, env)
    assert port == ref
    assert not port["decision_fn"] and "retrain" not in port["services"]
    if "counters" in port:
        c = port["counters"]
        assert c["incoming"] == N == c["fraud"] + c["standard"] and not c["score_errors"]
    if warning is not None:
        assert any(warning in m for m in ref_said), ref_said
        assert any(warning in m for m in port_said), port_said


STRICT = [c for c in CASES if "fused_decision" in c[0]]


@pytest.mark.parametrize("blocks,env", [c[1:3] for c in STRICT], ids=[c[0] for c in STRICT])
def test_strict_raises_the_references_message(blocks, env):
    blocks = {**blocks, "scorer": {**blocks["scorer"], "fused_decision_strict": True}}
    cr = minimal_cr(**{**OFF, "bus": {"partitions": 1}, **blocks})
    ref = RefPlatform(RefSpec.from_cr(cr, cfg=RefConfig.from_env({**ENV, **env})))
    with pytest.raises(RuntimeError) as ref_err:
        ref.up(wait_ready_s=60)
    with contextlib.suppress(Exception):
        ref.down()
    port = Platform(PlatformSpec.from_cr(cr, cfg=Config.from_env({**ENV, **env})),
                    device="cpu")
    with pytest.raises(RuntimeError) as port_err:
        port.up(wait_ready_s=60)
    assert str(port_err.value) == str(ref_err.value)
    # nothing started: the check runs before the first component
    assert port.supervisor is None and port.scorer is None and port.broker is None


# -- the mesh clamp --------------------------------------------------------------

GRID_N = (0, 1, 2, 3, 4, 8, 16)
GRID_AXES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 3))


def _reference_mesh(n: int, avail: int, fsdp: int, tp: int, sp: str):
    """The reference operator's ``_up_mesh`` with ``avail`` of the 8 virtual
    CPU devices visible: (devices, axes, seq_parallel) or the error, and
    its warnings."""
    devices = jax.devices()
    spec = RefSpec.from_cr({"spec": {"mesh": {"devices": n, "fsdp": fsdp, "tp": tp,
                                              "seq_parallel": sp}}}, cfg=RefConfig())
    p = RefPlatform(spec)
    with torch_helpers.warnings_of("ccfd_tpu.platform.operator") as said, \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: devices[:avail])
        try:
            p._up_mesh(spec.component("mesh"))
            got = ((p.mesh.size, dict(p.mesh.shape)) if p.mesh is not None else (1, None),
                   p._mesh_seq_parallel)
        except ValueError:
            got = "error"
    return got, said


def _port_mesh(n: int, avail: int, fsdp: int, tp: int, sp: str):
    from ccfd_tpu_torch.parallel.mesh import make_named_mesh

    with torch_helpers.warnings_of("ccfd_tpu_torch.platform.operator") as said:
        n, fsdp, tp, sp = resolve_mesh_shape(n, avail, fsdp, tp, sp)
    if n <= 1:
        return ((1, None), sp), said
    try:
        mesh = make_named_mesh([torch.device("cpu")] * n, fsdp=fsdp, tp=tp)
    except ValueError:
        return "error", said
    return ((mesh.size, dict(mesh.shape)), sp), said


@pytest.mark.parametrize("avail", (1, 2, 4, 8))
@pytest.mark.parametrize("sp", ("none", "ring"))
def test_the_clamp_resolves_the_references_shape(avail, sp):
    for n in GRID_N:
        for fsdp, tp in GRID_AXES:
            ref, ref_said = _reference_mesh(n, avail, fsdp, tp, sp)
            port, port_said = _port_mesh(n, avail, fsdp, tp, sp)
            assert port == ref, (n, avail, fsdp, tp, sp)
            # the same warnings; the clamp's hint names each side's remedy
            assert [m.split(" (")[0] for m in port_said] == \
                [m.split(" (")[0] for m in ref_said], (n, avail, fsdp, tp, sp)
