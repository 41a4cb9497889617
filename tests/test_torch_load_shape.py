"""The traffic-shape harness on both pipelines: the reference's
(tools/load_shape.py) and the port's (tools/torch_load_shape.py, the
scorer on kernel B1's plain version on the CPU).

The short flash crowd (``seconds=6.0, slo_ms=1200.0, base_rate=4000.0,
p99_robust=True``, as tests/test_load_shape.py runs it) must hold every
invariant of tests/test_load_shape.py on each pipeline's result: zero
accounting violations and zero priority inversions, bulk shed hardest and
critical least (never by budget), the AIMD limit down under the latency
step and back up after, and the admitted p99 inside the SLO (or a
body-corroborated soft breach under host contention).

Each pipeline runs in a fresh interpreter, one after the other: a test
worker's process holds whatever threads its earlier test files left and
their interpreter lock would starve the regime's feeder, which is the
regime's input, not its subject.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(seconds=6.0, slo_ms=1200.0, base_rate=4000.0, p99_robust=True)


def _run_flash(tool: str, **extra) -> dict:
    """``<tool>.run_flash(**KW, **extra)`` in a fresh interpreter; its
    result dict."""
    code = (
        "import json, sys\n"
        # the port's CPU scorer on one intra-op thread, as every port test
        # runs (tests/torch_helpers.py): extra threads only oversubscribe
        # the cores the other test workers share
        + ("import torch\ntorch.set_num_threads(1)\n" if tool.startswith("torch_") else "")
        + f"sys.path.insert(0, {os.path.join(REPO, 'tools')!r})\n"
        + f"import {tool}\n"
        + f"res = {tool}.run_flash(**{KW!r}, **{extra!r})\n"
        + "print(json.dumps(res, default=str))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _holds_every_invariant(res: dict) -> None:
    assert res["violations"] == [], (res["violations"], res["counts"], res["limit_path"]
                                     if "limit_path" in res else res["limit_end"])
    assert res["drained"]
    assert res["counts"]["inversions"] == 0
    assert res["window_inversions"] == 0
    assert res["counts"]["shed"] > 0  # the crowd genuinely saturated
    assert res["counts"]["shed_by_priority_stage"]["critical:budget"] == 0
    f = res["shed_fraction_by_priority"]
    assert f["bulk"] >= f["normal"] >= f["critical"]
    assert res["limit_min"] < 8192
    assert res["limit_end"] > res["limit_min"]
    assert res["p99_ms"] is not None
    assert res["p99_ms"] <= 1200.0 or res["p99_soft_breach"], res
    assert res["p50_ms"] is not None and res["p50_ms"] <= 600.0, res
    c = res["counts"]
    assert c["incoming"] == (c["outgoing"] + c["shed"] + c["start_errors"] + c["score_err"])
    assert set(res["slo"]["stage_shares"]) == {"queue", "decode", "dispatch", "route"}


def test_flash_crowd_short_regime_holds_every_invariant_on_both_pipelines():
    ref = _run_flash("load_shape")
    port = _run_flash("torch_load_shape", device="cpu")
    for res in (ref, port):
        _holds_every_invariant(res)
    # the port's result keeps the reference's keys, and adds the AIMD
    # limit's path and one capacity document from the crowd
    assert set(ref) <= set(port)
    assert port["limit_path"]
    assert all(port["limit_min"] <= v <= port["limit_max"] for _t, v in port["limit_path"])
    assert port["scorer"]["kernel"] == "fused_mlp_bf16" and port["scorer"]["dispatches"] > 0
    assert port["capacity"].get("stages") is not None
