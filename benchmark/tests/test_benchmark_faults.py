"""A whole run of each REST cell on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath: the control (the reference one
precision step below) in the scorer's place, an answer altered where the
scorer produces it, half of each dispatch's answers left out, and a card
that serves nothing. Each must read ``correct: false``; the sound run
``correct: true``. A REST request's answer is its reply: a reply short of
rows is a failed request (the front answers 500), so half the answers left
out fails ``failed_share``. No cell has a training step or an exchange
between chips. Also: without a card, and alone in a directory, the command
exits non-zero and prints no result."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark.harness import runner, spec

BENCH = spec.load_benchmark()
# the cells at a size the CPU runs in seconds
SMALL = {"clients": 2, "requests_per_client": 32, "pool_rows": 2048, "warmup_s": 0.5}
# the control's widest gap grows with the rows compared: at a pool of 2,048
# rows it can stay under the bf16 limit, at 8,192 it does not (PERF.md)
CONTROL_SIZE = {"clients": 4, "requests_per_client": 128, "pool_rows": 8192, "warmup_s": 0.5}
# the cells of mix kind closed_loop_rest (the keyed stream's are
# test_benchmark_stream.py's)
CELLS = [w["name"] for w in BENCH["workloads"]
         if spec.resolve(BENCH, w["name"]).mix["kind"] == "closed_loop_rest"]


def _run(cell_name: str, trace: bool = False, size: dict = SMALL,
         seconds: float = 2.0) -> dict:
    cell = spec.resolve(BENCH, cell_name)
    cell.mix.update(size)
    return runner.run_cell(cell, 2 ** 31 + 17, seconds, trace, "cpu", time.perf_counter())


@pytest.fixture
def alter_answer(monkeypatch):
    """The scorer hands back 1 - p on the first row of every dispatch."""
    from ccfd_tpu_torch.serving.scorer import Scorer

    orig = Scorer._collect

    def collect(self, pending):
        out = orig(self, pending)
        if len(out):
            out[0] = 1.0 - out[0]
        return out

    monkeypatch.setattr(Scorer, "_collect", collect)


@pytest.fixture
def drop_half(monkeypatch):
    """The scorer hands back the answers of the first half of every
    dispatch's rows only."""
    from ccfd_tpu_torch.serving.scorer import Scorer

    orig = Scorer._collect

    def collect(self, pending):
        out = orig(self, pending)
        return out[:max(1, len(out) // 2)]

    monkeypatch.setattr(Scorer, "_collect", collect)


@pytest.fixture
def serve_nothing(monkeypatch):
    """Every dispatch of the scorer fails: the front answers 500."""
    from ccfd_tpu_torch.serving.scorer import Scorer

    def score(self, x, depth=2):
        raise RuntimeError("planted: the card serves nothing")

    monkeypatch.setattr(Scorer, "score_pipelined", score)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["failed_share"]["value"] == 0.0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_host_layers(cell):
    """On the CPU the device trace holds nothing; the counters still read."""
    res = _run(cell, trace=True)
    assert res["correct"], res["checks"]
    host = {"front.rows_per_dispatch.rest", "front.rows_per_s.rest"}
    want = {m["name"] for m in spec.resolve(BENCH, cell).per_layer} & host
    assert want and want <= set(res["metrics"])
    assert res["breakdown"]["device_ops"] == [] and res["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(cell):
    """The reference one precision step below (int8 for bf16, int4 for
    int8) answers in the scorer's place; the harness's own judge reads it."""
    from benchmark import control

    c = spec.resolve(BENCH, cell)
    with control.in_place(c.config):
        res = _run(cell, size=CONTROL_SIZE, seconds=3.0)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert not res["correct"]
    assert res["checks"]["p_gap"]["value"] > res["checks"]["p_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_card_that_serves_nothing_is_not_correct(cell, serve_nothing):
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["failed_share"]["value"] == 1.0 > res["checks"]["failed_share"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(cell, alter_answer):
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["p_gap"]["value"] > res["checks"]["p_gap"]["limit"]


# the front's scoring thread raises on the short answer: that is the fault
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("cell", CELLS)
def test_half_the_answers_left_out_is_not_correct(cell, drop_half):
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["failed_share"]["value"] > res["checks"]["failed_share"]["limit"]


def test_without_a_card_the_command_prints_no_result(tmp_path):
    """Here the CPU build of torch has no CUDA device."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the refusal path is the CPU's")
    cmd = [sys.executable, "benchmark/run.py", "--workload", "mlp_bf16.rest16", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    r = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_alone_in_a_directory_the_command_prints_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, "benchmark/run.py", "--workload", "mlp_bf16.rest16", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct():
    """On the card: one short run of the REST cell, from the command."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, "benchmark/run.py", "--workload", "mlp_bf16.rest16", "--seed", "3",
           "--seconds", "2", "--trace", "0"]
    r = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    import json

    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert np.isfinite(res["metrics"]["device_ms_per_1k_rows"]["value"])
    assert res["metrics"]["device_ms_per_1k_rows"]["value"] > 0
