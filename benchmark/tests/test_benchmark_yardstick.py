"""The yardstick: roofline counts by hand, the reference on hand-worked
rows, the frozen surrogate, the generator, and the import rules."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest

from benchmark import roofline
from benchmark.harness import runner, spec
from benchmark.reference import mlp
from benchmark.traffic import generator, surrogate

BENCH = spec.load_benchmark()
CONFIGS = {c["name"]: spec.resolve(BENCH, next(w["name"] for w in BENCH["workloads"]
                                                if w["config"] == c["name"])).config
           for c in BENCH["configs"]}


@pytest.mark.parametrize("n", [16, 16384])
def test_roofline_counts_by_hand(n):
    bf16, q8 = CONFIGS["mlp_bf16"], CONFIGS["mlp_q8"]
    # 30*256 + 256*256 + 256 = 73,472 weights: 146,944 operations a row
    assert roofline.ops_per_row(bf16) == 146_944
    # bf16: 73,472 * 2 B + (256 + 256 + 1) * 4 B of biases = 148,996 B
    assert roofline.weight_bytes(bf16) == 148_996
    assert roofline.launch_bytes(bf16, n) == 148_996 + n * (60 + 4)
    # int8: 73,472 * 1 B + 513 * (4 B bias + 4 B scale) = 77,576 B; 30 + 4 B a row in
    assert roofline.weight_bytes(q8) == 77_576
    assert roofline.launch_bytes(q8, n) == 77_576 + n * (34 + 4)
    bound = roofline.launch_bound_s(bf16, n)
    if n == 16:  # bound by the weights' bytes
        assert bound == pytest.approx((148_996 + 16 * 64) / 3.35e12)
    else:  # bound by the operations
        assert bound == pytest.approx(16384 * 146_944 / 989e12)
    assert roofline.bound_s(bf16, [n, n]) == pytest.approx(2 * bound)
    assert roofline.mfu(q8, n, 1.0) == pytest.approx(n * 146_944 / 1979e12)


def _tiny() -> dict:
    """A 2 -> 2 -> 2 -> 1 model with numbers exact in bf16."""
    return {"mu": np.array([1.0, 0.0], np.float32), "sigma": np.array([2.0, 1.0], np.float32),
            "w": [np.array([[1.0, -1.0], [0.5, 2.0]], np.float32),
                  np.array([[1.0, 0.0], [0.25, 1.0]], np.float32),
                  np.array([[1.0], [-2.0]], np.float32)],
            "b": [np.array([0.5, 0.0], np.float32), np.array([0.0, -1.0], np.float32),
                  np.array([0.25], np.float32)]}


def test_reference_bf16_on_a_hand_worked_row():
    # x = (3, 1): normalized (1, 1); layer 1: (1*1 + 1*0.5 + 0.5, -1 + 2 + 0) = (2, 1);
    # layer 2: relu(2*1 + 1*0.25, 0 + 1*1 - 1) = (2.25, 0); z = 2.25 - 0 + 0.25 = 2.5
    p = mlp.forward_bf16(_tiny(), np.array([[3.0, 1.0]], np.float32))
    assert p[0] == pytest.approx(1 / (1 + np.exp(-2.5)), abs=1e-7)
    # bf16 rounds to nearest, ties to even: 1 + 2^-8 ties down, 1 + 3*2^-8 up
    assert mlp.bf16(np.float32(1 + 2 ** -8)) == 1.0
    assert mlp.bf16(np.float32(1 + 3 * 2 ** -8)) == np.float32(1 + 2 ** -6)


def test_reference_int8_on_a_hand_worked_row():
    q = mlp.quantize(_tiny(), bits=8)
    # per-column scales max|W|/127: layer 1 (1/127, 2/127)
    assert q["scale"][0] == pytest.approx(np.array([1, 2], np.float32) / 127)
    assert q["wq"][0].tolist() == [[127, -64], [64, 127]]
    # the row (1, 1) quantizes to (127, 127) at s = 1/127: exact here
    p = mlp.forward_int(q, np.array([[3.0, 1.0]], np.float32))
    assert p[0] == pytest.approx(1 / (1 + np.exp(-2.5)), abs=2e-2)
    # four bits are coarser
    p4 = mlp.forward_int(mlp.quantize(_tiny(), bits=4), np.array([[3.0, 1.0]], np.float32))
    assert abs(p4[0] - p[0]) > 1e-4


def test_the_surrogate_reproduces_its_seed():
    a, ya = surrogate.kaggle_surrogate(5000, 2 ** 33 + 5)
    b, yb = surrogate.kaggle_surrogate(5000, 2 ** 33 + 5)
    c, _ = surrogate.kaggle_surrogate(5000, 6)
    assert np.array_equal(a, b) and np.array_equal(ya, yb) and not np.array_equal(a, c)
    assert a.shape == (5000, 30) and a.dtype == np.float32 and ya.sum() == 9
    # the frozen copy draws what the program's generator drew when it was copied
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

    assert np.array_equal(kaggle_surrogate(n=5000, seed=6).X, c)


def test_every_seed_gets_the_same_sizes():
    mix = {"pool_rows": 64}
    a, b = generator.pool(mix, 3), generator.pool(mix, 2 ** 33 + 3)
    assert a.shape == b.shape == (64, 30) and not np.array_equal(a, b)
    assert np.array_equal(a, generator.pool(mix, 3))


def test_the_import_check_finds_planted_modules(monkeypatch):
    """The check reads the process's own sys.modules."""
    import sys
    import types

    assert "ccfd_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ccfd_tpu_torch_probe", types.ModuleType("x"))
    assert "ccfd_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ccfd_tpu.x", types.ModuleType("ccfd_tpu.x"))
    assert "ccfd_tpu" in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert "jax" in runner.forbidden_modules()


def test_the_import_check_compares_whole_top_level_names():
    assert runner.forbidden_modules({"jax.numpy", "numpy"}) == ["jax"]
    assert runner.forbidden_modules({"ccfd_tpu.ops.fused_mlp"}) == ["ccfd_tpu"]
    assert runner.forbidden_modules({"ccfd_tpu_torch", "ccfd_tpu_torch.ops"}) == []
    assert runner.forbidden_modules({"flax.linen", "jaxlib"}) == ["flax", "jaxlib"]


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_benchmark_source_imports_jax_and_the_reference_not_the_program():
    files = [p for p in spec.BENCH_DIR.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not _imports(p) & set(runner.FORBIDDEN), p
    for p in (spec.BENCH_DIR / "reference").glob("*.py"):
        assert runner.PROGRAM not in _imports(p), p


@pytest.mark.parametrize("reply", [
    b"HTTP/1.1 200 OK\r\nContent-Length: 5\r\n\r\nhello",
    b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n2\r\nhe\r\n3\r\nllo\r\n0\r\n\r\n",
])
def test_the_client_parses_a_reply_only_once_it_is_whole(reply):
    from benchmark.traffic.rest_client import parse_response

    for cut in range(len(reply)):
        assert parse_response(reply[:cut]) is None
    status, body, rest, closes = parse_response(reply + b"HTTP/1.1")
    assert (status, body, rest, closes) == (200, b"hello", b"HTTP/1.1", False)
