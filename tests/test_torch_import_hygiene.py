"""The PyTorch port imports neither JAX nor the JAX package.

Imports run in a subprocess: this test process already holds jax
(tests/conftest.py). ``ccfd_tpu_torch`` starts with ``ccfd_tpu``, so the
check matches the reference package by name or ``ccfd_tpu.`` prefix.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ccfd_tpu_torch"


def _forbidden(name: str) -> bool:
    return (name in ("jax", "ccfd_tpu")
            or name.startswith("jax.") or name.startswith("ccfd_tpu."))


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import ccfd_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(ccfd_tpu_torch.__path__, 'ccfd_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps({'mods': mods, 'loaded': sorted(sys.modules)}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "ccfd_tpu_torch.serving.server" in res["mods"]
    assert "ccfd_tpu_torch.ops.fused_mlp" in res["mods"]
    assert "ccfd_tpu_torch.ops.fused_mlp_q8" in res["mods"]
    assert "ccfd_tpu_torch.ops.quant" in res["mods"]
    for m in ("router.router", "router.rules", "bus.broker", "process.engine",
              "process.fraud", "process.prediction", "process.clock", "process.dmn",
              "producer.producer", "notify.service", "ops.fused_decision",
              "serving.fused", "cli", "runtime.breaker", "runtime.overload",
              "observability.trace", "observability.memory", "router.parallel",
              "serving.dispatch", "serving.client", "utils.httpclient",
              "utils.httpserver", "bus.server", "bus.client", "process.server",
              "process.client", "metrics.exporter"):
        assert f"ccfd_tpu_torch.{m}" in res["mods"], m
    bad = [n for n in res["loaded"] if _forbidden(n)]
    assert bad == [], bad
    assert "torch" in res["loaded"]


def _named_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value  # e.g. importlib.import_module("...")


def test_no_source_file_names_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _named_modules(f) if _forbidden(name)]
    assert bad == [], bad
