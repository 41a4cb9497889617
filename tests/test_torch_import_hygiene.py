"""The PyTorch port imports neither JAX nor the JAX package, nor what the
reference trains and checkpoints with (optax, orbax, scikit-learn).

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

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ccfd_tpu_torch"


FORBIDDEN = ("jax", "ccfd_tpu", "optax", "orbax", "sklearn")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


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
              "process.client", "metrics.exporter", "native", "serving.native_front",
              "utils.gctune", "models.losses", "parallel.train", "parallel.online",
              "parallel.checkpoint", "runtime.durability", "models.logreg",
              "models.trees", "models.registry", "serving.graph", "bus.log",
              "bus.kafka_adapter", "runtime.faults", "process.usertask_model",
              "process.investigator", "serving.batcher", "data.sequences",
              "ops.ring_attention", "models.seq", "ops.seq_quant", "serving.history",
              "observability.device", "runtime.heal", "runtime.chaos",
              "observability.audit", "analytics", "analytics.engine", "lifecycle",
              "lifecycle.versions", "lifecycle.shadow", "lifecycle.evaluator",
              "lifecycle.controller", "replay", "replay.service",
              "observability.incident", "observability.capacity",
              "observability.dashboards", "utils.loadgen", "fleet", "fleet.protocol",
              "fleet.ledger", "fleet.member", "fleet.supervisor", "analysis",
              "analysis.core", "analysis.rules", "analysis.lockcheck", "parallel.mesh",
              "parallel.sharding", "parallel.partition", "parallel.multihost",
              "ops.shard_compat", "ops.ulysses"):
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
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tools" / "torch_fleet_drill.py",
                                          REPO / "tools" / "torch_load_shape.py",
                                          REPO / "tools" / "torch_multihost_drill.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _named_modules(f) if _forbidden(name)]
    assert bad == [], bad


def test_the_native_build_names_nothing_of_the_reference():
    """The port's native library builds from its own sources: the g++
    command names only files under ccfd_tpu_torch/native and the build
    directory, and the sources include system headers only. Run in a
    subprocess with the port alone on the path."""
    code = (
        "import json\n"
        "from ccfd_tpu_torch import native\n"
        "print(json.dumps({'cmd': native.build_command(native.library_path()),\n"
        "                  'srcs': [str(native.HERE / s) for s in native.SOURCES]}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    paths = [a for a in res["cmd"] if "/" in a and not a.startswith("-")]
    assert paths and all(
        Path(a).resolve().is_relative_to(PORT / "native")
        or Path(a).resolve().is_relative_to(REPO / "build" / "ccfd_tpu_torch")
        or a == res["cmd"][0] for a in paths), paths
    assert not any((REPO / "ccfd_tpu") in Path(a).resolve().parents for a in paths)
    for src in res["srcs"]:
        includes = [ln for ln in Path(src).read_text().splitlines()
                    if ln.startswith("#include")]
        assert includes and all("<" in ln and '"' not in ln for ln in includes), includes


@pytest.mark.parametrize("mod", ["models.logreg", "models.trees", "models.registry",
                                 "serving.graph"])
def test_the_model_modules_import_alone_without_the_reference(mod):
    """Each model module loads by itself, with no JAX, reference or
    scikit-learn module (the converters read fitted estimators' attributes)."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module('ccfd_tpu_torch.{mod}')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [n for n in loaded if _forbidden(n)] == []


@pytest.mark.parametrize("mod", ["bus.log", "bus.kafka_adapter", "runtime.faults",
                                 "runtime.durability", "runtime.heal", "runtime.chaos",
                                 "observability.audit"])
def test_the_durable_and_fault_modules_import_alone(mod):
    """The slice's modules load by themselves with nothing of JAX or the
    reference, and the Kafka adapter does not import kafka-python until a
    KafkaAdapter is built."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module('ccfd_tpu_torch.{mod}')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [n for n in loaded if _forbidden(n) or n == "kafka" or n.startswith("kafka.")] == []


@pytest.mark.parametrize("mod", ["analytics", "analytics.engine", "lifecycle",
                                 "lifecycle.versions", "lifecycle.shadow",
                                 "lifecycle.evaluator", "lifecycle.controller", "replay",
                                 "replay.service"])
def test_the_rollout_and_replay_modules_import_alone(mod):
    """The model lifecycle, the analytics engine and the replay plane each
    load by themselves with nothing of JAX or the reference (the reference's
    controller and engine import jax; the port's are torch and numpy)."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module('ccfd_tpu_torch.{mod}')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [n for n in loaded if _forbidden(n)] == []


@pytest.mark.parametrize("mod", ["observability.incident", "observability.capacity",
                                 "observability.dashboards", "utils.loadgen"])
def test_the_evidence_plane_modules_import_alone(mod):
    """The flight recorder, the capacity observatory, the dashboards and the
    load generator each load by themselves with nothing of JAX or the
    reference."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module('ccfd_tpu_torch.{mod}')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [n for n in loaded if _forbidden(n)] == []


@pytest.mark.parametrize("mod", ["fleet", "fleet.protocol", "fleet.ledger", "fleet.member",
                                 "fleet.supervisor", "analysis", "analysis.core",
                                 "analysis.rules", "analysis.lockcheck"])
def test_the_fleet_and_lint_modules_import_alone(mod):
    """The fleet plane and the linter each load by themselves with nothing
    of JAX or the reference (the reference's fleet/protocol.py and
    analysis/ load no JAX either: the port keeps its own copies). The
    linter loads no torch: it runs where no accelerator stack is."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module('ccfd_tpu_torch.{mod}')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [n for n in loaded if _forbidden(n)] == []
    if mod.startswith("analysis"):
        assert "torch" not in loaded and "numpy" not in loaded


def test_the_port_drill_tool_loads_no_jax_and_no_reference():
    """tools/torch_fleet_drill.py imports the port alone: loading it (and
    every module its drill imports) pulls in nothing of JAX or the
    reference."""
    code = (
        "import importlib.util, json, sys\n"
        "spec = importlib.util.spec_from_file_location('drill', 'tools/torch_fleet_drill.py')\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "import ccfd_tpu_torch.bus.server, ccfd_tpu_torch.fleet.supervisor\n"
        "import ccfd_tpu_torch.platform.operator, ccfd_tpu_torch.cli\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [n for n in loaded if _forbidden(n)] == []


@pytest.mark.parametrize("mod", ["parallel.mesh", "parallel.sharding", "parallel.partition",
                                 "parallel.multihost", "ops.shard_compat", "ops.ulysses"])
def test_the_partitioning_modules_import_alone(mod):
    """The mesh, the placement specs, the partitioners, the multi-process
    runtime, the single-controller shard_map and Ulysses each load by
    themselves with nothing of JAX or the reference."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module('ccfd_tpu_torch.{mod}')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [n for n in loaded if _forbidden(n)] == []


@pytest.mark.parametrize("tool", ["torch_load_shape", "torch_multihost_drill"])
def test_the_port_tools_import_no_jax(tool):
    """The traffic-shape harness and the multi-process drill load (their
    whole import graph, the port's pipeline included) with nothing of JAX or
    the reference."""
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'tools')!r})\n"
        f"importlib.import_module({tool!r})\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [n for n in loaded if _forbidden(n)] == []
