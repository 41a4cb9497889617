"""Resolve a cell of ``BENCHMARK.json`` to the files that hold it, by name:

- its configuration: the ``file`` of its entry under ``configs``, and the
  plain reference beside it, ``benchmark/reference/<config>.py``;
- its traffic mix: ``benchmark/mixes/<traffic>.json``, and the driver of
  the mix's ``kind``, ``benchmark/harness/drivers/<kind>.py``, which runs
  the cell and judges its answers;
- its metrics: the end-to-end metrics whose ``workloads`` name it (or that
  have none), and the per-layer metrics whose ``workloads`` name it (or
  that have none and move one of its end-to-end metrics), each read by
  ``benchmark/metrics/<metric>.py``.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict       # the configuration file, with ``name`` and ``file``
    mix: dict          # the mix file, with ``name``
    end_to_end: list   # BENCHMARK.json entries
    per_layer: list

    @property
    def e2e_names(self) -> set:
        return {m["name"] for m in self.end_to_end}


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def with_pending(bench: dict, bench_dir: Path = BENCH_DIR) -> dict:
    """``bench`` with every cell under ``benchmark/pending/`` added: a
    pending file holds the ``configs``, ``workloads`` and ``per_layer``
    entries of a cell measured and left out, and the ``end_to_end`` metrics
    whose ``workloads`` would name it (PERF.md says why each waits)."""
    out = json.loads(json.dumps(bench))
    for path in sorted((bench_dir / "pending").glob("*.json")):
        with open(path) as f:
            extra = json.load(f)
        for key in ("configs", "workloads", "per_layer"):
            out[key] += extra[key]
        cells = [w["name"] for w in extra["workloads"]]
        for m in out["end_to_end"]:
            if m["name"] in extra["end_to_end"]:
                m["workloads"] = m["workloads"] + cells
    return out


def _applies(metric: dict, cell: str, e2e: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e is None or metric.get("moves") in e2e


def resolve(bench: dict, name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name``; raises ``KeyError`` for a name the file lacks."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf_entry["file"]) as f:
        config = json.load(f)
    config.update(name=conf_entry["name"], file=conf_entry["file"])
    with open(bench_dir / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    mix["name"] = w["traffic"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=e2e, per_layer=layer)


def _load(path: Path, modname: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader of per-layer metric ``metric``: a module with
    ``read(readings) -> float | None``."""
    return _load(bench_dir / "metrics" / f"{metric}.py",
                 "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))


def driver(kind: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The driver of mix kind ``kind``: a module with ``run(cell, seed,
    seconds, trace, device, state, record) -> out`` and ``judge(out, mix,
    ref, seconds, limits) -> {checks, attempted, failed, rows, judged,
    rows_per_s}``; raises ``FileNotFoundError`` naming the file for a kind
    with none."""
    path = bench_dir / "harness" / "drivers" / f"{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no driver for mix kind {kind!r}: {path} does not exist")
    return _load(path, "benchmark_driver_" + kind.replace(".", "_").replace("-", "_"))


def reference(config: str) -> ModuleType:
    """The plain reference of configuration ``config``: a module with
    ``load(config[, served=...]) -> state``, ``reference(state, traffic)``
    and ``control(state, traffic)``, each giving the probabilities of the
    answers the driver's ``traffic`` asks for (a REST cell's pool rows; a
    keyed stream's records in produce order with their customers' keys)."""
    return _load(BENCH_DIR / "reference" / f"{config}.py",
                 "benchmark_reference_" + config.replace(".", "_").replace("-", "_"))
