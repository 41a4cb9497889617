"""BENCHMARK.json against its contract, and the harness finding every
piece of a cell by name."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.harness import spec
from benchmark.harness.readings import Readings

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_fits_with_24_cells():
    s = BENCH["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_carry_just_their_keys_and_legal_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e and section in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] \
                        and "\t" not in e[text], (e["name"], text)


def test_cells_configs_and_bounds():
    confs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == confs
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in BENCH["configs"]:
        assert c["reduced"] == [] and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] == 0.25 and "workloads" not in names["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = spec.resolve(BENCH, cell)
    assert c.config["name"] and c.mix["kind"]
    assert "setup_s" in c.e2e_names and len(c.e2e_names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in c.e2e_names, (cell, m["name"])
        assert callable(spec.reader(m["name"]).read)
    ref = spec.reference(c.config["name"])
    assert callable(ref.reference) and callable(ref.control)


def test_every_per_layer_metric_has_a_reader_and_one_layer_name():
    layers = {}
    for m in BENCH["per_layer"]:
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_a_cell_added_as_files_alone_is_found(tmp_path: Path):
    """A new mix, a new per-layer metric and a new cell, added as files and
    entries only, resolve and read without touching the harness."""
    bench = json.loads(json.dumps(BENCH))
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR / "mixes", bench_dir / "mixes")
    shutil.copytree(spec.BENCH_DIR / "metrics", bench_dir / "metrics")
    shutil.copytree(spec.BENCH_DIR / "configs", bench_dir / "configs")
    (bench_dir / "mixes" / "scratch.json").write_text(json.dumps(
        {"kind": "closed_loop_rest", "clients": 1, "rows_per_request": 4,
         "requests_per_client": 8, "pool_rows": 64, "path": "/api/v0.1/predictions"}))
    (bench_dir / "metrics" / "scratch.rows.py").write_text(
        "def read(r):\n    return float(r.rows) if r.rows else None\n")
    bench["workloads"].append({"name": "mlp_bf16.scratch", "config": "mlp_bf16",
                               "traffic": "scratch", "chips": 1, "why": "a scratch cell"})
    bench["end_to_end"].append({"name": "scratch_e2e", "unit": "rows/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["mlp_bf16.scratch"]})
    bench["per_layer"].append({"name": "scratch.rows", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "scratch",
                               "moves": "scratch_e2e", "workloads": ["mlp_bf16.scratch"]})
    c = spec.resolve(bench, "mlp_bf16.scratch", root=tmp_path, bench_dir=bench_dir)
    assert c.mix["name"] == "scratch" and c.mix["clients"] == 1
    assert c.e2e_names == {"scratch_e2e", "setup_s"}
    assert [m["name"] for m in c.per_layer] == ["scratch.rows"]
    r = Readings(config=c.config, mix=c.mix, t0=0.0, t1=1.0, rows=7, dispatches=1,
                 launches=[])
    assert spec.reader("scratch.rows", bench_dir=bench_dir).read(r) == 7.0
    # the cells already there are untouched by the addition
    assert spec.resolve(bench, CELLS[0], root=tmp_path, bench_dir=bench_dir).per_layer


def test_the_checkpoint_is_the_programs_committed_one():
    a = (ROOT / "benchmark" / "configs" / "mlp_step_1200.npz").read_bytes()
    b = (ROOT / "ccfd_tpu_torch" / "assets" / "mlp_step_1200.npz").read_bytes()
    assert a == b
