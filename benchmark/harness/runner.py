"""One run of one cell: set up, measure, judge, print.

Standard error carries the run's notes, then, as its last lines, each
number compared beside its limit; standard output's last line is the result
object, whose last key, ``checks``, holds the same numbers and limits.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from benchmark.harness import readings, spec
from benchmark.harness.readings import Readings

# top-level module names no run may hold once its window has closed: JAX
# and the package the port was made from (compared whole: the port's own
# name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "ccfd_tpu")
PROGRAM = "ccfd_tpu_torch"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def state_dir() -> Path:
    """Where a run keeps its clients' records: under the environment's
    TMPDIR, else inside the checkout; emptied at the start and the end of
    every run."""
    base = os.environ.get("TMPDIR")
    return (Path(base) if base else spec.ROOT / "build") / "ccfd-bench-state"


def program_is_here() -> bool:
    """The program this run imports is the checkout's own."""
    import importlib.util

    found = importlib.util.find_spec(PROGRAM)
    return bool(found and found.origin
                and Path(found.origin).resolve().is_relative_to(spec.ROOT))


def card() -> tuple[str, str]:
    """(name, power limit) of card 0, as nvidia-smi reads them."""
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return name, limit or "not read"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run ``cell`` on ``device`` with the driver of its mix's kind and
    judge it; returns the result object (without ``device``'s card fields)."""
    drv = spec.driver(cell.mix["kind"])
    state = state_dir()
    shutil.rmtree(state, ignore_errors=True)
    state.mkdir(parents=True)
    # an end-to-end metric of the device's trace has every run traced
    record = trace or any(m["source"] == "device_trace" for m in cell.end_to_end)
    try:
        out = drv.run(cell, seed, seconds, trace, device, str(state), record)
    finally:
        shutil.rmtree(state, ignore_errors=True)
    setup_s = out["setup_end"] - t_start
    log(out["host_cpu"])
    if out.get("trace") is not None:
        log(out["trace"].note)
    for note in out.get("notes", ()):
        log(note)
    config, mix = cell.config, cell.mix
    ref_mod = spec.reference(config["name"])
    t_ref = time.perf_counter()
    # a driver that hands over the params the program served has the
    # reference hold them against its own read of the configuration's file
    served = {"served": out["served"]} if out.get("served") is not None else {}
    ref = ref_mod.reference(ref_mod.load(config, **served), out["traffic"])
    j = drv.judge(out, mix, ref, seconds, config["limits"])
    log(f"judged {j['judged']} answers against the reference in "
        f"{time.perf_counter() - t_ref:.3f} s")
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in j["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    r = Readings(config=config, mix=mix, t0=out["t0"], t1=out["t1"], rows=j["rows"],
                 dispatches=out["dispatches"], launches=out["launches"],
                 rows_per_s=j["rows_per_s"], trace=out["trace"], kernel=out.get("kernel"),
                 counters=out.get("counters", {}))
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: dict = {}
    if not trace:
        values = {"setup_s": setup_s, "device_ms_per_1k_rows": readings.device_ms_per_1k_rows(r)}
        for name in sorted(cell.e2e_names):
            if values.get(name) is None:
                # without a card the device's trace holds nothing to read
                # (the CPU tests); a correct run on the card reads every one
                if str(device).startswith("cuda") and correct:
                    raise RuntimeError(f"end-to-end metric {name} has nothing to read")
                continue
            metrics[name] = {"value": float(values[name]), "unit": units[name]}
    else:
        for m in cell.per_layer:
            v = spec.reader(m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": j["attempted"],
        "failed": j["failed"],
        "metrics": metrics,
        "device": {"memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace:
        dev = out["trace"]
        result["device"].update(busy_s=dev.busy_s, window_s=dev.window_s)
        # the front's C++ threads and the scorer emit no spans to name a gap by
        result["breakdown"] = {"device_ops": dev.top_ops(10),
                               "idle_gaps": [["no spans read", b - a]
                                             for a, b in dev.idle_gaps()[:10]]}
    result["checks"] = checks
    return result


def main(args, t_start: float) -> int:
    for k in [k for k in os.environ if k.startswith("CCFD_")]:
        del os.environ[k]  # the program runs on its defaults and the cell's CR
    bench = spec.load_benchmark()
    cell = spec.resolve(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 3
    if not program_is_here():
        log(f"the program ({PROGRAM}) is not in this checkout")
        return 3
    seed = int(args.seed) % (1 << 64)
    result = run_cell(cell, seed, float(args.seconds), bool(args.trace), "cuda", t_start)
    name, limit = card()
    log(f"card: {name}, power.limit {limit}; peaks: 989 TFLOP/s bf16, 1,979 TOP/s int8, "
        "3.35 TB/s (data sheet, 700 W)")
    result["device"] = {"platform": "gpu", "kind": name, "count": cell.chips,
                        **result["device"]}
    result = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device",
                                     *(["breakdown"] if "breakdown" in result else []),
                                     "checks")}
    bad = forbidden_modules()
    if bad:
        log("modules of JAX or of the package the port was made from are loaded: "
            + ", ".join(bad))
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result, default=_num), flush=True)
    return 0


def _num(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    raise TypeError(type(x))
