"""The knee of a stream cell: the highest arrival rate at which the backlog
when the window closes stays under one second of arrivals.

    python3 benchmark/sweep.py --workload seq_bf16.steady --rates 2000,4000,8000 --seed 7

Runs a cell of ``BENCHMARK.json`` once a rate, each in a process of its
own, as ``benchmark/run.py`` runs it (with its checks on the program's
origin and on the modules loaded) but with the mix's ``rate_per_s``
replaced, and prints one JSON line a rate: the backlog at the window's close
in seconds of arrivals (read from the driver's note), ``correct``, the
checks and the end-to-end metrics. The last line names the knee among the
rates tried. Needs a CUDA card. The benchmark's own runs never run this; a
cell's mix keeps the rate found.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import runner, spec  # noqa: E402

# the keyed stream driver's note of the backlog when the window closed
BACKLOG = re.compile(r"backlog when the window closed: \d+ records due and not decided, "
                     r"([0-9.]+) s of arrivals")


def one(workload: str, rate: float, seed: int, seconds: float) -> dict | None:
    """One run of ``workload`` at ``rate``; None where run.py would print
    no result."""
    t_start = time.perf_counter()
    cell = spec.resolve(spec.load_benchmark(), workload)
    cell.mix["rate_per_s"] = rate
    if not runner.program_is_here():
        runner.log(f"the program ({runner.PROGRAM}) is not in this checkout")
        return None
    res = runner.run_cell(cell, seed, seconds, False, "cuda", t_start)
    bad = runner.forbidden_modules()
    if bad:
        runner.log("modules of JAX or of the package the port was made from are loaded: "
                   + ", ".join(bad))
        return None
    return {"rate_per_s": rate, "correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "checks": res["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated records a second")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("CCFD_")]:
        del os.environ[k]
    seconds = (args.seconds if args.seconds is not None
               else float(spec.load_benchmark()["run_seconds"]))
    if args.one:
        line = one(args.workload, float(args.rates), args.seed, seconds)
        if line is None:
            return 4
        print(json.dumps(line, default=runner._num), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        runner.log("the sweep runs on a CUDA card")
        return 3
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                            "--workload", args.workload, "--rates", repr(rate),
                            "--seed", str(args.seed), "--seconds", repr(seconds)],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(json.dumps({"rate_per_s": rate, "error": r.stderr[-1500:]}), flush=True)
            continue
        line = json.loads(r.stdout.strip().splitlines()[-1])
        notes = [x for x in r.stderr.splitlines() if x.startswith("[bench]")]
        backlog = [m for m in map(BACKLOG.search, notes) if m]
        line["backlog_s"] = float(backlog[-1].group(1)) if backlog else None
        line["notes"] = notes[-8:]
        print(json.dumps(line), flush=True)
        if line["backlog_s"] is not None and line["backlog_s"] < 1.0:
            knee = rate if knee is None else max(knee, rate)
    print(json.dumps({"knee_per_s": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
