"""The control of a cell's correctness check: the plain reference one
precision step below the configuration's (int8 for bf16, int4 for int8),
put in the program's place where the scorer hands back its answers, and the
cell run and judged at its own size exactly as ``benchmark/run.py`` runs and
judges it. A sound check reads the control as not correct.

    python3 benchmark/control.py --workload mlp_bf16.rest16 --seeds 1,2,3

Prints one JSON line a seed: ``correct`` and each check beside its limit.
Exits 0 when every seed reads not correct. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import runner, spec  # noqa: E402


@contextlib.contextmanager
def in_place(config: dict):
    """While open, every answer the program's scorer hands back is the
    control's for the rows it was handed; the launch still runs."""
    from ccfd_tpu_torch.serving.scorer import Scorer

    ref = spec.reference(config["name"])
    state = ref.load(config)
    launch, collect = Scorer._launch, Scorer._collect

    def control_launch(self, live, chunk, b):
        return launch(self, live, chunk, b), np.array(chunk, np.float32)

    def control_collect(self, pending):
        inner, rows = pending
        collect(self, inner)
        return ref.control(state, rows).astype(np.float32)

    Scorer._launch, Scorer._collect = control_launch, control_collect
    try:
        yield
    finally:
        Scorer._launch, Scorer._collect = launch, collect


def reading(cell: spec.Cell, seed: int, seconds: float, device: str) -> dict:
    with in_place(cell.config):
        res = runner.run_cell(cell, seed, seconds, False, device, time.perf_counter())
    return {"workload": cell.name, "seed": seed, "correct": res["correct"],
            "attempted": res["attempted"], "failed": res["failed"], "checks": res["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json's run_seconds)")
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("CCFD_")]:
        del os.environ[k]
    bench = spec.load_benchmark()
    cell = spec.resolve(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        runner.log("the control runs on a CUDA card")
        return 3
    seconds = args.seconds if args.seconds is not None else float(bench["run_seconds"])
    caught = True
    for s in args.seeds.split(","):
        r = reading(cell, int(s), seconds, "cuda")
        caught &= not r["correct"]
        print(json.dumps(r, default=runner._num), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
