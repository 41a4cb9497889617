#!/usr/bin/env python3
"""The operator's fixed-rate runs in turns, on the card.

Runs ``chip_smoke.py``'s platform (4) (the port's CR through
``Platform.up`` in process, the producer at each of ``--rates``, by
default 2,000/s and then 8,000/s) once an arm, each arm in a fresh
process, in the order given:

- ``on``: this checkout as the CR ships it (heal and audit on);
- ``off``: this checkout with ``CCFD_HEAL=0 CCFD_AUDIT=0``;
- ``other``: the checkout at ``--other DIR`` (for example a parent commit
  unpacked with ``git archive`` into a directory ``.gitignore`` lists).

Each child counts the collector's passes of every generation and their
time (``gc.callbacks``). The tool prints the smoke's own lines, then one
JSON line an arm and rate with the achieved producer rate, decision
p50/p99 and the router stages' p50s parsed from them (also to ``--out``
when given).

    python tools/torch_platform_ab.py --other build/parent \\
        --order on,off,other,other,off,on        (from the repository root)

Exits non-zero without CUDA or when an arm fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# the child: the smoke's device and build phases, then platform (4), with
# the collector's passes counted per generation
CHILD = r"""
import gc, json, sys, time
sys.path.insert(0, ".")
passes = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}
t = [0.0]
def cb(phase, info):
    if phase == "start":
        t[0] = time.perf_counter()
    else:
        p = passes[info["generation"]]
        p[0] += 1
        p[1] += time.perf_counter() - t[0]
gc.callbacks.append(cb)
import chip_smoke
if len(sys.argv) > 1:
    chip_smoke.FIXED_RATES = tuple(int(r) for r in sys.argv[1].split(","))
s = chip_smoke.Smoke()
s.device()
s.build()
s.platform_fixed_rate()
print("GC " + json.dumps({g: {"passes": n, "ms": round(sec * 1e3, 3)}
                          for g, (n, sec) in passes.items()}), flush=True)
"""

LINE = re.compile(
    r"platform \(4\) (?P<rate>\d+)/s: (?P<n>\d+) transactions produced in [\d.]+ s "
    r"\((?P<achieved>[\d.]+)/s achieved.*?decision p50 (?P<p50>[\d.]+) ms, "
    r"p99 (?P<p99>[\d.]+) ms.*?bus queue (?P<bus>[\d.]+) /.*?decode service "
    r"(?P<decode>[\d.]+) /.*?score dispatch (?P<score>[\d.]+) /.*?route service "
    r"(?P<route>[\d.]+) /")


def run_arm(name: str, tree: Path, env_extra: dict, rates: str,
            timeout: float) -> list[dict]:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CCFD_HEAL",
                                                           "CCFD_AUDIT")}
    env.update(env_extra)
    env["PYTHONPATH"] = str(tree)
    out = subprocess.run([sys.executable, "-c", CHILD, rates], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=timeout)
    sys.stdout.write(out.stdout)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"arm {name} exited {out.returncode}")
    gc_line = [ln for ln in out.stdout.splitlines() if ln.startswith("GC ")]
    gcs = json.loads(gc_line[-1][3:]) if gc_line else None
    rows = []
    for m in LINE.finditer(out.stdout):
        row = {"arm": name, **{k: (int(v) if k in ("rate", "n") else float(v))
                               for k, v in m.groupdict().items()}}
        row["gc"] = gcs  # the child's whole life, every rate
        rows.append(row)
    if len(rows) != len(rates.split(",")):
        raise SystemExit(f"arm {name}: {len(rows)} platform (4) lines parsed")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", default="on,off,off,on",
                    help="comma-separated arms: on, off, other")
    ap.add_argument("--other", default="", help="another checkout of the port")
    ap.add_argument("--rates", default="2000,8000",
                    help="producer rows/s, one run each in every arm")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds an arm")
    ap.add_argument("--out", default="", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_platform_ab: CUDA is not available; this runs on the card",
              file=sys.stderr)
        return 1
    arms = {"on": (REPO, {}), "off": (REPO, {"CCFD_HEAL": "0", "CCFD_AUDIT": "0"})}
    if args.other:
        arms["other"] = (Path(args.other).resolve(), {})
    order = args.order.split(",")
    if any(a not in arms for a in order):
        ap.error(f"--order names an arm not in {sorted(arms)}")
    rows = []
    for name in order:
        tree, env = arms[name]
        rows += run_arm(name, tree, env, args.rates, args.timeout)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
