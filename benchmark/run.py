"""The benchmark of ``ccfd_tpu_torch`` on one NVIDIA card: one run of one
cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload mlp_bf16.rest16 --seed 7 --seconds 10 --trace 0

Run from the checkout's root. Exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell asks for), without the program in
the checkout, or with JAX or the package the port was made from loaded once
the window has closed. With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy and window seconds, and a breakdown.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark.harness import runner

    return runner.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
