"""One ``--trace 1`` run of one REST cell (mix kind ``closed_loop_rest``)
with the program's own spans read:
``run.py``'s traced result line, with the server built as ``serve``
builds it plus a tracer on an armed span recorder.

    python3 benchmark/traced.py --workload mlp_bf16.rest16 --seed 7 --seconds 10

Beside ``run.py --trace 1``'s metrics, the line holds the REST path's own
(``benchmark/harness/spans.py``): ``front.queue_ms.rest``,
``scorer.host_us_per_dispatch.rest``, ``scorer.wait_us_per_dispatch.rest``,
``scorer.useful_rows_pct.rest`` and ``host.gc_pct.rest``; each of the ten
longest idle gaps named by the spans over it (``breakdown.idle_gaps``);
each name's share of the device's idle time (``breakdown.idle_named_pct``),
each Scorer step's wall and CPU µs a dispatch (``breakdown.scorer_steps_us``)
and the spans recorded. The harness's files are used as they are: this
wraps ``cli.build_server``, ``harness/rest.run`` and ``runner.run_cell`` for
the run, so ``run.py`` is unchanged. ``run.py --trace 1`` on the same seed
is the same run without the recorder: the pair reads what arming it costs.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here, as in run.py

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UNITS = {"front.queue_ms.rest": "ms", "scorer.host_us_per_dispatch.rest": "us",
         "scorer.wait_us_per_dispatch.rest": "us", "scorer.useful_rows_pct.rest": "%",
         "host.gc_pct.rest": "%"}


@contextlib.contextmanager
def recorded(runs: list):
    """While open, each ``rest.run`` builds its server with a tracer on an
    armed ``SpanRecorder`` and appends to ``runs`` its recorder and the
    run's output."""
    from benchmark.harness import rest
    from ccfd_tpu_torch import cli
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.observability.trace import SpanRecorder, Tracer

    build, run = cli.build_server, rest.run

    def build_traced(*a, **kw):
        rec = SpanRecorder()
        srv = build(*a, tracer=Tracer(Registry(), "seldon", sink=rec), **kw)
        runs.append({"recorder": rec})
        rec.arm()
        return srv

    def run_recorded(*a, **kw):
        try:
            out = run(*a, **kw)
        finally:
            if runs:
                runs[-1]["recorder"].disarm()
        runs[-1]["out"] = out
        return out

    cli.build_server, rest.run = build_traced, run_recorded
    try:
        yield
    finally:
        cli.build_server, rest.run = build, run
        for r in runs:
            r["recorder"].disarm()


def run_cell(cell, seed: int, seconds: float, device, t_start: float,
             harness_run_cell=None) -> dict:
    """``runner.run_cell`` (or ``harness_run_cell``) traced, with the
    spans' readings added."""
    from benchmark.harness import runner

    runs: list = []
    with recorded(runs):
        result = (harness_run_cell or runner.run_cell)(cell, seed, seconds, True, device,
                                                       t_start)
    return add_readings(runs[-1], result)


def add_readings(run: dict, result: dict) -> dict:
    """``result`` with the readings of ``run`` (what ``recorded`` kept of
    it) added."""
    from benchmark.harness import spans

    out, rec = run["out"], run["recorder"]
    got, t0, t1 = rec.spans(), out["t0"], out["t1"]
    values = {
        "front.queue_ms.rest": spans.front_queue_ms(got, t0, t1),
        "scorer.host_us_per_dispatch.rest": spans.scorer_host_us_per_dispatch(got, t0, t1),
        "scorer.wait_us_per_dispatch.rest": spans.scorer_wait_us_per_dispatch(got, t0, t1),
        "scorer.useful_rows_pct.rest": spans.useful_rows_pct(got, t0, t1),
        "host.gc_pct.rest": spans.gc_pct(got, t0, t1),
    }
    for name, v in values.items():
        if v is not None:
            result["metrics"][name] = {"value": float(v), "unit": UNITS[name]}
    gaps = out["trace"].idle_gaps()
    namer = spans.GapNamer(got, t0, t1)
    result["breakdown"]["idle_gaps"] = [[namer.name(a, b), b - a] for a, b in gaps[:10]]
    result["breakdown"]["idle_named_pct"] = namer.shares(gaps)
    result["breakdown"]["scorer_steps_us"] = spans.scorer_steps_us(got, t0, t1)
    result["breakdown"]["spans"] = {"recorded": len(got), "dropped": rec.dropped}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    args.trace = 1
    from benchmark.harness import runner

    # runner.main checks the card and the program, prints and exits as for
    # run.py; only its run is this module's
    inner = runner.run_cell
    runner.run_cell = lambda cell, seed, seconds, trace, device, t_start: run_cell(
        cell, seed, seconds, device, t_start, inner)
    try:
        return runner.main(args, T_START)
    finally:
        runner.run_cell = inner


if __name__ == "__main__":
    sys.exit(main())
