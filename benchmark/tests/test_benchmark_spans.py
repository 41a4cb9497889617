"""The program's own spans in a traced run (``benchmark/traced.py``,
``harness/spans.py``), on the CPU: a traced run of each cell reads the
REST path's five metrics and names its idle time; the Scorer's launch
spans are the launches the harness's own ``LaunchLog`` sees; the gap
naming follows its order on planted spans; and a ``--trace 0`` run is what
it was: the same keys, the same metrics, ``build_server`` called as
before and no span made."""
from __future__ import annotations

import time

import pytest

from benchmark import traced
from benchmark.harness import runner, spans, spec

BENCH = spec.load_benchmark()
SMALL = {"clients": 2, "requests_per_client": 32, "pool_rows": 2048, "warmup_s": 0.5}
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 23


def _cell(name: str):
    cell = spec.resolve(BENCH, name)
    cell.mix.update(SMALL)
    return cell


@pytest.fixture(scope="module", params=CELLS)
def traced_run(request):
    """A traced run of the cell: what ``traced.recorded`` kept of it, and
    its result with the spans' readings."""
    runs: list = []
    with traced.recorded(runs):
        result = runner.run_cell(_cell(request.param), SEED, 2.0, True, "cpu",
                                 time.perf_counter())
    return runs[-1], traced.add_readings(runs[-1], result)


def test_a_traced_run_reads_the_rest_paths_five_metrics(traced_run):
    _, res = traced_run
    assert res["correct"], res["checks"]
    assert set(traced.UNITS) <= set(res["metrics"])
    m = {k: res["metrics"][k]["value"] for k in traced.UNITS}
    assert m["front.queue_ms.rest"] >= 0 and m["scorer.host_us_per_dispatch.rest"] > 0
    assert m["scorer.wait_us_per_dispatch.rest"] >= 0 and 0 <= m["host.gc_pct.rest"] < 100
    # 1 to 16 rows a request, padded to a bucket of 16 or more
    assert 0 < m["scorer.useful_rows_pct.rest"] <= 100
    gaps = res["breakdown"]["idle_gaps"]
    assert gaps and all(name != spans.NONE for name, _ in gaps)
    named = res["breakdown"]["idle_named_pct"]
    assert sum(named.values()) == pytest.approx(100.0)
    assert named.get(spans.NONE, 0.0) < 10.0
    assert res["breakdown"]["spans"]["dropped"] == 0
    steps = res["breakdown"]["scorer_steps_us"]
    assert steps["scorer.prep"]["wall"] > 0 and steps["scorer.prep"]["cpu"] > 0


def test_the_launch_spans_are_the_launches_the_harness_logs(traced_run):
    """Each ``scorer.launch`` span, placed at the start of its dispatch's
    ``scorer.prep`` (the nearest stamp to the harness's), carries the rows
    and bucket ``LaunchLog`` logs."""
    run, _ = traced_run
    out = run["out"]
    t0, t1 = out["t0"], out["t1"]
    steps: dict = {}
    for s in run["recorder"].spans():
        if s["name"] in ("scorer.prep", "scorer.launch"):
            steps.setdefault(s["parent_id"], {}).setdefault(s["name"], []).append(s)
    got = [(p["start"], ln["attrs"]["rows"], ln["attrs"]["bucket"]) for d in steps.values()
           for p, ln in zip(d["scorer.prep"], d["scorer.launch"])]
    assert got

    def inside(t):
        # away from the window's ends: the harness stamps a launch before
        # the Scorer's spans start, and a thread switch may fall between
        return t0 + 0.1 <= t < t1 - 0.1

    want = sorted((n, b) for t, n, b in out["launches"] if inside(t))
    have = sorted((n, b) for t, n, b in got if inside(t))
    assert want and have == want


def test_gaps_are_named_in_order_on_planted_spans():
    def sp(name, a, b):
        return {"name": name, "start": a, "end": b}

    planted = [sp("front.take_wait", 0.0, 10.0), sp("front.queue", 2.0, 10.0),
               sp("front.respond", 3.0, 4.0), sp("scorer.wait", 4.0, 9.0),
               sp("scorer.prep", 5.0, 6.0), sp("host.gc", 8.5, 9.5),
               sp("serve.take", 0.0, 20.0)]
    namer = spans.GapNamer(planted, 0.0, 20.0)
    c = namer.cover(0.0, 10.0)
    assert c["host.gc"] == pytest.approx(1.0)          # 8.5-9.5, first of all
    assert c["scorer.prep"] == pytest.approx(1.0)      # 5-6
    assert c["scorer.wait"] == pytest.approx(3.5)      # 4-5, 6-8.5
    assert c["front.respond"] == pytest.approx(1.0)    # 3-4
    assert c["front.queue"] == pytest.approx(1.5)      # 2-3, 9.5-10
    assert c["front.take_wait"] == pytest.approx(2.0)  # 0-2
    assert c[spans.NONE] == 0.0
    assert namer.name(0.0, 10.0) == "scorer.wait"
    assert namer.name(0.0, 2.5) == "front.take_wait"
    # a gap the first name covers whole: the rest count nothing
    assert namer.name(8.6, 9.4) == "host.gc"
    assert namer.cover(8.6, 9.4)["front.take_wait"] == 0.0
    # serve.take names nothing: a gap under it alone reads (none)
    assert namer.name(12.0, 15.0) == spans.NONE
    shares = namer.shares([(0.0, 10.0), (12.0, 22.0)])
    assert shares[spans.NONE] == pytest.approx(50.0)  # 12-22 under no span
    assert shares["scorer.wait"] == pytest.approx(17.5)


def test_the_metric_arithmetic_on_planted_spans():
    def sp(name, a, b, sid, parent=None, **attrs):
        return {"name": name, "start": a, "end": b, "span_id": sid, "parent_id": parent,
                "attrs": attrs}

    planted = [sp("serve.take", 0.0, 1.0, "t1", rows=10),
               sp("front.queue", 0.0, 0.1, "q1", "t1", wait_ms=2.0),
               sp("serve.take", 1.0, 2.0, "t2", rows=30),
               sp("front.queue", 1.0, 1.1, "q2", "t2", wait_ms=6.0),
               sp("scorer.prep", 0.2, 0.3, "p1", "t1", cpu_us=40.0),
               sp("scorer.launch", 0.3, 0.35, "l1", "t1", rows=10, bucket=16, cpu_us=20.0),
               sp("scorer.wait", 0.35, 0.55, "w1", "t1", cpu_us=5.0),
               sp("scorer.readback", 0.55, 0.6, "r1", "t1", cpu_us=10.0),
               sp("scorer.launch", 1.3, 1.35, "l2", "t2", rows=30, bucket=128, cpu_us=0.0),
               sp("host.gc", 0.5, 0.7, "g1"), sp("host.gc", 0.6, 0.8, "g2")]
    assert spans.front_queue_ms(planted, 0.0, 2.0) == pytest.approx(5.0)
    # two dispatches: 0.1 + 0.05 + 0.05 + 0.05 s of host steps, 0.2 s of wait
    assert spans.scorer_host_us_per_dispatch(planted, 0.0, 2.0) == pytest.approx(1.25e5)
    assert spans.scorer_wait_us_per_dispatch(planted, 0.0, 2.0) == pytest.approx(1e5)
    steps = spans.scorer_steps_us(planted, 0.0, 2.0)
    assert steps["scorer.prep"] == pytest.approx({"wall": 5e4, "cpu": 20.0})
    assert steps["scorer.launch"] == pytest.approx({"wall": 5e4, "cpu": 10.0})
    assert steps["scorer.wait"] == pytest.approx({"wall": 1e5, "cpu": 2.5})
    assert spans.gc_pct(planted, 0.0, 2.0) == pytest.approx(15.0)
    assert spans.useful_rows_pct(planted, 0.0, 2.0) == pytest.approx(100 * 40 / 144)
    assert spans.useful_rows_pct(planted, 0.0, 1.0) == pytest.approx(100 * 10 / 16)
    for reader in (spans.scorer_wait_us_per_dispatch, spans.useful_rows_pct,
                   spans.scorer_steps_us):
        assert reader(planted, 5.0, 6.0) is None


@pytest.mark.parametrize("cell", CELLS)
def test_an_untraced_run_is_what_it_was(cell, monkeypatch):
    """``--trace 0``: the result's keys and metrics as before the program's
    spans, ``build_server`` called with the arguments it had, and no span
    made."""
    from ccfd_tpu_torch import cli
    from ccfd_tpu_torch.observability import trace

    calls, made = [], []
    build, init = cli.build_server, trace.Span.__init__

    def spy(*a, **kw):
        calls.append(sorted(kw))
        srv = build(*a, **kw)
        assert srv.tracer is None
        return srv

    def counted(self, *a, **kw):
        made.append(1)
        init(self, *a, **kw)

    monkeypatch.setattr(cli, "build_server", spy)
    monkeypatch.setattr(trace.Span, "__init__", counted)
    res = runner.run_cell(_cell(cell), SEED, 1.0, False, "cpu", time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    # without a card the device's trace holds nothing: setup_s alone
    assert set(res["metrics"]) == {"setup_s"} and res["correct"]
    assert calls == [["device", "params_path"]] and made == []
