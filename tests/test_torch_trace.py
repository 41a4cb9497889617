"""The port's tracing against the JAX package's, on the CPU.

- ``traceparent`` formatting, parsing and header extraction give equal
  contexts; the tail sampler keeps and drops the same traces for the same
  trace ids, flags, errors and durations (span ids are random, so spans
  compare by name, parentage and attributes).
- A traced producer -> bus -> router -> engine -> notify run in each
  package, on the same records with the ladder on and a scorer that fails
  once: the same span names under the same parents with the same
  attributes (``queue_s`` is a wall-clock reading and only checked to be
  there), and the same kept-trace reasons.
- The port's one clock: a span is stamped on CLOCK_MONOTONIC and its wall
  start is that stamp plus the process's offset; the span recorder keeps
  the collector's pauses while armed, and none once disarmed.
"""

import gc
import time

import numpy as np
import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.notify.service import NotificationService as RefNotify
from ccfd_tpu.observability import trace as ref
from ccfd_tpu.process.clock import ManualClock as RefClock
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu.producer.producer import Producer as RefProducer
from ccfd_tpu.router import router as ref_router
from ccfd_tpu.serving.scorer import Scorer as RefScorer
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import Dataset
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.notify.service import NotificationService
from ccfd_tpu_torch.observability import trace as port
from ccfd_tpu_torch.process.clock import ManualClock
from ccfd_tpu_torch.process.fraud import build_engine
from ccfd_tpu_torch.producer.producer import Producer
from ccfd_tpu_torch.router import router as port_router
from tests.torch_helpers import mlp_tree

TP = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


@pytest.mark.parametrize("value", [
    TP, TP.encode(), TP.upper(), "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00",
    "00-" + "0" * 32 + "-b7ad6b7169203331-01", "garbage", "00-xyz-b7ad6b7169203331-01",
    b"\xff\xfe", None, 17, " " + TP + " "])
def test_traceparent_parsing_matches_the_reference(value):
    want = ref.parse_traceparent(value)
    got = port.parse_traceparent(value)
    assert (tuple(got) if got else None) == (tuple(want) if want else None)
    if got is not None:
        assert port.format_traceparent(got) == ref.format_traceparent(want)
    for headers in ({"traceparent": value}, {b"traceparent": value}, {"TraceParent": value}):
        a, b = ref.extract_context(headers), port.extract_context(headers)
        assert (tuple(b) if b else None) == (tuple(a) if a else None)


def test_inject_headers_matches_the_reference():
    assert port.inject_headers() == ref.inject_headers() == {}
    ctx_r, ctx_p = ref.parse_traceparent(TP), port.parse_traceparent(TP)
    assert port.inject_headers({"a": 1}, ctx_p) == ref.inject_headers({"a": 1}, ctx_r)
    t_r, t_p = ref.Tracer(RefRegistry(), "x"), port.Tracer(Registry(), "x")
    with t_r.span("s", parent=ctx_r) as sr, t_p.span("s", parent=ctx_p) as sp:
        assert sr.trace_id == sp.trace_id == ctx_p.trace_id
        assert sr.parent_id == sp.parent_id == ctx_p.span_id
        assert set(port.inject_headers()) == set(ref.inject_headers()) == {"traceparent"}


def test_tail_sampler_decides_as_the_reference():
    """One set of spans (fixed trace ids) into each package's sink."""
    rng = np.random.default_rng(4)
    sinks = (ref.SpanSink(sample=0.3, slow_s=0.05, max_pending=40, max_retained=25,
                          registry=RefRegistry()),
             port.SpanSink(sample=0.3, slow_s=0.05, max_pending=40, max_retained=25,
                           registry=Registry()))
    for i in range(300):
        tid = f"{rng.integers(1 << 62):032x}"[-32:]
        kind = int(rng.integers(6))
        for mod, sink in zip((ref, port), sinks):
            sp = mod.Span(tid, f"{i + 1:016x}", None, "router.batch", "router", 1.0 + i)
            sp.duration_s = 0.2 if kind == 0 else 0.001
            sp.status = "error" if kind == 1 else "ok"
            if kind == 2:
                sp.attrs["fraud"] = True
            if kind == 3:
                sp.attrs["degraded"] = "host"
            sink.add(sp)
    for sink in sinks:
        sink.flush(0.0)
    want, got = sinks[0].traces(), sinks[1].traces()
    assert [t["trace_id"] for t in got] == [t["trace_id"] for t in want]
    assert got == want
    names = ("ccfd_traces_kept_total", "ccfd_traces_dropped_total", "ccfd_traces_retained",
             "ccfd_trace_spans_total")

    def lines(reg):
        return [ln for ln in reg.render().splitlines() if ln.split("{")[0].split(" ")[0] in names]
    assert lines(sinks[1].registry) == lines(sinks[0].registry)


def _traced_run(side, ds, tree, ref_scorer):
    if side == "ref":
        mods = (RefBroker, RefRegistry, RefClock, ref_build_engine, ref_router, RefConfig,
                RefProducer, RefNotify, ref)
    else:
        mods = (Broker, Registry, ManualClock, build_engine, port_router, Config, Producer,
                NotificationService, port)
    broker_t, reg_t, clock_t, build, router_mod, cfg_t, prod_t, notify_t, tmod = mods
    cfg = cfg_t(batch_deadline_ms=0.0, customer_reply_timeout_s=30.0)
    sink = tmod.SpanSink(sample=1.0, slow_s=60.0, registry=reg_t())
    broker = broker_t()
    engine = build(cfg, broker, reg_t(), clock_t())
    calls = [0]

    def score(x):
        calls[0] += 1
        if calls[0] == 2:
            raise ConnectionError("edge down")  # the ladder: this batch on the host
        return ref_scorer.host_score(x)

    reg = reg_t()
    router = router_mod.Router(cfg, broker, score, engine, reg, max_batch=100,
                               host_score_fn=ref_scorer.host_score, degrade=True,
                               tracer=tmod.Tracer(reg, "router", sink))
    notify = notify_t(cfg, broker, reg_t(), seed=1,
                      tracer=tmod.Tracer(reg_t(), "notify", sink))
    prod_t(cfg, broker, ds, tracer=tmod.Tracer(reg_t(), "producer", sink)).run(limit=300)
    while router.step():
        pass
    notify.step()
    router.step()
    sink.flush(0.0)
    trees = []
    for summary in sorted(sink.traces(), key=lambda t: t["start"]):
        spans = sink.trace(summary["trace_id"])
        by_id = {s["span_id"]: s for s in spans}
        shape = []
        for s in spans:
            attrs = dict(s["attrs"])
            if s["name"] == "router.batch":
                assert attrs.pop("queue_s") >= 0.0
            parent = by_id.get(s["parent_id"], {}).get("name") if s["parent_id"] else None
            shape.append((s["name"], s["component"], parent, s["status"],
                          sorted(attrs.items())))
        trees.append(sorted(shape))
    kept = [ln for ln in sink.registry.render().splitlines()
            if ln.startswith("ccfd_traces_kept_total")]
    return trees, kept


def test_pipeline_spans_match_the_reference():
    ds = kaggle_surrogate(n=400, seed=3)
    tree = mlp_tree(ds.X, hidden=32, seed=2)
    ref_scorer = RefScorer(model_name="mlp", params=tree, batch_sizes=(16,),
                           host_tier_rows=0, use_fused=False)
    data = Dataset(X=ds.X[:300], y=ds.y[:300])
    want = _traced_run("ref", data, tree, ref_scorer)
    got = _traced_run("port", data, tree, ref_scorer)
    assert got == want
    trees, _kept = got
    names = {span[0] for t in trees for span in t}
    assert {"producer.batch", "router.batch", "router.decode", "router.score",
            "router.route", "notify.handle"} <= names
    # the batch scored on the host tier carries the degraded flag
    assert any(("degraded", "host") in span[4] for t in trees for span in t)


def _mono_ns() -> int:
    return time.clock_gettime_ns(time.CLOCK_MONOTONIC)


def test_a_span_is_stamped_on_clock_monotonic_and_its_wall_start_adds_the_offset():
    rec = port.SpanRecorder()
    tracer = port.Tracer(Registry(), "x", sink=rec)
    before = _mono_ns()
    with tracer.span("outer"):
        inside = _mono_ns()
        time.sleep(0.002)
    after = _mono_ns()
    given = tracer.record("given", inside, inside + 1_500_000)
    a, b = rec.spans()
    assert a["name"] == "outer" and a["parent_id"] is None
    assert before <= a["start_ns"] <= inside < a["end_ns"] <= after
    assert a["end_ns"] - a["start_ns"] >= 2_000_000
    assert b["start_ns"] == given.start_ns == inside
    assert b["end_ns"] == inside + 1_500_000 and b["duration_s"] == 1.5e-3
    for d in (a, b):
        assert d["start"] == (d["start_ns"] + port.WALL_OFFSET_NS) / 1e9
        assert d["end"] == d["start"] + d["duration_s"]
    # the offset is the wall clock's, read once: within a few ms of a read now
    assert abs(time.time_ns() - _mono_ns() - port.WALL_OFFSET_NS) < 5_000_000
    # /traces and the incident bundle read the keys they read before
    ref_keys = set(ref.Span("a" * 32, "b" * 16, None, "n", "c", 1.0).to_dict())
    assert set(given.to_dict()) == ref_keys


def test_an_armed_recorder_records_the_collector_and_a_disarmed_one_does_not():
    rec = port.SpanRecorder()
    rec.arm()
    try:
        before = _mono_ns()
        gc.collect()
        after = _mono_ns()
    finally:
        rec.disarm()
    gcs = [s for s in rec.spans() if s["name"] == "host.gc"]
    full = [s for s in gcs if s["attrs"]["generation"] == 2]
    assert full and all(s["parent_id"] is None and s["component"] == "host" for s in gcs)
    assert before <= full[-1]["start_ns"] <= full[-1]["end_ns"] <= after
    assert full[-1]["attrs"]["collected"] >= 0
    n = len(rec.spans())
    gc.collect()
    assert len(rec.spans()) == n
    assert rec._on_gc not in gc.callbacks


def test_the_recorder_keeps_at_most_its_bound_and_counts_the_rest():
    rec = port.SpanRecorder(max_spans=3)
    tracer = port.Tracer(Registry(), "x", sink=rec)
    for i in range(5):
        tracer.record(f"s{i}", i, i + 1)
    assert [s["name"] for s in rec.spans()] == ["s0", "s1", "s2"] and rec.dropped == 2
