"""The port's metrics exporter against the JAX package's.

The same registry contents (a router-like registry, a kie registry and a
tracing registry sharing a family with the router's) in each package's
``Registry``, served by each package's ``MetricsExporter`` on loopback:
``/prometheus`` (merged family-wise), ``/prometheus/<name>``,
``/rest/metrics``, HEAD, 404s and the content type must be the same, apart
from the process registry's RSS reading. ``_merge_renders`` gives the same
exposition on the same bodies, and ``/traces`` serves the same summaries
of the same spans. A histogram counts and keeps exemplars as the
reference's does.
"""

import http.client
import json

import numpy as np
import pytest

from ccfd_tpu.metrics import exporter as ref_exporter
from ccfd_tpu.metrics import prom as ref_prom
from ccfd_tpu.observability import trace as ref_trace
from ccfd_tpu_torch.metrics import exporter as port_exporter
from ccfd_tpu_torch.metrics import prom as port_prom
from ccfd_tpu_torch.observability import trace as port_trace


def _fill(prom, trace_mod):
    router, kie, tracing = prom.Registry(), prom.Registry(), prom.Registry()
    router.counter("transaction_incoming_total", "consumed").inc(2000)
    out = router.counter("transaction_outgoing_total", "starts")
    out.inc(1990, labels={"type": "standard"})
    out.inc(10, labels={"type": "fraud"})
    router.counter("router_degraded_total", "degraded").inc(3, labels={"tier": "host"})
    router.gauge("ccfd_breaker_state", "breaker").set(2, labels={"edge": "scorer"})
    h = router.histogram("router_decision_seconds", "decision latency")
    h.observe_many(np.linspace(0.0002, 2.0, 77))
    kie.histogram("fraud_approved_amount", "amounts", prom.AMOUNT_BUCKETS).observe(42.0)
    kie.counter("process_instances_started_total", "starts").inc(7, labels={"process": "fraud"})
    # one family in two registries: the merged scrape sums it
    for reg in (router, tracing):
        reg.histogram("trace_span_seconds", "span durations").observe(
            0.003, labels={"span": "router.batch"})
        reg.counter("ccfd_metric_labelsets_dropped_total")
    # the sink's own sampler metrics go to a registry of their own: the
    # exporter is under test here, not the sink's families
    sink = trace_mod.SpanSink(sample=1.0, decision_window_s=0.0, registry=prom.Registry())
    for i, name in enumerate(("router.batch", "router.decode", "router.score")):
        sp = trace_mod.Span("ab" * 16, f"{i + 1:016x}", None if i == 0 else f"{1:016x}",
                            name, "router", 100.0 + i)
        sp.duration_s = 0.001 * (i + 1)
        sink.add(sp)
    return {"router": router, "kie": kie, "tracing": tracing}, sink


def _get(port, path, method="GET", accept=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request(method, path, headers={"Accept": accept} if accept else {})
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), body


def _no_rss(body):
    return "\n".join(ln for ln in body.splitlines() if "ccfd_process_rss_bytes" not in ln)


@pytest.fixture(scope="module")
def answers():
    out = []
    for prom, trace_mod, exp_mod in ((ref_prom, ref_trace, ref_exporter),
                                     (port_prom, port_trace, port_exporter)):
        regs, sink = _fill(prom, trace_mod)
        exp = exp_mod.MetricsExporter(regs, sink=sink).start()
        port = int(exp.endpoint.rsplit(":", 1)[1])
        try:
            got = {}
            for path in ("/prometheus", "/metrics", "/prometheus/router", "/prometheus/kie",
                         "/prometheus/tracing", "/rest/metrics", "/prometheus/nope",
                         "/nope", "/traces", "/traces/" + "ab" * 16, "/traces/ffff"):
                status, ctype, body = _get(port, path)
                got[path] = (status, ctype, _no_rss(body))
            got["HEAD"] = _get(port, "/prometheus/router", "HEAD")
            mem = json.loads(_get(port, "/memory")[2])
            got["memory_keys"] = sorted(mem)
        finally:
            exp.stop()
        out.append(got)
    return out


@pytest.mark.parametrize("path", ["/prometheus", "/metrics", "/prometheus/router",
                                  "/prometheus/kie", "/prometheus/tracing", "/rest/metrics",
                                  "/prometheus/nope", "/nope", "HEAD", "memory_keys"])
def test_exporter_serves_the_same_families(answers, path):
    want, got = answers[0][path], answers[1][path]
    assert got == want


def test_exporter_serves_the_same_traces(answers):
    for path in ("/traces", "/traces/" + "ab" * 16, "/traces/ffff"):
        want, got = answers[0][path], answers[1][path]
        assert got[:2] == want[:2], path
        if want[0] == 200:
            assert json.loads(got[2]) == json.loads(want[2]), path
    summary = json.loads(answers[1]["/traces"][2])["traces"][0]
    assert summary["root"] == "router.batch" and summary["spans"] == 3


def test_merge_renders_matches_the_reference():
    bodies = []
    for prom, trace_mod in ((ref_prom, ref_trace), (port_prom, port_trace)):
        regs, _ = _fill(prom, trace_mod)
        bodies.append([r.render() for r in regs.values()])
    assert bodies[0] == bodies[1]
    merged = port_exporter._merge_renders(bodies[1])
    assert merged == ref_exporter._merge_renders(bodies[0], openmetrics=False)
    assert merged.count("# TYPE trace_span_seconds histogram") == 1
    assert 'trace_span_seconds_count{span="router.batch"} 2' in merged


def test_histogram_counts_and_exemplars_match_the_reference():
    """The port's bucket search against the reference's scan: edges, both
    infinities and NaN, with an exemplar each."""
    values = [0.0, 0.0005, 0.001, 0.0025, 0.003, 0.1, 1.0, 7.5, 10.0, 1e9,
              float("inf"), float("-inf"), float("nan"), -3.0, 2.5]
    hists = [mod.Registry().histogram("h", "help") for mod in (ref_prom, port_prom)]
    for i, v in enumerate(values):
        for h in hists:
            h.observe(v, labels={"k": str(i % 3)}, exemplar={"trace_id": f"t{i}"})
    want, got = hists
    assert got.buckets == want.buckets
    assert got._counts == want._counts
    strip = {k: {b: (ex, val) for b, (ex, val, _t) in d.items()}
             for k, d in want._exemplars.items()}
    assert {k: {b: (ex, val) for b, (ex, val, _t) in d.items()}
            for k, d in got._exemplars.items()} == strip
