"""The port's SLO engine and budget ledger against the reference's
(observability/slo.py).

The same seeded observation stream (decision and REST latencies, incoming
and failed starts, a burst of slow decisions and failures that breaches and
then recovers) lands in a registry on each side; both engines, built by
``SLOEngine.from_config`` from the CR's ``slo:`` block and the ``CCFD_SLO*``
environment, tick on the same explicit clock. The status documents (burn
rate per window, budget remaining, breaching, breach counts, the REST
budget ledger over the stage profiler and the device telemetry's H2D
digest) and the breach edges the listeners see are equal tick for tick.
Tolerance: none.
"""

from __future__ import annotations

import numpy as np
import pytest

from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.observability import device as ref_device
from ccfd_tpu.observability import profile as ref_profile
from ccfd_tpu.observability import slo as ref_slo
from ccfd_tpu_torch.config import Config as PortConfig
from ccfd_tpu_torch.metrics.prom import Registry as PortRegistry
from ccfd_tpu_torch.observability import device as port_device
from ccfd_tpu_torch.observability import profile as port_profile
from ccfd_tpu_torch.observability import slo as port_slo

ENV = {"CCFD_SLO_WINDOWS": "30,120,600", "CCFD_SLO_FAST_BURN": "6",
       "CCFD_SLO_E2E_TARGET_MS": "40", "CCFD_SLO_REST_TARGET_MS": "20"}
CR_SPECS = [
    {"name": "e2e-p99", "kind": "latency", "metric": "router_decision_seconds",
     "target_ms": 40.0, "objective": 0.99},
    {"name": "rest-p99", "kind": "latency",
     "metric": "seldon_api_executor_client_requests_seconds", "target_ms": 20.0,
     "objective": 0.99},
    {"name": "error-rate", "kind": "error_rate", "metric": "transaction_incoming_total",
     "error_metric": "router_process_start_errors_total", "max_error_rate": 0.01},
]


def _run(cfg_cls, reg_cls, slo, profile, device, options) -> list:
    cfg = cfg_cls.from_env(ENV)
    router, seldon, slo_reg = reg_cls(), reg_cls(), reg_cls()
    regs = {"router": router, "seldon": seldon, "slo": slo_reg}
    prof = profile.StageProfiler(registry=slo_reg)
    tel = device.DeviceTelemetry(registry=reg_cls())
    eng = slo.SLOEngine.from_config(cfg, regs, slo_reg, profiler=prof, options=options,
                                    telemetry=tel)
    edges = []
    eng.add_breach_listener(lambda name, doc: edges.append(name))
    h_dec = router.histogram("router_decision_seconds", "")
    h_rest = seldon.histogram("seldon_api_executor_client_requests_seconds", "")
    c_in = router.counter("transaction_incoming_total", "")
    c_err = router.counter("router_process_start_errors_total", "")
    rng = np.random.default_rng(21)
    out = []
    for tick in range(120):
        bad = 40 <= tick < 55  # the incident
        n = int(rng.integers(50, 200))
        dec = rng.lognormal(np.log(0.08 if bad else 0.01), 0.5, size=n)
        h_dec.observe_many(dec)
        for v in rng.lognormal(np.log(0.005), 0.6, size=20):
            h_rest.observe(float(v), labels={"endpoint": "/api/v0.1/predictions"})
        c_in.inc(n)
        if bad:
            c_err.inc(int(rng.integers(10, 30)), labels={"type": "fraud"})
        for _ in range(5):
            prof.observe("rest.batcher", queue_s=float(rng.lognormal(-8, 1)), rows=16)
            prof.observe("rest.dispatch", dispatch_s=float(rng.lognormal(-7, 1)), batch=16,
                         rows=16)
            tel.record_h2d(16 * 30 * 2, float(rng.lognormal(-10, 0.5)))
        out.append(eng.tick(now=1000.0 + 5.0 * tick))
    out.append(edges)
    out.append({s.name: eng.breaches(s.name) for s in eng.specs})
    return out


@pytest.mark.parametrize("options", [{}, {"specs": CR_SPECS, "windows": [20, 90, 400],
                                          "budget": {"h2d": 0.25}}])
def test_same_stream_same_burn_rates_and_breach_edges(options):
    ref = _run(RefConfig, RefRegistry, ref_slo, ref_profile, ref_device, options)
    port = _run(PortConfig, PortRegistry, port_slo, port_profile, port_device, options)
    assert port == ref
    edges = port[-2]
    assert "e2e-p99" in edges and "error-rate" in edges  # the incident breached
    assert not port[-3]["slos"]["e2e-p99"]["breaching"]  # and recovered
    assert port[-3]["budget_ledger"]["layers"]["h2d"]["count"] == 600


def test_config_reads_the_slo_knobs_as_the_reference():
    env = {**ENV, "CCFD_SLO": "0", "CCFD_SLO_INTERVAL_S": "2.5", "CCFD_SLO_OBJECTIVE": "0.995",
           "CCFD_SLO_MAX_ERROR_RATE": "0.02", "CCFD_SLO_TRANSPORT_FLOOR_MS": "0.1",
           "CCFD_DEVICE": "0", "CCFD_STORAGE_RETAIN": "5", "CCFD_STORAGE_FSYNC": "0",
           "s3bucket": "b1", "filename": "f.csv", "ACCESS_KEY_ID": "a",
           "SECRET_ACCESS_KEY": "s", "s3endpoint": "http://x"}
    got, want = PortConfig.from_env(env), RefConfig.from_env(env)
    for f in ("slo_enabled", "slo_interval_s", "slo_e2e_target_ms", "slo_rest_target_ms",
              "slo_objective", "slo_max_error_rate", "slo_windows", "slo_fast_burn",
              "slo_transport_floor_ms", "device_enabled", "storage_retain", "storage_fsync",
              "storage_sweep", "s3_bucket", "filename", "access_key_id",
              "secret_access_key", "s3_endpoint", "mesh_devices"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.unported() == []  # the object store is ported


def test_spec_parsing_refuses_unknown_keys_as_the_reference():
    with pytest.raises(ValueError, match="unknown keys"):
        port_slo.SLOSpec.from_mapping({"name": "x", "typo": 1})
    with pytest.raises(ValueError, match="unknown keys"):
        ref_slo.SLOSpec.from_mapping({"name": "x", "typo": 1})
    for m in CR_SPECS:
        assert dataclass_tuple(port_slo.SLOSpec.from_mapping(m)) == \
            dataclass_tuple(ref_slo.SLOSpec.from_mapping(m))


def dataclass_tuple(spec) -> tuple:
    import dataclasses

    return dataclasses.astuple(spec)


def test_trace_correlated_json_logs_match_the_references():
    """observability/slog.py: the same records, with and without an active
    span, format to the same JSON on both sides (the component, the
    trace and span ids, extra fields, the reserved-key prefix)."""
    import io
    import json
    import logging

    from ccfd_tpu.observability import slog as ref_slog
    from ccfd_tpu.observability import trace as ref_trace
    from ccfd_tpu_torch.observability import slog as port_slog
    from ccfd_tpu_torch.observability import trace as port_trace

    def lines(slog, trace, ns):
        buf = io.StringIO()
        log = slog.configure("platform", f"{ns}.t", stream=buf)
        log.warning("plain %d", 7, extra={"tier": "host", "component": "clash"})
        token = trace._current.set(trace.SpanContext("ab" * 16, "cd" * 8))
        try:
            log.error("in a span", extra={"rows": [1, 2], "obj": object()})
            body = json.loads(slog.span_fields("fields", a=1))
        finally:
            trace._current.reset(token)
        assert slog.configure("platform", f"{ns}.t", stream=buf).handlers == log.handlers
        out = [json.loads(x) for x in buf.getvalue().splitlines()]
        for o in out:
            o.pop("ts")
            o["logger"] = o["logger"].split(".", 1)[1]
            o["obj"] = "<object>" if "obj" in o else None
        body.pop("ts")
        return out, body

    assert lines(port_slog, port_trace, "ccfd_tpu_torch") == \
        lines(ref_slog, ref_trace, "ccfd_tpu")
    assert logging.getLogger("ccfd_tpu_torch.t").propagate is False
