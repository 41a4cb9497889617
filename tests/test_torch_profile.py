"""The port's stage profiler against the reference's
(observability/profile.py).

The same seeded observation stream (direct observes with queue, service and
dispatch parts and batch sizes, span ingestion, an overload registry, and
build/compile events under stage labels) goes into both profilers: the
StageProfile documents are equal but for ``generated_unix``, and each side's
validator accepts the other's document. The port's build events come from
``record_build`` (nvcc/g++ runs), the reference's from
``record_synthetic_compile`` (its XLA compile hook's injection point): the
``compile`` sections agree. Tolerance: none (digests are integer bucket
counts; quantiles are the same float arithmetic).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.observability import profile as ref
from ccfd_tpu_torch.metrics.prom import Registry as PortRegistry
from ccfd_tpu_torch.observability import profile as port

STAGES = ("bus", "router.decode", "router.score", "router.route", "rest.batcher",
          "rest.dispatch", "fused.decide")


class _Span:
    def __init__(self, name, duration_s):
        self.name = name
        self.duration_s = duration_s


def _stream(seed: int = 11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(600):
        stage = STAGES[int(rng.integers(len(STAGES)))]
        kw = {}
        for comp in ("queue_s", "service_s", "dispatch_s"):
            if rng.random() < 0.5:
                kw[comp] = float(rng.lognormal(-7, 2))
        if rng.random() < 0.7:
            kw["batch"] = int(rng.integers(1, 20000))
        kw["rows"] = int(rng.integers(1, 5000))
        out.append(("observe", stage, kw))
        if rng.random() < 0.2:
            out.append(("span", str(rng.choice(["producer.batch", "engine.rest",
                                                "notify.handle", "serving.predict",
                                                "router.batch"])),
                        float(rng.lognormal(-6, 1))))
    return out


def _feed(mod, registry_cls, compile_fn, stream):
    reg, ov = registry_cls(), registry_cls()
    ov.gauge("ccfd_inflight_limit", "").set(8192, labels={"stage": "router"})
    ov.gauge("ccfd_inflight_used", "").set(17, labels={"stage": "router"})
    ov.counter("ccfd_shed_total", "").inc(3, labels={"priority": "bulk"})
    prof = mod.StageProfiler(registry=reg, overload_registry=ov)
    assert prof.arm_compile_listener()
    for item in stream:
        if item[0] == "observe":
            prof.observe(item[1], **item[2])
        else:
            prof.on_span(_Span(item[1], item[2]))
    for label, secs in (("scorer.warm", 2.5), ("scorer.warm", 0.25), ("fused.warm", 1.0)):
        with mod.compile_stage(label):
            compile_fn(secs)
    compile_fn(0.125)  # outside any label: "untagged"
    doc = prof.snapshot()
    doc.pop("generated_unix")
    return prof, reg, doc


def test_same_stream_same_stage_profile():
    stream = _stream()
    rp, rreg, rdoc = _feed(ref, RefRegistry, ref.record_synthetic_compile, stream)
    pp, preg, pdoc = _feed(port, PortRegistry, port.record_build, stream)
    assert pdoc == rdoc
    assert set(pdoc["stages"]) >= set(STAGES) | {"produce", "engine", "notify", "rest"}
    assert pdoc["compile"]["count"] == 4
    assert pp.compile_counts() == rp.compile_counts()
    full = pp.snapshot()
    assert port.validate_profile(full) == [] and ref.validate_profile(full) == []
    # the stage gauges carry the same quantiles
    rg, pg = rreg.get("ccfd_stage_latency_ms"), preg.get("ccfd_stage_latency_ms")
    assert dict(pg.items()) == dict(rg.items())


def test_latency_digest_quantiles_match():
    rng = np.random.default_rng(5)
    r, p = ref.LatencyDigest(), port.LatencyDigest()
    for v in rng.lognormal(-6, 2.5, size=5000):
        r.add(v)
        p.add(v)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert p.quantile(q) == r.quantile(q)
    assert p.to_dict() == r.to_dict()
    assert p.copy().to_dict() == r.copy().to_dict()


def test_builds_count_process_wide_and_bill_the_armed_profiler():
    before = port.builds_total()
    prof = port.StageProfiler(registry=PortRegistry())
    prof.arm_compile_listener()
    with port.compile_stage("scorer.warm"):
        port.record_build(0.5)
    assert port.builds_total() == before + 1
    assert prof.compile_counts() == {"scorer.warm": 1, "total": 1}
    # a newer profiler takes the hook (newest wins, as in the reference)
    newer = port.StageProfiler()
    newer.arm_compile_listener()
    port.record_build(0.1)
    assert prof.compile_counts()["total"] == 1 and newer.compile_counts()["total"] == 1
    assert prof.registry.get("ccfd_build_events_total").total() == 1


def test_write_is_crash_safe_with_a_sidecar(tmp_path):
    import hashlib

    prof = port.StageProfiler()
    prof.observe("bus", queue_s=0.01, rows=10)
    doc = prof.write(str(tmp_path / "profile.json"))
    body = (tmp_path / "profile.json").read_bytes()
    assert json.loads(body) == json.loads(json.dumps(doc))
    assert (tmp_path / "profile.json.sha256").read_text().strip() == \
        hashlib.sha256(body).hexdigest()


def test_profile_device_writes_a_torch_profiler_trace(tmp_path):
    import torch

    prof = port.StageProfiler()
    with prof.profile_device(str(tmp_path / "cap")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "cap" / "trace.json") > 0
    with open(tmp_path / "cap" / "device_time.json") as f:
        summary = json.load(f)
    assert summary["device_us"] == 0.0 and summary["kernels"] == {}  # no card here


@pytest.mark.parametrize("stage", ["rest", "router.coalesce"])
def test_batcher_feeds_its_stage_pair(stage):
    from ccfd_tpu_torch.serving.batcher import DynamicBatcher

    prof = port.StageProfiler()
    b = DynamicBatcher(lambda x: x[:, 0].copy(), deadline_ms=1.0, profiler=prof,
                       profile_stage=stage)
    try:
        x = np.arange(32, dtype=np.float32).reshape(16, 2)
        np.testing.assert_array_equal(b.score(x), x[:, 0])
    finally:
        b.stop()
    doc = prof.snapshot()["stages"]
    assert doc[f"{stage}.batcher"]["queue"]["count"] == 1
    assert doc[f"{stage}.dispatch"]["dispatch"]["count"] == 1
    assert doc[f"{stage}.dispatch"]["rows"] == 16
