"""The port's capacity observatory against the reference's.

``ccfd_tpu_torch/observability/capacity.py`` and the reference's
``ccfd_tpu/observability/capacity.py`` are fed the same synthetic stage
profile (each package's ``StageProfiler``, observed with the same samples,
under the same fake clock, the ``_Clock`` of ``tests/test_capacity.py``).
Every scenario of that file is here but the diurnal regime, which is
timing-sensitive and no oracle (ROADMAP C); its flash regime drives the
reference's ``tools/load_shape.py`` pipeline live, so here the same
flash-crowd shape (a bus backlog ten times its base wait over steady router
stages) is fed to both models as a recorded profile. Tolerances: every
number of the documents and the what-if answers equal to 1e-9 relative
(the two packages run the same float64 arithmetic), the wall-clock stamps
(``generated_unix``, ``fitted_unix``) excepted; both documents validate
under both packages' ``validate_capacity``.
"""

from __future__ import annotations

import json
import math
import os
import urllib.error
import urllib.request

import pytest

from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.observability import capacity as ref_cap
from ccfd_tpu.observability.profile import StageProfiler as RefProfiler
from ccfd_tpu_torch.metrics.exporter import MetricsExporter
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.observability import capacity as port_cap
from ccfd_tpu_torch.observability.profile import StageProfiler

REL = 1e-9
_WALL = ("generated_unix", "fitted_unix")


class _Clock:
    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def assert_same(got, want, path="doc"):
    """``got`` equals ``want`` key for key, numbers to ``REL`` relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            if k in _WALL:
                continue
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), (path, got)
        assert math.isclose(got, want, rel_tol=REL, abs_tol=1e-12), (path, got, want)
    else:
        assert got == want, (path, got, want)


class Twin:
    """One CapacityModel per package over its own profiler, fed the same
    samples and refreshed at the same fake times."""

    def __init__(self, registry: bool = False, **kw):
        self.clock = [_Clock(), _Clock()]
        self.prof = [RefProfiler(), StageProfiler()]
        self.reg = [RefRegistry(), Registry()] if registry else [None, None]
        self.model = [ref_cap.CapacityModel(self.prof[0], registry=self.reg[0],
                                            clock=self.clock[0], **kw),
                      port_cap.CapacityModel(self.prof[1], registry=self.reg[1],
                                             clock=self.clock[1], **kw)]

    def observe(self, stage, **kw):
        for p in self.prof:
            p.observe(stage, **kw)

    def feed(self, *, n=40, bus_wait_s=0.010, dispatch_s=0.004, route_s=0.001, batch=1024):
        """One window of the reference test's traffic: bus queueing drained
        by router.score dispatches, plus router.route service time."""
        for _ in range(n):
            self.observe("bus", queue_s=bus_wait_s, rows=batch)
            self.observe("router.score", dispatch_s=dispatch_s, batch=batch, rows=batch)
            self.observe("router.route", service_s=route_s, rows=batch)

    def set_actuators(self, **kw):
        for m in self.model:
            m.set_actuators(**kw)

    def refresh(self):
        docs = [m.refresh() for m in self.model]
        assert (docs[0] is None) == (docs[1] is None)
        if docs[0] is not None:
            assert_same(docs[1], docs[0])
        return docs[1]

    def tick(self, dt=1.0):
        for c in self.clock:
            c.t += dt

    def call(self, method, *a, **kw):
        """Both models' answer to ``method``; asserts equal, returns the port's."""
        ref, port = (getattr(m, method)(*a, **kw) for m in self.model)
        assert_same(port, ref)
        for doc in (ref, port):
            if isinstance(doc, dict) and "schema" in doc:
                assert port_cap.validate_capacity(doc) == []
                assert ref_cap.validate_capacity(doc) == []
        return port

    def regressions(self, stage):
        vals = [int(r.counter("ccfd_capacity_regression_total").value(labels={"stage": stage}))
                for r in self.reg]
        assert vals[0] == vals[1]
        return vals[1]


def _fitted(**kw) -> Twin:
    """Two bracketed fit windows behind both models."""
    tw = Twin(min_samples=10, **kw)
    tw.set_actuators(workers=2, batch=1024, deadline_ms=1.0, max_inflight=4096)
    tw.feed()
    assert tw.refresh() is None  # the first tick only opens the window
    tw.tick()
    tw.feed()
    assert tw.refresh() is not None
    tw.tick()
    tw.feed()
    tw.refresh()
    return tw


def test_the_module_constants_are_the_references():
    assert port_cap.CAPACITY_SCHEMA == ref_cap.CAPACITY_SCHEMA
    assert port_cap.BASELINE_SCHEMA == ref_cap.BASELINE_SCHEMA
    assert dict(port_cap.STAGE_LAYERS) == dict(ref_cap.STAGE_LAYERS)
    assert dict(port_cap.QUEUE_DRAINS) == dict(ref_cap.QUEUE_DRAINS)
    assert dict(port_cap.QUEUE_FEEDS) == dict(ref_cap.QUEUE_FEEDS)
    # the stages the port's profiler feeds and the reference's leaves empty
    # bill as the reference's map bills them (ROADMAP C)
    for stage in ("rest", "rest.batcher", "rest.dispatch", "router.coalesce.batcher",
                  "router.coalesce.dispatch"):
        assert port_cap.stage_layer(stage) == ref_cap.stage_layer(stage)


def test_refresh_fits_windowed_rates_and_document_validates():
    tw = _fitted()
    doc = tw.call("snapshot")
    assert doc["schema"] == port_cap.CAPACITY_SCHEMA
    stages = doc["stages"]
    assert stages["bus"]["layer"] == "queue"
    assert stages["router.score"]["layer"] == "dispatch"
    assert stages["router.route"]["layer"] == "service"
    assert 30.0 <= stages["router.score"]["arrival_batches_per_s"] <= 50.0
    assert 3.0 <= stages["router.score"]["mean_service_ms"] <= 5.0
    assert "1024" in stages["router.score"]["fitted_curve_ms"]
    assert doc["e2e"]["predicted_p99_ms"] > 0 and "error_ratio" in doc["e2e"]
    assert doc["bottleneck"]["stage"] in stages
    assert_same(tw.call("breach_summary"), tw.model[0].breach_summary())


def test_validate_capacity_names_failures():
    doc = _fitted().call("snapshot")
    doc["schema"] = "nope"
    del doc["e2e"]["predicted_p99_ms"]
    doc["bottleneck"] = {"stage": "ghost.stage"}
    errs = port_cap.validate_capacity(doc)
    assert errs == ref_cap.validate_capacity(doc)
    assert any("schema" in e for e in errs)
    assert any("e2e.predicted_p99_ms" in e for e in errs)
    assert any("ghost.stage" in e for e in errs)
    assert port_cap.validate_capacity("not a mapping") == ["document: not a mapping"]


@pytest.mark.parametrize("move,sign", [
    ({}, 0), ({"workers": 1}, 1), ({"workers": 4}, -1), ({"max_inflight": 1024}, -1),
    ({"batch": 128}, 0), ({"workers": 3, "max_inflight": 2048, "deadline_ms": 4.0}, 0),
], ids=["none", "workers=1", "workers=4", "max_inflight=1024", "batch=128", "combined"])
def test_whatif_answers_equal_the_references(move, sign):
    """The what-if directions of the reference's tests (no move is the
    measured steady state; fewer workers raise the p99 through the queue the
    dispatch stage drains; more workers and a tighter admission ceiling
    lower it), each answer equal to the reference's."""
    tw = _fitted()
    doc = tw.call("whatif", **move)
    assert doc["whatif"]["requested"] == move
    delta = doc["whatif"]["delta_p99_ms"]
    if sign > 0:
        assert delta > 0.0
        assert doc["stages"]["bus"]["predicted_p99_ms"] > \
            tw.model[1].snapshot()["stages"]["bus"]["predicted_p99_ms"]
    elif sign < 0:
        assert delta <= 0.0
    elif not move:
        assert delta == 0.0


def test_whatif_longer_batcher_deadline_raises_rest_wait():
    tw = Twin(min_samples=10)
    tw.set_actuators(workers=2, deadline_ms=1.0)
    for _ in range(2):
        for _i in range(40):
            tw.observe("rest.batcher", queue_s=0.0008, rows=64)
            tw.observe("rest.dispatch", dispatch_s=0.002, batch=64, rows=64)
        tw.refresh()
        tw.tick()
    assert tw.call("whatif", deadline_ms=10.0)["whatif"]["delta_p99_ms"] > 0.0


def test_sentinel_fires_once_per_excursion_with_hysteresis_rearm():
    tw = Twin(registry=True, regression_tolerance=1.0, min_samples=10)

    def window(route_ms: float, bus_ms: float = 10.0) -> None:
        tw.feed(route_s=route_ms / 1e3, bus_wait_s=bus_ms / 1e3)
        tw.refresh()
        tw.tick()

    for _ in range(3):
        window(1.0)
    assert tw.regressions("router.route") == 0
    for _ in range(4):
        window(5.0, bus_ms=400.0)
    assert tw.regressions("router.route") == 1
    entry = tw.call("snapshot")["stages"]["router.route"]["regression"]
    assert entry["in_regression"] is True and entry["fired_total"] == 1
    for _ in range(6):
        window(1.0)
    assert tw.regressions("router.route") == 1
    for _ in range(4):
        window(5.0, bus_ms=400.0)
    assert tw.regressions("router.route") == 2
    assert tw.regressions("bus") == 0
    assert "regression" not in tw.call("snapshot")["stages"]["bus"]
    # the gauges the exporter serves are the reference's, value for value
    for name in ("ccfd_capacity_model_error_ratio", "ccfd_capacity_headroom_ratio",
                 "ccfd_capacity_utilization", "ccfd_capacity_bottleneck",
                 "ccfd_capacity_predicted_p99_ms"):
        ref, port = (dict(r.gauge(name).items()) for r in tw.reg)
        assert_same(port, ref, name)


def test_baseline_persists_and_reloads_through_the_durability_seam(tmp_path):
    paths = [str(tmp_path / "ref.json"), str(tmp_path / "port.json")]
    clocks = [_Clock(), _Clock()]
    profs = [RefProfiler(), StageProfiler()]
    models = [mod.CapacityModel(p, clock=c, baseline_path=path, regression_tolerance=1.0,
                                min_samples=10)
              for mod, p, c, path in zip((ref_cap, port_cap), profs, clocks, paths)]
    for _ in range(3):
        for p in profs:
            for _i in range(40):
                p.observe("bus", queue_s=0.01, rows=1024)
                p.observe("router.score", dispatch_s=0.004, batch=1024, rows=1024)
                p.observe("router.route", service_s=0.001, rows=1024)
        for m, c in zip(models, clocks):
            m.refresh()
            c.t += 1.0
    docs = []
    for path in paths:
        with open(path) as f:
            docs.append(json.load(f))
        assert os.path.exists(path + ".sha256")  # the crash-safe write's sidecar
    assert docs[1]["schema"] == port_cap.BASELINE_SCHEMA
    assert_same(docs[1], docs[0])
    baseline = docs[1]["stages"]["router.route"]["mean_service_ms"]
    assert 0.5 <= baseline <= 2.0
    # a restarted model alerts against the persisted baseline; the port's
    # reads the reference's file and the reference's the port's
    for mod, path in ((port_cap, paths[0]), (ref_cap, paths[1]), (port_cap, paths[1])):
        reg = Registry() if mod is port_cap else RefRegistry()
        clock = _Clock()
        prof = StageProfiler() if mod is port_cap else RefProfiler()
        model = mod.CapacityModel(prof, registry=reg, clock=clock, baseline_path=path,
                                  regression_tolerance=1.0, min_samples=10)
        for _ in range(3):
            for _i in range(40):
                prof.observe("bus", queue_s=0.01, rows=1024)
                prof.observe("router.score", dispatch_s=0.004, batch=1024, rows=1024)
                prof.observe("router.route", service_s=0.005, rows=1024)
            model.refresh()
            clock.t += 1.0
        assert int(reg.counter("ccfd_capacity_regression_total").value(
            labels={"stage": "router.route"})) == 1
        snap = model.snapshot()
        assert snap["stages"]["router.route"]["regression"]["baseline_mean_ms"] == baseline
        assert snap["model"]["baseline_source"] == path


def test_corrupt_baseline_is_refused_not_alerted_against(tmp_path):
    path = str(tmp_path / "capacity_baseline.json")
    tw = Twin(min_samples=10, baseline_path=path)
    for _ in range(3):
        tw.feed()
        tw.refresh()
        tw.tick()
    with open(path, "a") as f:
        f.write("torn")  # the sidecar's hash no longer matches
    from ccfd_tpu_torch.runtime import durability

    assert durability.verify_interchange(path) is False
    assert durability.verify_interchange(str(tmp_path / "absent.json")) is None
    model = port_cap.CapacityModel(StageProfiler(), baseline_path=path, min_samples=10)
    assert model.snapshot()["model"]["baseline_source"] is None


def test_capacity_endpoints_and_healthz_over_http():
    tw = _fitted()
    model = tw.model[1]
    health: dict = {"healthy": True, "sources": {}, "causes": []}
    exp = MetricsExporter({"m": Registry()}, capacity=model,
                          health=lambda: dict(health)).start()
    off = MetricsExporter({"m": Registry()}).start()
    try:
        with urllib.request.urlopen(exp.endpoint + "/capacity") as r:
            assert r.headers["Content-Type"] == "application/json"
            doc = json.loads(r.read())
        assert port_cap.validate_capacity(doc) == []
        assert_same(doc, tw.model[0].snapshot())
        with urllib.request.urlopen(exp.endpoint + "/capacity/whatif?workers=1") as r:
            wi = json.loads(r.read())
        assert wi["whatif"]["requested"] == {"workers": 1}
        assert_same(wi, tw.model[0].whatif(workers=1))
        with urllib.request.urlopen(
                exp.endpoint + "/capacity/whatif?workers=x&deadline_ms=4") as r:
            assert json.loads(r.read())["whatif"]["requested"] == {"deadline_ms": 4.0}
        with urllib.request.urlopen(exp.endpoint + "/healthz") as r:
            assert r.status == 200 and json.loads(r.read())["healthy"] is True
        health.update(healthy=False, causes=["supervisor: scorer=backoff (boom)"])
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(exp.endpoint + "/healthz")
        assert e.value.code == 503 and json.loads(e.value.read())["causes"]
        # the plane off: both endpoints 404, as /healthz with no composer
        for path in ("/capacity", "/capacity/whatif?workers=2", "/healthz"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(off.endpoint + path)
            assert e.value.code == 404
    finally:
        exp.stop()
        off.stop()


def test_flash_regime_bottleneck_is_the_queueing_stage():
    """The flash claim on a recorded shape: a crowd parks its backlog in
    the bus (its wait grows tenfold and the batches come twice as fast)
    while the router's stages keep their cost; the model attributes the
    bottleneck to the queueing stage at the crowd's height, and does not
    under-predict the pressure the callers feel."""
    tw = Twin(min_samples=30, regression_tolerance=3.0)
    tw.set_actuators(workers=2, batch=4096, max_inflight=8192)
    docs = []
    for step in range(12):
        crowd = 4 <= step < 9
        tw.feed(n=80 if crowd else 40, bus_wait_s=(0.25 if crowd else 0.004) * (1 + step % 3),
                dispatch_s=0.006, route_s=0.0008, batch=4096 if crowd else 1024)
        doc = tw.refresh()
        tw.tick(0.4)
        if doc is not None and crowd:
            docs.append(doc)
    assert docs
    doc = min(docs, key=lambda d: d["stages"]["bus"]["headroom_ratio"])
    assert port_cap.validate_capacity(doc) == []
    bn = doc["bottleneck"]
    assert bn["stage"] == "bus" and bn["layer"] == "queue", bn
    assert doc["stages"]["bus"]["utilization"] > 0.3
    err = doc["e2e"].get("error_ratio")
    assert err is not None and math.isfinite(err)
    assert doc["e2e"]["predicted_p99_ms"] >= 0.5 * doc["e2e"]["observed_p99_ms"]


def test_the_ports_extra_stages_bill_as_the_references_map_bills_them():
    """The native front's ``rest`` and the parallel router's
    ``router.coalesce.*`` stages, which the reference's profiler leaves
    empty: the coalescing stages carry no component the map reads and
    never enter the fit, and the enclosing ``rest`` stage is summed into
    the e2e prediction beside its own parts, in both packages alike
    (ROADMAP C)."""
    tw = Twin(min_samples=10)
    tw.set_actuators(workers=1, deadline_ms=2.0)
    for _ in range(3):
        for _i in range(30):
            tw.observe("rest.batcher", queue_s=0.0005, rows=16)
            tw.observe("rest.dispatch", dispatch_s=0.001, batch=16, rows=16)
            tw.observe("rest", service_s=0.002, rows=16)
            tw.observe("router.coalesce.batcher", queue_s=0.0003, rows=64)
            tw.observe("router.coalesce.dispatch", dispatch_s=0.002, batch=64, rows=64)
        tw.refresh()
        tw.tick()
    doc = tw.call("snapshot")
    for stage in ("router.coalesce.batcher", "router.coalesce.dispatch"):
        entry = doc["stages"][stage]
        assert entry["layer"] == "service" and entry["samples"] == 0
        assert "predicted_p99_ms" not in entry
    assert doc["stages"]["rest"]["samples"] > 0
    summed = sum(doc["stages"][s]["observed_p99_ms"]
                 for s in ("rest", "rest.batcher", "rest.dispatch"))
    assert math.isclose(doc["e2e"]["observed_p99_ms"], round(summed, 4), rel_tol=1e-6)
