"""The port's incident flight recorder against the reference's.

``ccfd_tpu_torch/observability/incident.py`` and the reference's
``ccfd_tpu/observability/incident.py``, each over its own package's SLO
engine, profiler and registries, driven by the same stimuli under the same
fake clock: the behaviours of ``tests/test_incident.py`` (the bounded ring,
the breach edge with exactly one bundle per entry and a second after a
recovery, pruning with the bundle files, torn writes at the durability
seam, the memory-only mode, the exporter's contract, the watchdog hook and
its debounce). Each run is held to the reference's: the same incident ids,
triggers, ring reasons and depths, counter totals and deltas, and the same
snapshot and bundle keys. Every port bundle passes the reference's
``validate_incident`` as well as the port's, with no named exception: the
schema, the sections and their shapes are the reference's. What differs
by design is named where it shows: the watched build counter
(``ccfd_build_events_total`` for ``ccfd_xla_compile_events_total``) and
the device section's contents (the port's device document).
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request

import pytest

from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.observability import incident as ref_inc
from ccfd_tpu.observability.profile import StageProfiler as RefProfiler
from ccfd_tpu.observability.slo import SLOEngine as RefEngine
from ccfd_tpu.observability.slo import SLOSpec as RefSpec
from ccfd_tpu_torch.metrics.exporter import MetricsExporter
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.observability import incident as port_inc
from ccfd_tpu_torch.observability.profile import StageProfiler
from ccfd_tpu_torch.observability.slo import SLOEngine, SLOSpec

PKGS = {
    "ref": (RefRegistry, RefEngine, RefSpec, RefProfiler, ref_inc),
    "port": (Registry, SLOEngine, SLOSpec, StageProfiler, port_inc),
}


def _stack(pkg: str, out_dir=None, ring: int = 8):
    reg_cls, engine_cls, spec_cls, prof_cls, mod = PKGS[pkg]
    regs = {"router": reg_cls(), "slo": reg_cls(), "incident": reg_cls()}
    hist = regs["router"].histogram("lat_seconds", "x")
    spec = spec_cls("rest-p99", kind="latency", metric="lat_seconds", target_ms=25.0,
                    objective=0.99)
    clock = [0.0]
    engine = engine_cls([spec], regs, registry=regs["slo"],
                        windows=((3.0, 14.4), (6.0, 14.4), (20.0, 1.0)),
                        clock=lambda: clock[0])
    rec = mod.FlightRecorder(regs, registry=regs["incident"], profiler=prof_cls(), ring=ring,
                             out_dir=str(out_dir) if out_dir is not None else None,
                             clock=lambda: clock[0])
    engine.add_breach_listener(rec.on_breach)
    return engine, rec, hist, clock, regs


def _twins(tmp_path=None, ring: int = 8):
    return {pkg: _stack(pkg, (tmp_path / pkg) if tmp_path is not None else None, ring)
            for pkg in PKGS}


def _burn(hist, n=100, bad=True):
    hist.observe_many([0.2 if bad else 0.001] * n)


def _summaries(rec):
    return [{k: v for k, v in s.items() if k != "path"} for s in rec.incidents()]


def _valid_both(doc):
    assert port_inc.validate_incident(doc) == []
    assert ref_inc.validate_incident(doc) == []


def test_the_schema_and_the_watched_families_are_the_references_after_the_name_map():
    assert port_inc.INCIDENT_SCHEMA == ref_inc.INCIDENT_SCHEMA == "ccfd.incident.v3"
    renamed = {"ccfd_xla_compile_events_total": "ccfd_build_events_total"}
    assert port_inc.WATCHED_COUNTERS == tuple(renamed.get(n, n)
                                              for n in ref_inc.WATCHED_COUNTERS)
    assert port_inc.WATCHED_GAUGES == ref_inc.WATCHED_GAUGES


def test_the_ring_is_bounded():
    for pkg in PKGS:
        _eng, rec, _h, _clock, _regs = _stack(pkg, ring=4)
        for i in range(10):
            rec.snapshot(reason=f"r{i}")
        assert [s["reason"] for s in rec.ring] == ["r6", "r7", "r8", "r9"], pkg


def test_snapshot_contents_and_deltas():
    snaps = {}
    for pkg, (_eng, rec, _h, _clock, regs) in _twins().items():
        regs["router"].counter("transaction_incoming_total").inc(100)
        s1 = rec.snapshot()
        regs["router"].counter("transaction_incoming_total").inc(50)
        s2 = rec.snapshot()
        assert s1["counters"]["transaction_incoming_total"] == 100
        assert s2["counter_deltas"]["transaction_incoming_total"] == 50
        assert s1["memory"]["rss_bytes"] > 0
        snaps[pkg] = (s1, s2)
    for a, b in zip(snaps["ref"], snaps["port"]):
        assert set(a) == set(b)
        assert a["counters"] == b["counters"] and a["counter_deltas"] == b["counter_deltas"]
        assert a["gauges"] == b["gauges"] and a["reason"] == b["reason"]


def test_ring_gauge_and_reason_counter():
    for pkg, (_eng, rec, _h, _clock, regs) in _twins().items():
        rec.snapshot()
        rec.note_dispatch_timeout()
        reg = regs["incident"]
        assert reg.gauge("ccfd_incident_ring_size").value() == 2, pkg
        assert reg.counter("ccfd_incident_snapshots_total").value(
            {"reason": "dispatch_timeout"}) == 1, pkg


def test_exactly_one_bundle_a_breach_then_a_rebreach_dumps_again(tmp_path):
    seen = {}
    for pkg, (engine, rec, hist, clock, _regs) in _twins(tmp_path).items():
        trail = []
        _burn(hist, bad=False)
        clock[0] = 1.0
        engine.tick()
        trail.append(len(rec.incidents()))
        _burn(hist)
        clock[0] = 2.0
        engine.tick()
        trail.append(len(rec.incidents()))
        _burn(hist)
        for t in (3.0, 4.0):
            clock[0] = t
            engine.tick()
        trail.append(len(rec.incidents()))
        clock[0] = 30.0
        _burn(hist, bad=False)
        engine.tick()
        assert not engine.tick()["slos"]["rest-p99"]["breaching"]
        _burn(hist, n=200)
        clock[0] = 31.0
        engine.tick()
        trail += [len(rec.incidents()), engine.breaches("rest-p99")]
        assert trail == [0, 1, 1, 2, 2], (pkg, trail)
        seen[pkg] = _summaries(rec)
        for s in rec.incidents():
            _valid_both(rec.incident_doc(s["id"]))
    assert seen["port"] == seen["ref"]


def test_bundle_shape_and_validation(tmp_path):
    docs = {}
    for pkg, (engine, rec, hist, clock, _regs) in _twins(tmp_path).items():
        rec.snapshot()  # the pre-incident flight data
        _burn(hist)
        clock[0] = 2.0
        engine.tick()
        (summary,) = rec.incidents()
        doc = rec.incident_doc(summary["id"])
        assert doc["trigger"] == {"type": "slo_breach", "slo": "rest-p99"}
        assert doc["slo_status"]["slos"]["rest-p99"]["breaching"]
        assert len(doc["ring"]) >= 2
        with open(doc["path"]) as f:
            assert json.load(f)["id"] == doc["id"]
        docs[pkg] = doc
    _valid_both(docs["port"])
    # the reference's validator reads the port's bundle off disk as well
    with open(docs["port"]["path"]) as f:
        assert ref_inc.validate_incident(json.load(f)) == []
    assert set(docs["port"]) == set(docs["ref"])
    for k in ("id", "schema", "trigger"):
        assert docs["port"][k] == docs["ref"][k]
    assert [s["reason"] for s in docs["port"]["ring"]] == \
        [s["reason"] for s in docs["ref"]["ring"]]
    assert set(docs["port"]["snapshot"]) == set(docs["ref"]["snapshot"])
    assert docs["port"]["slo_status"]["slos"] == docs["ref"]["slo_status"]["slos"]


def test_max_bundles_are_pruned_with_their_files(tmp_path):
    for pkg, (_eng, rec, _h, _clock, _regs) in _twins(tmp_path).items():
        rec.max_bundles = 2
        for _ in range(4):
            rec.incident({"type": "slo_breach", "slo": "x"})
        assert [s["id"] for s in rec.incidents()] == ["inc-0004-x", "inc-0003-x"], pkg
        files = sorted(f for f in os.listdir(tmp_path / pkg) if f.endswith(".json"))
        assert files == ["inc-0003-x.json", "inc-0004-x.json"], pkg


def test_a_torn_write_leaves_the_previous_bundle_intact(tmp_path):
    from ccfd_tpu_torch.observability import profile as profile_mod
    from ccfd_tpu_torch.runtime import faults

    _eng, rec, _h, _clock, _regs = _stack("port", tmp_path)
    first = rec.incident({"type": "slo_breach", "slo": "a"})
    path = first["path"]
    with open(path) as f:
        before = f.read()
    faults.install_storage_faults(faults.StorageFaultPlan.from_string("torn_write"))
    try:
        with pytest.raises(OSError):
            profile_mod.write_json_crash_safe(path, {"x": 1})
    finally:
        faults.install_storage_faults(None)
    with open(path) as f:
        assert f.read() == before
    with open(path) as f:
        assert json.load(f)["id"] == first["id"]


def test_the_memory_only_mode_serves_without_disk():
    _eng, rec, _h, _clock, _regs = _stack("port")
    doc = rec.incident({"type": "slo_breach", "slo": "a"})
    assert "path" not in doc and rec.incident_doc(doc["id"]) is not None
    assert rec.last_incident_id() == doc["id"]


def test_the_incidents_http_contract(tmp_path):
    engine, rec, hist, clock, regs = _stack("port", tmp_path)
    ex = MetricsExporter(regs, recorder=rec).start()
    off = MetricsExporter({"r": Registry()}).start()
    try:
        with urllib.request.urlopen(ex.endpoint + "/incidents", timeout=10) as r:
            assert r.status == 200
            assert json.loads(r.read().decode()) == {"incidents": []}
        _burn(hist)
        clock[0] = 2.0
        engine.tick()
        with urllib.request.urlopen(ex.endpoint + "/incidents", timeout=10) as r:
            listing = json.loads(r.read().decode())
        assert len(listing["incidents"]) == 1
        inc_id = listing["incidents"][0]["id"]
        with urllib.request.urlopen(ex.endpoint + f"/incidents/{inc_id}", timeout=10) as r:
            assert r.headers["Content-Type"] == "application/json"
            _valid_both(json.loads(r.read().decode()))
        for base, path in ((ex.endpoint, "/incidents/inc-bogus"), (off.endpoint, "/incidents"),
                           (off.endpoint, f"/incidents/{inc_id}")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + path, timeout=10)
            assert ei.value.code == 404
    finally:
        ex.stop()
        off.stop()


def test_validation_names_failures():
    for doc in (None, {"schema": "wrong"}, {"schema": port_inc.INCIDENT_SCHEMA, "ring": [1]}):
        assert port_inc.validate_incident(doc) == ref_inc.validate_incident(doc)
    errs = port_inc.validate_incident({"schema": "wrong"})
    for field in ("schema:", "id:", "trigger:", "ring:"):
        assert any(e.startswith(field) for e in errs), field
    _eng, rec, _h, _clock, _regs = _stack("port")
    doc = dict(rec.incident({"type": "slo_breach", "slo": "a"}))
    doc["stage_profile"] = {"schema": "nope"}
    assert any(e.startswith("stage_profile.") for e in port_inc.validate_incident(doc))


def test_a_dispatch_timeout_snapshots_into_the_ring():
    from ccfd_tpu_torch.runtime.overload import AdaptiveInflightBudget, OverloadControl
    from ccfd_tpu_torch.serving.dispatch import ScorerTimeout

    reg = Registry()
    ov = OverloadControl(reg, AdaptiveInflightBudget(100, registry=reg, stage="router"),
                         dispatch_deadline_ms=50.0)
    rec = port_inc.FlightRecorder({"router": reg}, registry=reg, ring=4)
    ov.recorder = rec
    with pytest.raises(ScorerTimeout):
        ov.bounded_dispatch(lambda: time.sleep(0.5))
    assert reg.counter("ccfd_dispatch_timeout_total").value() == 1
    assert [s["reason"] for s in rec.ring] == ["dispatch_timeout"]
    assert rec.ring[0]["counters"]["ccfd_dispatch_timeout_total"] == 1


def test_a_timeout_storm_is_debounced():
    rings = {}
    for pkg, mod in (("ref", ref_inc), ("port", port_inc)):
        clock = [0.0]
        rec = mod.FlightRecorder({"r": PKGS[pkg][0]()}, ring=8, timeout_debounce_s=2.0,
                                 clock=lambda: clock[0])
        rec.snapshot("periodic")
        for i in range(20):
            clock[0] = 0.1 * i
            rec.note_dispatch_timeout()
        clock[0] = 5.0
        rec.note_dispatch_timeout()
        rings[pkg] = [s["reason"] for s in rec.ring]
    assert rings["port"] == rings["ref"] == ["periodic", "dispatch_timeout", "dispatch_timeout"]


def test_a_storage_quarantine_dumps_a_bundle_through_the_durability_seam(tmp_path):
    from ccfd_tpu_torch.runtime import durability

    _eng, rec, _h, _clock, _regs = _stack("port")
    path = str(tmp_path / "state.bin")
    durability.write_artifact(path, b"payload", artifact="engine_state")
    durability.flip_bytes(path)
    durability.set_recorder(rec.incident)
    try:
        with pytest.raises(Exception):  # noqa: B017 - corrupt, no generation to fall back to
            durability.read_artifact(path, artifact="engine_state", fallback=False)
    finally:
        durability.set_recorder(None)
    (summary,) = rec.incidents()
    assert summary["trigger"]["type"] == "storage_corrupt"
    assert summary["trigger"]["artifact"] == "engine_state"
    assert summary["trigger"]["quarantined_to"] == path + ".corrupt"
    _valid_both(rec.incident_doc(summary["id"]))
