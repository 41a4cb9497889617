"""The port's decision provenance plane (ccfd_tpu_torch/observability/audit.py
and the route seam's stamping in router/router.py) against the reference's
(ccfd_tpu/observability/audit.py, ccfd_tpu/router/router.py).

- **The route seam**: the same seeded transactions routed through each
  package's router, with each package's ``AuditLog``, give the same records
  field by field apart from the clock (``ts``, ``decided_ts``), on the
  device tier, the host tier under a quarantine, the host tier after a
  ``score_error``, the rules tier under the storage pin, a breaker open,
  and a failed start (not recorded: recorded == routed).
- **The log**: the same records through ``record_batch`` land byte-equal
  segments; the reference's ``AuditLog(readonly=True)`` reads a directory
  the port wrote and the port's reads the reference's; rotation, retention,
  torn-tail truncation, read-only recovery and the storage-fault draws at
  the append seam behave as the reference's, counted the same.
- **The surfaces**: ``/decisions`` and ``/decisions/<tx_id>`` over HTTP
  (404 with the kill switch), ``audit <tx_id>`` offline from the segments
  and live from the exporter (the lineage and incident joins named absent),
  one ``AuditLog`` shared by a ``ParallelRouter``'s workers, and the
  operator's default-on plane landing at ``/decisions``.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.observability.audit import AuditLog as RefAuditLog
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu.router.router import Router as RefRouter
from ccfd_tpu.runtime import breaker as ref_breaker
from ccfd_tpu.runtime import faults as ref_faults
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.observability.audit import AuditLog
from ccfd_tpu_torch.process.fraud import build_engine
from ccfd_tpu_torch.router.router import Router
from ccfd_tpu_torch.runtime import breaker as port_breaker
from ccfd_tpu_torch.runtime import durability as port_dur
from ccfd_tpu_torch.runtime import faults as port_faults
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)

CLOCK = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _no_leaked_plans():
    yield
    for faults in (ref_faults, port_faults):
        faults.install_storage_faults(None)


def _rows(idx):
    return [{"tx": f"tx-{i}", "uid": f"0:{i}", "ts": 100.0 + i, "proba": 0.9,
             "rule": "fraud", "branch": "fraud", "pid": i, "priority": "normal"}
            for i in idx]


def _csv(n: int, seed: int = 0) -> list[bytes]:
    """Seeded CSV rows; half the amounts above CCFD_LOW_AMOUNT, so the
    rules tier routes both branches."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 30)).astype(np.float32)
    x[:, 29] = np.where(rng.random(n) < 0.5, 5.0, 500.0)
    return [",".join(repr(float(v)) for v in row).encode() for row in x]


def _seeded_score(x):
    """A deterministic 'device' score both sides compute identically."""
    z = x[:, :29].sum(1) / 4.0
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


def _host_score(x):
    return np.full(len(x), 0.2, np.float32)


class _Gate:
    def __init__(self, device: bool, host: bool = True):
        self.device, self.host = device, host

    def device_allowed(self):
        return self.device

    def host_allowed(self):
        return self.host


class _Flaky:
    """An engine whose every third start fails."""

    def __init__(self, inner):
        self.inner, self.n = inner, 0

    def definitions(self):
        return self.inner.definitions()

    def _ok(self):
        self.n += 1
        return self.n % 3 != 0

    def start_process(self, def_id, variables):
        if not self._ok():
            raise RuntimeError("boom")
        return self.inner.start_process(def_id, variables)

    def start_process_batch(self, def_id, vars_list, copy_vars=True):
        pids = self.inner.start_process_batch(def_id, vars_list, copy_vars=copy_vars)
        return [p if self._ok() else None for p in pids]

    def signal(self, pid, name, payload=None):
        return self.inner.signal(pid, name, payload)


def _raise(x):
    raise RuntimeError("edge down")


CASES = {
    "device": dict(),
    "quarantine_host": dict(degrade=True, host=True, gate=(False, True)),
    "score_error": dict(degrade=True, host=True, score=_raise),
    "storage_pin": dict(degrade=True, host=True, gate=(False, False)),
    "quarantine_rules": dict(degrade=True, host=False, gate=(False, True)),
    "breaker_open": dict(degrade=True, host=True, breaker=True),
    "failed_starts": dict(flaky=True),
}


def _route(side: str, case: dict, n: int = 48):
    if side == "ref":
        cfg, broker, reg = RefConfig(), RefBroker(default_partitions=2), RefRegistry()
        build, router_cls, audit_cls, br_mod = (ref_build_engine, RefRouter, RefAuditLog,
                                                ref_breaker)
    else:
        cfg, broker, reg = Config(), Broker(default_partitions=2), Registry()
        build, router_cls, audit_cls, br_mod = build_engine, Router, AuditLog, port_breaker
    audit = audit_cls(registry=reg, clock=lambda: CLOCK)
    engine = build(cfg, broker, type(reg)(), None)
    if case.get("flaky"):
        engine = _Flaky(engine)
    kw = {}
    if case.get("degrade"):
        kw["degrade"] = True
    if case.get("host"):
        kw["host_score_fn"] = _host_score
    if case.get("gate"):
        kw["heal_gate"] = _Gate(*case["gate"])
    if case.get("breaker"):
        br = br_mod.CircuitBreaker(edge="scorer", min_calls=1, failure_ratio=0.5,
                                   cooldown_s=600.0)
        br.record_failure()
        kw["breaker"] = br
    router = router_cls(cfg, broker, case.get("score", _seeded_score), engine, reg,
                        max_batch=16, audit=audit, **kw)
    broker.produce_batch(cfg.kafka_topic, _csv(n), [f"tx-{i}" for i in range(n)])
    while router.step() > 0:
        pass
    out = {
        "records": [_strip(audit.get(f"tx-{i}")) for i in range(n)],
        "recorded": reg.counter("ccfd_audit_records_total").value(),
        "routed": reg.counter("transaction_outgoing_total").total(),
        "start_errors": reg.counter("router_process_start_errors_total").total(),
    }
    router.close()
    broker.close()
    return out


def _strip(rec):
    if rec is None:
        return None
    return {k: v for k, v in rec.items() if k not in ("ts", "decided_ts")}


@pytest.mark.parametrize("name", list(CASES))
def test_the_route_seam_stamps_the_references_records(name):
    got, want = _route("port", CASES[name]), _route("ref", CASES[name])
    assert got == want
    assert got["recorded"] == got["routed"]
    recs = [r for r in got["records"] if r is not None]
    assert len(recs) == got["routed"]
    tier = {r["tier"] for r in recs}
    cause = {r.get("cause") for r in recs}
    expected = {
        "device": ({"device"}, {None}), "quarantine_host": ({"host"}, {"quarantine"}),
        "score_error": ({"host"}, {"score_error"}), "storage_pin": ({"rules"}, {"storage_pin"}),
        "quarantine_rules": ({"rules"}, {"quarantine"}),
        "breaker_open": ({"host"}, {"breaker_open"}), "failed_starts": ({"device"}, {None}),
    }[name]
    assert (tier, cause) == expected
    if name == "failed_starts":
        assert got["start_errors"] > 0 and got["routed"] + got["start_errors"] == 48
        assert None in got["records"]  # a failed start is not recorded


def test_the_pipelined_loop_stamps_every_routed_row():
    cfg, broker, reg = Config(), Broker(default_partitions=2), Registry()
    audit = AuditLog(registry=reg)
    router = Router(cfg, broker, _seeded_score, build_engine(cfg, broker, Registry(), None),
                    reg, max_batch=16, audit=audit)
    broker.produce_batch(cfg.kafka_topic, _csv(200), [f"tx-{i}" for i in range(200)])
    t = router.start(poll_timeout_s=0.01)
    deadline = time.monotonic() + 20
    while reg.counter("transaction_outgoing_total").total() < 200:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    router.stop()
    t.join(timeout=5)
    assert audit.counts()["recorded"] == 200 == audit.ring_size
    assert {audit.get(f"tx-{i}")["tier"] for i in range(200)} == {"device"}
    router.close()


def test_one_audit_log_is_shared_by_the_parallel_workers():
    from ccfd_tpu_torch.router.parallel import ParallelRouter

    cfg, broker, reg = Config(), Broker(default_partitions=2), Registry()
    audit = AuditLog(registry=reg)
    pr = ParallelRouter(cfg, broker, _seeded_score, build_engine(cfg, broker, Registry(), None),
                        reg, workers=2, max_batch=16, audit=audit)
    assert all(w._audit is audit for w in pr.workers)
    broker.produce_batch(cfg.kafka_topic, _csv(64), [f"tx-{i}" for i in range(64)])
    while pr.step() > 0:
        pass
    assert audit.counts()["recorded"] == 64
    assert {audit.get(f"tx-{i}")["worker"] for i in range(64)} == {0, 1}
    pr.close()


# -- the log -------------------------------------------------------------------------


def _both(tmp_path, **kw):
    return (RefAuditLog(dir=str(tmp_path / "ref"), clock=lambda: CLOCK, **kw),
            AuditLog(dir=str(tmp_path / "port"), clock=lambda: CLOCK, **kw))


def test_record_batch_stamps_the_references_fields():
    calls = []
    logs = [cls(lineage_fn=lambda: (calls.append(1), (3, "abc"))[1],
                incident_fn=lambda: "inc-1", clock=lambda: CLOCK)
            for cls in (RefAuditLog, AuditLog)]
    for log in logs:
        log.record_batch(_rows(range(8)), tier="host", cause="quarantine",
                         events=("score_error",), worker=2, trace_id="t" * 32, threshold=0.5)
    assert [log.get("tx-3") for log in logs[1:]] == [logs[0].get("tx-3")]
    assert logs[1].get("0:3") == logs[1].get("tx-3")
    assert len(calls) == 2  # the batch joins sampled once a batch
    for log in logs:
        log.record_batch(_rows([3]))  # a re-stamp: the latest wins
    assert logs[1].get("tx-3") == logs[0].get("tx-3")
    assert logs[1].counts() == logs[0].counts()
    assert logs[1].list(limit=3) == logs[0].list(limit=3)


def test_the_same_records_land_byte_equal_segments(tmp_path):
    ref, port = _both(tmp_path, segment_bytes=4096, retain_segments=2, fsync=False)
    for i in range(6):
        for log in (ref, port):
            log.record_batch(_rows(range(i * 20, i * 20 + 20)), threshold=0.5)
            assert log.flush() == 20
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) and 1 <= len(names) <= 3
    for n in names:
        assert (tmp_path / "ref" / n).read_bytes() == (tmp_path / "port" / n).read_bytes()


def test_each_side_reads_the_others_directory(tmp_path):
    ref, port = _both(tmp_path, fsync=False)
    for log in (ref, port):
        log.record_batch(_rows(range(10)), tier="host", cause="quarantine")
        log.flush()
    ref_reads_port = RefAuditLog(dir=str(tmp_path / "port"), readonly=True)
    port_reads_ref = AuditLog(dir=str(tmp_path / "ref"), readonly=True)
    for i in range(10):
        assert ref_reads_port.get(f"tx-{i}") == port.get(f"tx-{i}")
        assert port_reads_ref.get(f"tx-{i}") == ref.get(f"tx-{i}")
    assert port_reads_ref.scan_window(2, 5) == ref_reads_port.scan_window(2, 5)
    # a port log reopened on the reference's directory continues its seq
    cont = AuditLog(dir=str(tmp_path / "ref"))
    cont.record_batch(_rows([99]))
    assert cont.get("tx-99")["seq"] == 10


def test_a_torn_tail_is_truncated_and_counted_as_the_reference(tmp_path):
    regs = (RefRegistry(), Registry())
    ref, port = _both(tmp_path, fsync=False)
    for log in (ref, port):
        log.record_batch(_rows(range(5)))
        log.flush()
    sizes = []
    for side in ("ref", "port"):
        seg = tmp_path / side / "audit-00000000.log"
        sizes.append(seg.stat().st_size)
        with open(seg, "ab") as f:
            f.write(b"CCFDSUM1 " + b"00" * 32 + b" 999\npartial")
    # read-only first: nothing mutated
    ro = AuditLog(dir=str(tmp_path / "port"), readonly=True)
    assert ro.truncated_frames == 1 and ro.ring_size == 5
    assert (tmp_path / "port" / "audit-00000000.log").stat().st_size > sizes[1]
    reopened = [cls(dir=str(tmp_path / side), registry=reg)
                for cls, side, reg in ((RefAuditLog, "ref", regs[0]),
                                       (AuditLog, "port", regs[1]))]
    for log, reg, size, side in zip(reopened, regs, sizes, ("ref", "port")):
        assert log.truncated_frames == 1 and log.ring_size == 5
        assert reg.counter("ccfd_audit_dropped_total").value({"reason": "torn_tail"}) == 1
        assert (tmp_path / side / "audit-00000000.log").stat().st_size == size


@pytest.mark.parametrize("kind", ["torn_write", "enospc", "fsync_fail", "slow_disk"])
def test_storage_faults_at_the_append_seam_as_the_reference(tmp_path, kind):
    out = []
    for side, faults, cls, reg in (("ref", ref_faults, RefAuditLog, RefRegistry()),
                                   ("port", port_faults, AuditLog, Registry())):
        log = cls(dir=str(tmp_path / side), registry=reg, fsync=True, clock=lambda: CLOCK)
        log.record_batch(_rows(range(3)))
        log.flush()
        log.record_batch(_rows(range(10, 13)))
        text = f"{kind}:ms=1" if kind == "slow_disk" else kind
        faults.install_storage_faults(faults.StorageFaultPlan.from_string(text))
        landed = log.flush()
        faults.install_storage_faults(None)
        log.record_batch(_rows(range(20, 25)))
        after = log.flush()
        again = cls(dir=str(tmp_path / side))
        out.append((landed, after, reg.counter("ccfd_audit_dropped_total").value(
            {"reason": "log_write"}), again.truncated_frames,
            [again.get(f"tx-{i}") is not None for i in (2, 11, 22)],
            (tmp_path / side / "audit-00000000.log").read_bytes()))
    assert out[0] == out[1]
    if kind != "slow_disk":
        assert out[1][:5] == (0, 5, 3, 0, [True, False, True])  # rolled back, counted


def test_write_errors_note_the_audit_artifact(tmp_path):
    before = port_dur.counts().get("write_errors", {}).get("audit", 0)
    log = AuditLog(dir=str(tmp_path), fsync=False)
    log.record_batch(_rows(range(2)))
    port_faults.install_storage_faults(port_faults.StorageFaultPlan.from_string("enospc"))
    assert log.flush() == 0
    assert port_dur.counts()["write_errors"]["audit"] == before + 1
    assert log.get("tx-1") is not None  # the ring stays authoritative


# -- the surfaces --------------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, e.read()


def test_the_decisions_endpoints_and_the_kill_switch():
    from ccfd_tpu_torch.metrics.exporter import MetricsExporter

    audit = AuditLog()
    audit.record_batch(_rows(range(6)))
    ex = MetricsExporter({"audit": Registry()}, audit=audit).start()
    off = MetricsExporter({"audit": Registry()}).start()
    try:
        code, ctype, body = _get(ex.endpoint + "/decisions")
        assert code == 200 and "application/json" in ctype
        assert [d["tx"] for d in json.loads(body)["decisions"][:2]] == ["tx-5", "tx-4"]
        assert len(json.loads(_get(ex.endpoint + "/decisions?limit=2")[2])["decisions"]) == 2
        assert json.loads(_get(ex.endpoint + "/decisions/tx-3")[2]) == audit.get("tx-3")
        assert _get(ex.endpoint + "/decisions/nope")[0] == 404
        for path in ("/decisions", "/decisions/tx-1"):
            assert _get(off.endpoint + path)[0] == 404
    finally:
        ex.stop()
        off.stop()


def test_audit_tx_id_offline_and_live_returns_the_endpoints_record(tmp_path, capsys,
                                                                  monkeypatch):
    from ccfd_tpu_torch.cli import main
    from ccfd_tpu_torch.metrics.exporter import MetricsExporter

    audit = AuditLog(dir=str(tmp_path), fsync=False)
    audit.record_batch(_rows(range(4)), tier="host", cause="quarantine", trace_id="ab" * 16)
    audit.flush()
    ex = MetricsExporter({"audit": Registry()}, audit=audit).start()
    try:
        live = json.loads(_get(ex.endpoint + "/decisions/tx-2")[2])
        assert main(["audit", "tx-2", "--dir", str(tmp_path), "--json"]) == 0
        offline = json.loads(capsys.readouterr().out)
        assert offline["record"] == live
        # no lifecycle store to join (the lineage join: test_torch_lifecycle.py);
        # the incident plane is named absent
        assert "lineage" not in offline and "A14" in offline["incident"]["absent"]
        assert offline["trace"] == {"trace_id": "ab" * 16, "kept": None}
        assert main(["audit", "tx-2", "--url", ex.endpoint, "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["record"] == live
        monkeypatch.setenv("CCFD_AUDIT_DIR", str(tmp_path))
        assert main(["audit", "tx-2"]) == 0
        text = capsys.readouterr().out
        assert "served by: host tier (quarantine)" in text and "incident: absent" in text
        assert main(["audit", "tx-404", "--dir", str(tmp_path)]) == 2
    finally:
        ex.stop()
    # the reference's command reads the port's directory to the same record
    from ccfd_tpu.cli import main as ref_main

    assert ref_main(["audit", "tx-2", "--dir", str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["record"] == live


@pytest.mark.parametrize("flag", ["--lifecycle-dir", "--incident-dir"])
def test_audit_refuses_the_unported_joins_dirs_by_name(tmp_path, capsys, flag):
    """The incident join's directory selects a plane the port does not have
    (A14): the command refuses the flag by name and reads nothing. The
    lineage join is served since A12: its case keeps its id and passes
    ``--lifecycle-dir`` beside the flag still refused."""
    from ccfd_tpu_torch.cli import main

    argv = ["audit", "tx-2", "--dir", str(tmp_path), flag, str(tmp_path)]
    if flag == "--lifecycle-dir":
        argv += ["--incident-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2 and "--incident-dir" in capsys.readouterr().err


def _operator_cr(tmp_path, audit=None):
    spec = {
        "store": {"enabled": False}, "bus": {"partitions": 2},
        "scorer": {"enabled": True, "model": "mlp", "train_steps": 0},
        "engine": {"enabled": True}, "notify": {"enabled": False},
        "router": {"enabled": True}, "retrain": {"enabled": False},
        "producer": {"enabled": False}, "monitoring": {"enabled": True},
        "health": {"enabled": False}, "analytics": {"enabled": False},
        "heal": {"enabled": False}, "incident": {"enabled": False},
        "lifecycle": {"enabled": False}, "capacity": {"enabled": False},
    }
    if audit is not None:
        spec["audit"] = audit
    return {"spec": spec}


def test_the_operator_stamps_decisions_by_default(tmp_path):
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    cfg = Config.from_env({"CCFD_BATCH_SIZES": "16,128"})
    cr = _operator_cr(tmp_path, audit={"dir": str(tmp_path / "audit"),
                                       "flush_interval_s": 0.05})
    p = Platform(PlatformSpec.from_cr(cr, cfg=cfg), device="cpu").up(wait_ready_s=30)
    try:
        assert p.audit is not None and p.supervisor.status()["audit"]["state"] == "Running"
        p.broker.produce_batch(cfg.kafka_topic, _csv(16), [f"tx-{i}" for i in range(16)])
        deadline = time.monotonic() + 15
        while p.audit.get("tx-3") is None:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        rec = json.loads(_get(p.exporter.endpoint + "/decisions/tx-3")[2])
        # no lifecycle (ROADMAP A12): no version or hash join, as the reference
        assert rec["tier"] == "device" and "version" not in rec and "hash" not in rec
        deadline = time.monotonic() + 5
        while not os.listdir(tmp_path / "audit"):
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        p.down()
    assert AuditLog(dir=str(tmp_path / "audit"), readonly=True).get("tx-3")["tx"] == "tx-3"


def test_the_operator_kill_switch_disables_the_plane(tmp_path):
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    cfg = Config.from_env({"CCFD_BATCH_SIZES": "16", "CCFD_AUDIT": "0"})
    p = Platform(PlatformSpec.from_cr(_operator_cr(tmp_path), cfg=cfg),
                 device="cpu").up(wait_ready_s=30)
    try:
        assert p.audit is None
        router = p.router.workers[0] if hasattr(p.router, "workers") else p.router
        assert router._audit is None
        assert _get(p.exporter.endpoint + "/decisions")[0] == 404
    finally:
        p.down()


def test_config_takes_the_audit_knobs_as_the_reference():
    env = {"CCFD_AUDIT": "off", "CCFD_AUDIT_DIR": "/tmp/a", "CCFD_AUDIT_RING": "99",
           "CCFD_AUDIT_SEGMENT_BYTES": "8192", "CCFD_AUDIT_SEGMENTS": "3",
           "CCFD_AUDIT_FLUSH_INTERVAL_S": "0.5"}
    fields = ("audit_enabled", "audit_dir", "audit_ring", "audit_segment_bytes",
              "audit_segments", "audit_flush_interval_s")
    for e in (env, {}):
        got, want = Config.from_env(e), RefConfig.from_env(e)
        assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
