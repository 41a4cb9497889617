"""The evidence planes on the port's operator, and the tools.

- **The operator's ``incident`` and ``capacity`` blocks**, up on the CPU
  (no longer refused): ``/capacity`` and ``/capacity/whatif`` answer
  valid documents seeded with the live actuators; an SLO breach (an
  objective no decision can meet) dumps exactly one ``slo_breach`` bundle,
  valid under both packages' ``validate_incident``, embedding the
  decisions in flight and the capacity model's verdict, with
  ``ccfd_build_events_total`` among its watched counters; the decisions
  routed while the SLO breaches carry the bundle's id (the audit plane's
  ``incident_fn``), and ``audit <tx_id>`` joins it; ``Platform.down()``
  stops both services' threads and clears the storage quarantine's hook.
  With heal on, a quarantine dumps its own bundle through the same
  recorder. With either block off its endpoints 404.
- **``loadgen``** against a CPU ``serve``: no errors, the report's keys
  the reference's; a server answering 500 counts errors and exits 3.
- **``doctor``**: with a probe that hangs, the timeout is reported and
  the command returns (exit 3); on the CPU it names the device (exit 0).
"""

from __future__ import annotations

import http.server
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ccfd_tpu.observability.capacity import validate_capacity as ref_validate_capacity
from ccfd_tpu.observability.incident import validate_incident as ref_validate_incident
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.observability.capacity import validate_capacity
from ccfd_tpu_torch.observability.incident import validate_incident
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)

ENV = {"CCFD_BATCH_SIZES": "16,128", "CCFD_NATIVE_FRONT": "0"}
# an objective no decision meets: every routed batch burns the budget, so
# the SLO breaches at its first tick with traffic and stays breaching
BREACH_SLO = {"interval_s": 0.1, "windows": "2,4,30",
              "specs": [{"name": "e2e-p99", "kind": "latency",
                         "metric": "router_decision_seconds", "target_ms": 1e-6,
                         "objective": 0.99}]}


def _cr(tmp_path, **blocks):
    spec = {
        "store": {"enabled": False}, "bus": {"partitions": 2},
        "scorer": {"enabled": True, "model": "mlp", "train_steps": 0},
        "engine": {"enabled": True}, "notify": {"enabled": False},
        "router": {"enabled": True}, "retrain": {"enabled": False},
        "producer": {"enabled": False}, "monitoring": {"enabled": True},
        "health": {"enabled": False}, "analytics": {"enabled": False},
        "lifecycle": {"enabled": False}, "heal": {"enabled": False},
        "audit": {"dir": str(tmp_path / "audit"), "flush_interval_s": 0.05},
        "capacity": {"interval_s": 0.2, "min_samples": 5},
        "incident": {"interval_s": 0.2, "dir": str(tmp_path / "incidents")},
        "slo": BREACH_SLO,
    }
    spec.update(blocks)
    return {"spec": spec}


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, None


def _produce(p, lo: int, hi: int, seed: int = 0) -> None:
    rng = np.random.default_rng(seed + lo)
    for i in range(lo, hi):
        row = dict(zip(FEATURE_NAMES, map(float, rng.normal(size=30))))
        p.broker.produce(p.cfg.kafka_topic, {**row, "id": f"tx-{i}"})


def _wait(pred, timeout_s: float = 30.0) -> bool:
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _routed(p) -> float:
    return p.registries["router"].counter("transaction_outgoing_total").total()


def test_the_operator_runs_both_planes_and_joins_the_breach_to_its_decisions(
        tmp_path, capsys):
    from ccfd_tpu_torch.cli import main
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec
    from ccfd_tpu_torch.runtime import durability

    cfg = Config.from_env(ENV)
    spec = PlatformSpec.from_cr(_cr(tmp_path), cfg=cfg)
    assert spec.refused() == []
    p = Platform(spec, device="cpu").up()
    try:
        assert p.capacity is not None and p.recorder is not None
        assert durability._recorder == p.recorder.incident
        assert p.capacity.snapshot()["actuators"]["max_inflight"] == \
            int(p._overload.budget.limit)
        base = p.exporter.endpoint
        _produce(p, 0, 200)
        assert _wait(lambda: _routed(p) >= 200)
        assert _wait(lambda: p.recorder.incidents() != [])
        # the breach is open: the next decisions carry the bundle's id
        _produce(p, 200, 300)
        assert _wait(lambda: _routed(p) >= 300)
        assert _wait(lambda: p.audit.get("tx-299") is not None)
        slo_bundles = [s for s in p.recorder.incidents()
                       if s["trigger"]["type"] == "slo_breach"]
        assert len(slo_bundles) == 1, p.recorder.incidents()  # one per breach entry
        inc_id = slo_bundles[0]["id"]
        status, listing = _get(base + "/incidents")
        assert status == 200 and inc_id in [s["id"] for s in listing["incidents"]]
        status, doc = _get(base + f"/incidents/{inc_id}")
        assert status == 200
        assert validate_incident(doc) == [] and ref_validate_incident(doc) == []
        assert doc["trigger"] == {"type": "slo_breach", "slo": "e2e-p99"}
        assert doc["decisions"] and all("seq" in d for d in doc["decisions"])
        assert set(doc["capacity"]) >= {"bottleneck", "e2e", "regressions"}
        assert "ccfd_build_events_total" in doc["snapshot"]["counters"]
        assert "ccfd_xla_compile_events_total" not in doc["snapshot"]["counters"]
        rec = p.audit.get("tx-299")
        assert rec["incident"] == inc_id
        # the reconstruction joins the bundle, live and offline
        p.audit.flush()
        assert main(["audit", "tx-299", "--url", base, "--json"]) == 0
        joined = json.loads(capsys.readouterr().out)["incident"]
        assert joined["found"] is True and joined["id"] == inc_id
        assert main(["audit", "tx-299", "--dir", str(tmp_path / "audit"), "--incident-dir",
                     str(tmp_path / "incidents"), "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["incident"]["found"] is True
        # the capacity document and a what-if, over HTTP
        assert _wait(lambda: p.capacity.snapshot()["refreshes"] >= 2)
        status, cap = _get(base + "/capacity")
        assert status == 200
        assert validate_capacity(cap) == [] and ref_validate_capacity(cap) == []
        assert {"bus", "router.score"} <= set(cap["stages"])
        status, wi = _get(base + "/capacity/whatif?workers=2")
        assert status == 200 and validate_capacity(wi) == []
        assert wi["whatif"]["requested"] == {"workers": 2}
        prom = urllib.request.urlopen(base + "/prometheus", timeout=10).read().decode()
        for fam in ("ccfd_capacity_model_error_ratio", "ccfd_incidents_total",
                    "ccfd_incident_ring_size", "ccfd_build_events_total"):
            assert fam in prom, fam
    finally:
        p.down()
    # down() stops both services' threads and drops the quarantine hook
    for svc in ("capacity", "incident"):
        assert p.supervisor.status()[svc]["state"] == "Stopped"
    assert p.capacity._stop.is_set() and p.recorder._stop.is_set()
    assert durability._recorder is None
    alive = [t.name for t in threading.enumerate()
             if t.name in ("svc-capacity", "svc-incident") and t.is_alive()]
    assert alive == []


def test_the_heal_supervisor_and_the_watchdog_feed_the_recorder(tmp_path):
    """With heal on, the operator hands the supervisor and the router's
    overload plane the recorder: a quarantine dumps a ``device_quarantine``
    bundle (valid under both packages' validators), as the reference's."""
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    cfg = Config.from_env(ENV)
    cr = _cr(tmp_path, heal={"enabled": True, "interval_s": 30.0},
             slo={"interval_s": 5.0})
    p = Platform(PlatformSpec.from_cr(cr, cfg=cfg), device="cpu").up()
    try:
        assert p.heal.recorder is p.recorder and p._overload.recorder is p.recorder
        p.heal._quarantine(["canary: injected for the test"])
        (summary,) = p.recorder.incidents()
        assert summary["trigger"]["type"] == "device_quarantine"
        doc = p.recorder.incident_doc(summary["id"])
        assert validate_incident(doc) == [] and ref_validate_incident(doc) == []
        assert doc["trigger"]["signals"] == ["canary: injected for the test"]
    finally:
        p.down()


@pytest.mark.parametrize("off", ["incident", "capacity"])
def test_a_plane_switched_off_404s(tmp_path, off):
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    cfg = Config.from_env({**ENV, f"CCFD_{off.upper()}": "0"})
    p = Platform(PlatformSpec.from_cr(_cr(tmp_path, slo={"interval_s": 0.5}), cfg=cfg),
                 device="cpu").up()
    try:
        base = p.exporter.endpoint
        paths = {"incident": ("/incidents", "/incidents/inc-0001-x"),
                 "capacity": ("/capacity", "/capacity/whatif?workers=2")}
        for path in paths[off]:
            assert _get(base + path)[0] == 404
        on = "capacity" if off == "incident" else "incident"
        assert _get(base + paths[on][0])[0] == 200
        assert getattr(p, "recorder" if off == "incident" else "capacity") is None
        assert p.audit.incident_fn is None or off == "capacity"
    finally:
        p.down()


@pytest.fixture(scope="module")
def cpu_serve():
    from ccfd_tpu_torch.cli import build_server

    srv = build_server(Config.from_env(ENV), device="cpu")
    port = srv.start("127.0.0.1", 0)
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        srv.stop()


def test_loadgen_drives_a_cpu_serve_without_errors(cpu_serve, capsys):
    from ccfd_tpu.utils.loadgen import run_loadgen as ref_run
    from ccfd_tpu_torch.cli import main
    from ccfd_tpu_torch.utils.loadgen import run_loadgen

    rep = run_loadgen(cpu_serve, clients=2, rows_per_request=16, seconds=1.0)
    assert rep["errors"] == 0 and rep["failed_clients"] == 0
    assert rep["requests_s"] > 0 and rep["tx_s"] == pytest.approx(16 * rep["requests_s"], rel=0.01)
    assert 0 < rep["p50_ms"] <= rep["p99_ms"]
    ref = ref_run(cpu_serve, clients=1, rows_per_request=16, seconds=0.5)
    assert set(rep) == set(ref) and ref["errors"] == 0
    assert main(["loadgen", "--url", cpu_serve, "--clients", "1", "--rows", "4",
                 "--seconds", "0.5"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["errors"] == 0 and out["rows_per_request"] == 4


def test_loadgen_counts_errors_and_exits_3(capsys):
    from ccfd_tpu_torch.cli import main

    class Failing(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(500)
            self.send_header("Content-Length", "0")
            self.end_headers()

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Failing)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert main(["loadgen", "--url", url, "--clients", "1", "--seconds", "0.5"]) == 3
        rep = json.loads(capsys.readouterr().out)
        assert rep["errors"] > 0 and rep["p99_ms"] is None and rep["requests_s"] == 0.0
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_doctor_reports_a_hanging_probe_instead_of_hanging(monkeypatch, capsys):
    from ccfd_tpu_torch import cli

    monkeypatch.setattr(cli, "DOCTOR_PROBE", "import time\ntime.sleep(60)\n")
    t0 = time.monotonic()
    assert cli.main(["doctor", "--probe-s", "1"]) == 3
    assert time.monotonic() - t0 < 30
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] is False and rep["device"]["error"].startswith("WEDGED")
    # the rest of the report is there all the same
    assert {"kernels", "bus", "checkpoint", "config"} <= set(rep)
    assert set(rep["kernels"]) == {"fused_mlp", "fused_mlp_q8", "native"}


def test_doctor_names_the_device_it_probed(capsys):
    from ccfd_tpu_torch import cli

    assert cli.main(["doctor", "--device", "cpu", "--probe-s", "120"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] is True and rep["device"]["name"] == "cpu"
    assert rep["device"]["torch"] and rep["device"]["dispatch_rtt_ms"] >= 0
    # without CUDA the card's probe fails by name (this box has no card)
    import torch

    if not torch.cuda.is_available():
        assert cli.main(["doctor", "--probe-s", "120"]) == 3
        rep = json.loads(capsys.readouterr().out)
        assert "is_available" in rep["device"]["error"]
