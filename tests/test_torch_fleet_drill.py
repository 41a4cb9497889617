"""The fleet on the CPU, end to end: the port's kill drill, ``fleet up`` and
``fleet status``.

- **The drill** (tools/torch_fleet_drill.py, sized as tools/fleet_smoke.py
  sizes the reference's: two ``python -m ccfd_tpu_torch fleet member``
  processes with ``--device cpu``, 4 partitions, 200 transactions before
  and 200 after the SIGKILL of one member): every check of the reference
  drill holds. It runs in a subprocess under a time limit of its own.
- **``fleet up``** spawns two members over an embedded bus that answer
  ``fleet status`` with disjoint, total ownership and champion parity, and
  on SIGTERM stops them.
- **``fleet status``** gives the reference's document over the same
  heartbeat endpoints, and exits 1 on an ownership violation.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from ccfd_tpu_torch.fleet.member import FleetMember
from ccfd_tpu_torch.metrics.prom import Registry
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)

REPO = Path(__file__).resolve().parents[1]
DRILL_TIMEOUT_S = 240


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), CCFD_BATCH_SIZES="16,128,1024",
               CCFD_NATIVE_FRONT="0")
    return env


def test_the_two_member_kill_drill_passes_every_check(tmp_path):
    # its own session, so a drill cut by the time limit takes its members along
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tools" / "torch_fleet_drill.py"), "--device", "cpu",
         "--members", "2", "--partitions", "4", "--txs-before", "200", "--txs-after", "200",
         "--ttl-s", "2", "--state-dir", str(tmp_path / "drill")],
        cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=DRILL_TIMEOUT_S)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.communicate()
    res = json.loads(stdout) if stdout.strip() else {}
    assert proc.returncode == 0, (res.get("checks"), res.get("conservation"), stderr[-3000:])
    assert res["ok"] and all(res["checks"].values()), res["checks"]
    assert set(res["checks"]) == {
        "initial_ownership_disjoint", "victim_was_routing",
        "survivors_adopted_all_partitions", "rebalanced_after_respawn", "ledger_conserved",
        "ledger_covers_all_produced", "all_members_answer_health", "champion_parity",
        "nobody_quarantined", "member_accounting_balances", "fleet_gauges_green",
        "exactly_one_kill_bundle", "bench_row_recorded"}
    c = res["conservation"]
    assert c["produced"] == c["disposed"] == 400 and c["dropped"] == [] == c["ghosts"]
    assert res["device"] == "cpu" and len(res["kill_bundles"]) == 1
    bundle = json.loads(Path(res["kill_bundles"][0]).read_text())
    from ccfd_tpu_torch.observability.incident import validate_incident

    assert validate_incident(bundle) == []
    assert bundle["trigger"]["type"] == "fleet_member_kill"
    assert bundle["trigger"]["member"] == "m01" and bundle["trigger"]["survivors"] == ["m00"]
    assert res["kill_to_readoption_s"] > 0 and res["bench"]["tx_s"] > 0
    assert res["fleet_gauges"]["ccfd_fleet_members"] == 2.0
    # on the CPU no kernel launches; every member's scorer is the seeded one
    for m in res["member_metrics"].values():
        assert m['ccfd_kernel_launches{kernel="fused_mlp_bf16"}'] == 0.0


def _status(peers: str, reference: bool = True) -> tuple[int, dict, dict | None]:
    """(port exit code, port document, reference document or None)."""
    import contextlib
    import io

    from ccfd_tpu.cli import cmd_fleet_status as ref_status
    from ccfd_tpu_torch.cli import cmd_fleet_status

    docs, rcs = [], []
    for fn in (cmd_fleet_status, ref_status) if reference else (cmd_fleet_status,):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs.append(fn(argparse.Namespace(peers=peers, json=True)))
        docs.append(json.loads(buf.getvalue()))
    if reference:
        assert rcs[0] == rcs[1]
    return rcs[0], docs[0], docs[1] if reference else None


def _strip(doc: dict) -> dict:
    """The document without the per-process fields of each snapshot."""
    out = json.loads(json.dumps(doc))
    for h in out["members"].values():
        if h is not None:
            h.pop("pid")
            h.pop("incarnation")
    return out


def test_fleet_status_is_the_references_and_exits_1_on_a_violation():
    owned = {"a": [0, 2], "b": [1, 3]}
    made = []
    try:
        for name in ("a", "b"):
            m = FleetMember(name, Registry(), consumers_fn=lambda n=name: [
                SimpleNamespace(assignment=[("t", p) for p in owned[n]], epoch=2)],
                fingerprint_fn=lambda: "f" * 64)
            m.start_server()
            made.append(m)
        peers = ",".join(m.endpoint for m in made) + ",http://127.0.0.1:1"
        rc, port, ref = _status(peers)
        assert rc == 0 and _strip(port) == _strip(ref)
        assert port["ownership_violations"] == [] and port["parity"]["parity"] is True
        assert port["members"]["http://127.0.0.1:1"] is None
        owned["b"] = [1, 2]  # partition 2 double-owned, 3 orphaned
        rc, port, ref = _status(peers)
        assert rc == 1 and _strip(port) == _strip(ref)
        assert any("owned by both" in v for v in port["ownership_violations"])
    finally:
        for m in made:
            m.close()


def test_fleet_up_spawns_members_that_answer_status_and_stops_them(tmp_path):
    state = tmp_path / "fleet"
    # its own session: whatever happens below, the members go with it
    proc = subprocess.Popen(
        [sys.executable, "-m", "ccfd_tpu_torch", "fleet", "up", "--members", "2",
         "--device", "cpu", "--state-dir", str(state), "--ttl-s", "2"],
        cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        specs = [state / f"member-m0{i}.json" for i in range(2)]
        deadline = time.monotonic() + 120
        peers = None
        while time.monotonic() < deadline and proc.poll() is None:
            if all(p.exists() for p in specs):
                ports = [json.loads(p.read_text())["spec"]["fleet"]["heartbeat_port"]
                         for p in specs]
                peers = ",".join(f"http://127.0.0.1:{p}" for p in ports)
                rc, doc, _ = _status(peers, reference=False)
                if rc == 0 and all(doc["members"].values()) and all(
                        h["partitions"] for h in doc["members"].values()) and \
                        sum(len(h["partitions"]) for h in doc["members"].values()) == 4:
                    break
            time.sleep(0.3)
        else:
            pytest.fail(f"fleet up never served status: {proc.poll()}")
        assert doc["parity"]["parity"] and doc["parity"]["majority"]
        for p in specs:
            spec = json.loads(p.read_text())["spec"]
            assert spec["fleet"]["device"] == "cpu" and spec["router"]["workers"] == 1
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-3000:]
        assert "[fleet] embedded bus on http://127.0.0.1:" in err
        rc, doc, _ = _status(peers, reference=False)
        assert not any(doc["members"].values())  # the members are gone
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # a member orphaned by a failure
        except ProcessLookupError:
            pass


def test_a_member_without_a_card_raises(tmp_path, monkeypatch):
    """`fleet member` runs on the card unless its spec or --device names the
    CPU; with no card it raises and tears down what it started, never
    scoring on the host."""
    import torch

    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.bus.server import BrokerServer
    from ccfd_tpu_torch.cli import main
    from ccfd_tpu_torch.fleet.supervisor import _free_port, build_member_cr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = BrokerServer(Broker(default_partitions=2))
    url = f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"
    port = _free_port()
    spec = tmp_path / "m00.json"
    spec.write_text(json.dumps(build_member_cr("m00", url, port, [], str(tmp_path))))
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["fleet", "member", "--spec", str(spec)])
        with pytest.raises(OSError):  # no heartbeat was left serving
            urllib_get(f"http://127.0.0.1:{port}/fleet/health")
    finally:
        srv.stop()


def urllib_get(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=2) as r:
        return r.read()
