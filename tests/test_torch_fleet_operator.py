"""The operator's ``fleet`` block on the port against the reference's.

Both operators come up from the reference's ``minimal_cr`` with ``fleet``
on over a networked bus (``bus.url``, each package's own bus server), and
route the same records:

- the platform is no longer refused: the router's tx consumer is
  manual-commit, every routed row lands on the fleet ledger (stamped with
  the member and its poll epoch) after the batch routed, and the committed
  offsets reach the end offsets: the ledger's transactions and the
  committed offsets equal the reference's;
- the member's heartbeat snapshot owns every partition and carries the
  served params' fingerprint (``params.params_fingerprint``);
- the parity gate composes with the storage pin and the heal supervisor on
  the router's gate, and a quarantine pins the ladder to the rules tier;
- ``status()`` and ``/healthz`` carry the fleet (a quarantine is unhealthy),
  the exporter serves the ``ccfd_fleet_*`` gauges, ``down()`` closes the
  heartbeat server;
- ``up -f`` with fleet on and ``bus.url`` set brings the platform up and
  routes the producer's rows.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import pytest
import yaml

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.bus.client import RemoteBroker as RefRemote
from ccfd_tpu.bus.server import BrokerServer as RefServer
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.fleet.ledger import flatten_ledger as ref_flatten
from ccfd_tpu.platform.operator import Platform as RefPlatform
from ccfd_tpu.platform.operator import PlatformSpec as RefSpec
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.bus.client import RemoteBroker
from ccfd_tpu_torch.bus.server import BrokerServer
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.fleet.ledger import LEDGER_TOPIC, flatten_ledger
from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec
from tests import torch_helpers
from tests.test_platform import minimal_cr

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)

ENV = {"CCFD_BATCH_SIZES": "16,128,1024", "CCFD_NATIVE_FRONT": "0"}
OFF = {name: {"enabled": False}
       for name in ("lifecycle", "analytics", "replay", "capacity", "notify")}
N = 60


def _cr(bus_url: str) -> dict:
    return minimal_cr(**OFF, bus={"url": bus_url},
                      router={"enabled": True, "workers": 1},
                      fleet={"enabled": True, "member": "m00", "heartbeat_port": 0,
                             "ttl_s": 2.0, "gossip_interval_s": 0.1})


SIDES = {
    "ref": dict(platform=RefPlatform, spec=RefSpec, cfg=RefConfig, broker=RefBroker,
                server=RefServer, remote=RefRemote, flatten=ref_flatten, kw={}),
    "port": dict(platform=Platform, spec=PlatformSpec, cfg=Config, broker=Broker,
                 server=BrokerServer, remote=RemoteBroker, flatten=flatten_ledger,
                 kw={"device": "cpu"}),
}


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(pred, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.05)


def _run(name: str) -> dict:
    side = SIDES[name]
    srv = side["server"](side["broker"](default_partitions=2))
    url = f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"
    client = side["remote"](url)
    cfg = side["cfg"].from_env(ENV)
    p = side["platform"](side["spec"].from_cr(_cr(url), cfg=cfg), **side["kw"])
    p.up(wait_ready_s=60)
    led = None
    try:
        ids = [f"tx-{i:03d}" for i in range(N)]
        client.produce_batch(cfg.kafka_topic, [{"id": t, "Amount": 10.0 + i}
                                               for i, t in enumerate(ids)], keys=ids)
        topic = cfg.kafka_topic
        _wait(lambda: sum(client.committed_offsets("router", topic)) == N)
        assert client.committed_offsets("router", topic) == client.end_offsets(topic)
        led = client.consumer("t-ledger", (LEDGER_TOPIC,))
        entries: list = []
        _wait(lambda: entries.extend(side["flatten"](led.poll(1024, 0.2)))
              or len(entries) >= N)
        fleet = p.fleet
        _wait(lambda: fleet.health_snapshot()["partitions"] == [0, 1])
        snap = fleet.health_snapshot()
        tx = p.router._tx_consumer
        code, body = _get(p.exporter.endpoint + "/healthz")
        out = {
            "committed": client.committed_offsets("router", topic),
            "ledger": sorted(e["tx"] for e in entries),
            "members": sorted({e["member"] for e in entries}),
            "epochs_int": all(isinstance(e["epoch"], int) for e in entries),
            "partitions": snap["partitions"],
            "manual": tx._auto_commit is False,
            "healthz": (code, json.loads(body)["sources"]["fleet"]),
            "fenced": p.registries["router"].counter("router_fenced_commits_total").total(),
        }
        if name == "port":
            from ccfd_tpu_torch.params import params_fingerprint
            from ccfd_tpu_torch.runtime.durability import ComposedHealGate

            out["fingerprint_ok"] = snap["fingerprint"] == params_fingerprint(p.scorer.params)
            gate = p.router._heal_gate
            out["composed"] = (isinstance(gate, ComposedHealGate)
                               and fleet.parity_gate in gate.gates)
            out["status"] = p.status()["fleet"]
            def gauges():
                text = _get(p.exporter.endpoint + "/prometheus")[1].decode()
                return sorted({ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                               if ln.startswith("ccfd_fleet_")})

            # the gossip loop's first tick publishes them
            _wait(lambda: "ccfd_fleet_members" in gauges(), timeout=10)
            out["gauges"] = gauges()
            fleet.parity_gate.quarantine("stale champion")
            out["quarantined_health"] = json.loads(
                _get(p.exporter.endpoint + "/healthz")[1])["sources"]["fleet"]
            out["gate_pins"] = (gate.device_allowed(), gate.host_allowed())
            fleet.parity_gate.release()
            out["endpoint"] = fleet.endpoint
        return out
    finally:
        if led is not None:
            led.close()
        p.down()
        client.close()
        srv.stop()


def test_the_fleet_block_routes_commits_and_ledgers_as_the_references():
    ref, port = _run("ref"), _run("port")
    shared = ("committed", "ledger", "members", "epochs_int", "partitions", "manual",
              "healthz", "fenced")
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    assert port["ledger"] == [f"tx-{i:03d}" for i in range(N)]
    assert port["members"] == ["m00"] and port["epochs_int"] and port["manual"]
    assert port["healthz"] == (200, {"healthy": True, "cause": "parity clean"})
    assert port["fingerprint_ok"] and port["composed"]
    assert port["status"]["member"] == "m00" and port["status"]["quarantined"] is False
    assert {"ccfd_fleet_members", "ccfd_fleet_epoch", "ccfd_fleet_partition_owner",
            "ccfd_fleet_parity", "ccfd_fleet_quarantined", "ccfd_fleet_aggregator"} <= set(
        port["gauges"])
    assert port["quarantined_health"] == {"healthy": False, "cause": "parity quarantined"}
    assert port["gate_pins"] == (False, False)
    # down() closed the heartbeat server
    with pytest.raises(OSError):
        urllib.request.urlopen(port["endpoint"] + "/fleet/health", timeout=2)


def test_up_with_fleet_on_and_a_bus_url_comes_up(tmp_path, capsys):
    from ccfd_tpu_torch.cli import main

    srv = BrokerServer(Broker(default_partitions=2))
    url = f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"
    cr = _cr(url)
    cr["spec"]["producer"] = {"enabled": True, "transactions": 200}
    cr["spec"]["monitoring"] = {"enabled": True, "port": 0}
    cr["spec"]["health"] = {"enabled": True, "port": 0}
    path = tmp_path / "cr.yaml"
    path.write_text(yaml.safe_dump(cr))
    assert PlatformSpec.from_yaml(str(path), cfg=Config()).refused() == []
    client = RemoteBroker(url)
    try:
        assert main(["up", "-f", str(path), "--exit-after-producer", "--drain-s", "60",
                     "--device", "cpu"]) == 0
        err = capsys.readouterr().err
        assert "router drained" in err and '"fleet": {' in err
        topic = Config.from_env().kafka_topic
        assert sum(client.committed_offsets("router", topic)) == 200
        assert "fleet_ledger_entries_total 200" in err
    finally:
        client.close()
        srv.stop()
