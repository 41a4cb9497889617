"""The port's fleet member and ledger (ccfd_tpu_torch/fleet/member.py,
ledger.py, supervisor.py) against the reference's.

The behaviours of tests/test_fleet.py, each run on both packages with the
reference's ``pair`` shape: members on real loopback heartbeat HTTP and
one injected clock per package, driven through the same event sequence
(kills, lease expiry without sleeping, respawns, fingerprint flips). Every
``tick()`` view (live, aggregator, admission ceiling, dead, the parity
verdict) equals the reference's at the same step, and so do the gauges,
the kill bundles and the health snapshot. The parity gate's heal-gate
surface composes through each package's ComposedHealGate; the ledger tap
publishes, forwards and counts a bus failure the same way; and
``build_member_cr`` equals the reference's but for the member's device.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest

from ccfd_tpu.fleet import ledger as ref_ledger
from ccfd_tpu.fleet import member as ref_member
from ccfd_tpu.fleet import supervisor as ref_supervisor
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.runtime.durability import ComposedHealGate as RefComposed
from ccfd_tpu_torch.fleet import ledger as port_ledger
from ccfd_tpu_torch.fleet import member as port_member
from ccfd_tpu_torch.fleet import supervisor as port_supervisor
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.runtime.durability import ComposedHealGate
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)

TTL = 3.0
SIDES = {
    "ref": dict(member=ref_member, ledger=ref_ledger, supervisor=ref_supervisor,
                registry=RefRegistry, composed=RefComposed),
    "port": dict(member=port_member, ledger=port_ledger, supervisor=port_supervisor,
                 registry=Registry, composed=ComposedHealGate),
}
VIEW_KEYS = ("live", "aggregator", "admission_ceiling", "dead", "parity", "partitions",
             "epoch")


class _FakeBudget:
    def __init__(self, max_limit=100):
        self.max_limit = max_limit
        self.ceilings = []

    def rescale_ceiling(self, v):
        self.ceilings.append(int(v))
        self.max_limit = int(v)


class _FakeRecorder:
    def __init__(self):
        self.incidents = []
        self._mu = threading.Lock()

    def incident(self, trigger):
        with self._mu:
            self.incidents.append(dict(trigger))


class _Pair:
    """One package's members on loopback heartbeat HTTP under one fake clock."""

    def __init__(self, side):
        self.side = side
        self.clk = [0.0]
        self.made = []

    def member(self, name, peers=(), **kw):
        kw.setdefault("gossip_timeout_s", 2.0)
        m = self.side["member"].FleetMember(
            name, self.side["registry"](), peers=peers, heartbeat_port=kw.pop("port", 0),
            ttl_s=TTL, clock=lambda: self.clk[0], **kw)
        m.start_server()
        self.made.append(m)
        return m

    def close(self):
        for m in self.made:
            m.close()


@pytest.fixture()
def pairs():
    made = {name: _Pair(side) for name, side in SIDES.items()}
    yield made
    for p in made.values():
        p.close()


def _view(v: dict) -> dict:
    return {k: v[k] for k in VIEW_KEYS}


def _gauge(m, name, labels=None):
    return m.registry.get(name).value(labels=labels) if labels else \
        m.registry.get(name).value()


def _both(pairs, script):
    """Run ``script(pair) -> list of observations`` on both packages."""
    return {name: script(pair) for name, pair in pairs.items()}


# -- parity gate -------------------------------------------------------------


def test_parity_gate_heal_gate_surface_and_composition():
    for side in SIDES.values():
        reg = side["registry"]()
        gate = side["member"].FleetParityGate(reg)
        assert gate.device_allowed() and gate.host_allowed()
        assert reg.get("ccfd_fleet_quarantined").value() == 0.0
        other = SimpleNamespace(device_allowed=lambda: True, host_allowed=lambda: True)
        composed = side["composed"](other, gate)
        assert composed.device_allowed() and composed.host_allowed()
        gate.quarantine("fingerprint diverged")
        assert not gate.device_allowed() and not gate.host_allowed()
        assert not composed.device_allowed() and not composed.host_allowed()
        assert gate.reason == "fingerprint diverged"
        assert reg.get("ccfd_fleet_quarantined").value() == 1.0
        gate.release()
        assert gate.device_allowed() and composed.host_allowed() and gate.reason is None
        assert reg.get("ccfd_fleet_quarantined").value() == 0.0


# -- member gossip / actuators -------------------------------------------------


def test_gossip_membership_aggregator_and_gauges(pairs):
    def script(p):
        b = p.member("b")
        a = p.member("a", peers=[b.endpoint])
        va, vb = a.tick(), b.tick()
        return [_view(va), _view(vb), _gauge(a, "ccfd_fleet_members"),
                _gauge(a, "ccfd_fleet_aggregator"), _gauge(b, "ccfd_fleet_aggregator")]

    out = _both(pairs, script)
    assert out["port"] == out["ref"]
    assert out["port"][0]["live"] == ["a", "b"] and out["port"][0]["aggregator"] == "a"
    assert out["port"][1]["live"] == ["b"] and out["port"][2:] == [2.0, 1.0, 1.0]


def test_lease_expiry_marks_peer_dead_without_sleeping(pairs):
    def script(p):
        b = p.member("b")
        a = p.member("a", peers=[b.endpoint])
        first = _view(a.tick())
        b.close()  # hard stop: the endpoint vanishes mid-lease
        p.clk[0] = TTL + 1.0
        second = _view(a.tick())
        return [first, second, _gauge(a, "ccfd_fleet_members"),
                a.registry.get("fleet_gossip_errors_total").total()]

    out = _both(pairs, script)
    assert out["port"] == out["ref"]
    assert out["port"][1]["live"] == ["a"] and out["port"][1]["dead"] == ["b"]
    assert out["port"][2] == 1.0 and out["port"][3] >= 1


def test_kill_bundle_fires_once_per_incarnation(pairs):
    def script(p):
        rec = _FakeRecorder()
        b = p.member("b")
        first_inc = b.incarnation
        a = p.member("a", peers=[b.endpoint], recorder=rec)
        views = [_view(a.tick())]
        b.close()
        p.clk[0] = TTL + 1.0
        views.append(_view(a.tick()))  # death detected: exactly one bundle
        p.clk[0] += TTL + 1.0  # past the redial backoff cap (ttl_s)
        views.append(_view(a.tick()))  # still dead: no second bundle
        n_after_first = len(rec.incidents)
        # a NEW incarnation on the same endpoint rejoins...
        b2 = p.member("b", port=b.heartbeat_port)
        p.clk[0] += TTL + 1.0
        views.append(_view(a.tick()))
        # ...and its kill is a second bundle
        b2.close()
        p.clk[0] += TTL + 1.0
        views.append(_view(a.tick()))
        incs = [{k: v for k, v in i.items() if k != "incarnation"} for i in rec.incidents]
        return {"views": views, "n_after_first": n_after_first, "incidents": incs,
                "same_first": rec.incidents[0]["incarnation"] == first_inc,
                "second_is_new": (len(rec.incidents) == 2
                                  and rec.incidents[1]["incarnation"] == b2.incarnation
                                  != first_inc),
                "bundles": a.registry.get("fleet_member_kill_bundles_total").value()}

    out = _both(pairs, script)
    assert out["port"] == out["ref"]
    p = out["port"]
    assert p["n_after_first"] == 1 and p["same_first"] and p["second_is_new"]
    assert p["incidents"][0] == {"type": "fleet_member_kill", "member": "b",
                                 "survivors": ["a"], "epoch": 0}
    assert p["views"][3]["live"] == ["a", "b"] and p["bundles"] == 2.0


def test_admission_share_rescales_on_death_and_rejoin(pairs):
    def script(p):
        budget = _FakeBudget(max_limit=100)
        b = p.member("b")
        a = p.member("a", peers=[b.endpoint], overload=SimpleNamespace(budget=budget),
                     global_max_inflight=100)
        views = [_view(a.tick())]
        port = b.heartbeat_port
        b.close()
        p.clk[0] = TTL + 1.0
        views.append(_view(a.tick()))
        p.member("b", port=port)  # rejoin hands the share back
        p.clk[0] += TTL + 1.0
        views.append(_view(a.tick()))
        return {"views": views, "ceilings": budget.ceilings,
                "gauge": _gauge(a, "ccfd_fleet_admission_ceiling")}

    out = _both(pairs, script)
    assert out["port"] == out["ref"]
    assert [v["admission_ceiling"] for v in out["port"]["views"]] == [50, 100, 50]
    assert out["port"]["gauge"] == 50.0


def test_the_real_budget_rescales_like_the_references():
    """The actuator itself: AdaptiveInflightBudget.rescale_ceiling clamps the
    live limit into the new range, as the reference's does."""
    from ccfd_tpu.runtime.overload import AdaptiveInflightBudget as RefBudget
    from ccfd_tpu_torch.runtime.overload import AdaptiveInflightBudget

    seq = [(50, None), (200, None), (8, 4), (1, None), (0, 0), (64, 2)]
    states = {}
    for name, cls, reg in (("ref", RefBudget, RefRegistry()),
                           ("port", AdaptiveInflightBudget, Registry())):
        b = cls(100, registry=reg)
        out = []
        for mx, mn in seq:
            b.rescale_ceiling(mx, mn)
            out.append((b.limit, b.min_limit, b.max_limit,
                        reg.get("ccfd_inflight_limit").value(labels={"stage": "router"})))
        states[name] = out
    assert states["port"] == states["ref"]


def test_stale_member_self_quarantines_and_releases(pairs):
    def script(p):
        fp_b = ["aaa"]
        b = p.member("b", fingerprint_fn=lambda: fp_b[0])
        b.tick()
        a = p.member("a", peers=[b.endpoint], fingerprint_fn=lambda: "bbb")
        v1 = _view(a.tick())
        q1 = (a.parity_gate.quarantined, a.parity_gate.device_allowed(),
              _gauge(a, "ccfd_fleet_parity"))
        fp_b[0] = "bbb"
        v2 = _view(a.tick())
        q2 = (a.parity_gate.quarantined, _gauge(a, "ccfd_fleet_parity"))
        return [v1, q1, v2, q2]

    out = _both(pairs, script)
    assert out["port"] == out["ref"]
    assert out["port"][1] == (True, False, 0.0) and out["port"][3] == (False, 1.0)


def test_a_quarantined_member_pins_the_operators_composed_gate():
    """The operator's order: storage pin, heal supervisor, parity gate; a
    stale champion refuses both tiers through the composition."""
    for side in SIDES.values():
        gate = side["member"].FleetParityGate(side["registry"]())
        storage = SimpleNamespace(device_allowed=lambda: True, host_allowed=lambda: True)
        heal = SimpleNamespace(device_allowed=lambda: True)
        composed = side["composed"](storage, heal, gate)
        assert composed.device_allowed() and composed.host_allowed()
        gate.quarantine("stale")
        assert (composed.device_allowed(), composed.host_allowed()) == (False, False)


def test_health_snapshot_reads_live_consumers(pairs):
    def script(p):
        consumers = [SimpleNamespace(assignment=[("t", 0), ("t", 2)], epoch=4),
                     SimpleNamespace(assignment=[("t", 1)], epoch=3)]
        a = p.member("a", consumers_fn=lambda: consumers,
                     counters_fn=lambda: {"incoming": 5, "routed": 5, "shed": 0,
                                          "errors": 0})
        view = _view(a.tick())
        snap = a.health_snapshot()
        gauges = [_gauge(a, "ccfd_fleet_partition_owner", {"partition": str(i)})
                  for i in range(3)] + [_gauge(a, "ccfd_fleet_epoch")]
        return [view, {k: v for k, v in snap.items() if k not in ("incarnation", "pid")},
                gauges]

    out = _both(pairs, script)
    assert out["port"] == out["ref"]
    snap = out["port"][1]
    assert snap["member"] == "a" and snap["partitions"] == [0, 1, 2] and snap["epoch"] == 4
    assert snap["counters"]["incoming"] == 5 and snap["quarantined"] is False
    assert snap["aggregator"] is True and out["port"][2] == [1.0, 1.0, 1.0, 4.0]


def test_the_heartbeat_endpoint_serves_the_snapshot_and_404s_elsewhere(pairs):
    import json
    import urllib.error
    import urllib.request

    p = pairs["port"]
    a = p.member("a")
    a.tick()
    with urllib.request.urlopen(a.endpoint + port_member.HEALTH_PATH, timeout=5) as r:
        body = json.loads(r.read())
    assert body["member"] == "a" and body["live"] == ["a"]
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(a.endpoint + "/nope", timeout=5)
    assert port_member.HEALTH_PATH == ref_member.HEALTH_PATH


# -- ledger tap --------------------------------------------------------------


class _FakeBroker:
    def __init__(self, fail=False):
        self.fail = fail
        self.produced = []

    def produce(self, topic, value, key=None):
        if self.fail:
            raise ConnectionError("bus edge down")
        self.produced.append((topic, value, key))


def test_ledger_tap_publishes_batch_and_forwards_inner():
    out = {}
    for name, side in SIDES.items():
        reg = side["registry"]()
        broker = _FakeBroker()
        seen = []
        inner = SimpleNamespace(record_batch=lambda rows, **kw: seen.append((rows, kw)))
        tap = side["ledger"].FleetLedgerTap(broker, "m00", inner=inner, epoch_fn=lambda: 7,
                                            registry=reg)
        rows = [{"tx": "a", "uid": "u1"}, {"tx": "b", "uid": "u2"}]
        tap.record_batch(rows, tier="device", worker=0)
        tap.record_batch([])
        assert seen[0][0] is rows
        out[name] = {"produced": broker.produced, "inner_kw": seen[0][1],
                     "entries": reg.get("fleet_ledger_entries_total").value()}
    assert out["port"] == out["ref"]
    topic, value, key = out["port"]["produced"][0]
    assert topic == port_ledger.LEDGER_TOPIC == ref_ledger.LEDGER_TOPIC and key == "m00"
    assert value["epoch"] == 7 and [e["tx"] for e in value["entries"]] == ["a", "b"]
    assert len(out["port"]["produced"]) == 1 and out["port"]["entries"] == 2.0


def test_ledger_tap_bus_failure_is_counted_never_raised():
    for side in SIDES.values():
        reg = side["registry"]()
        tap = side["ledger"].FleetLedgerTap(_FakeBroker(fail=True), "m00", registry=reg)
        tap.record_batch([{"tx": "a", "uid": "u"}])  # must not raise
        assert reg.get("fleet_ledger_publish_errors_total").value(
            labels={"stage": "produce"}) == 1.0
        assert reg.get("fleet_ledger_entries_total").value() == 0.0
        # an epoch read that raises stamps None and counts, never raises
        tap2 = side["ledger"].FleetLedgerTap(_FakeBroker(), "m00", registry=reg,
                                             epoch_fn=lambda: 1 / 0)
        tap2.record_batch([{"tx": "b"}])
        assert tap2.broker.produced[0][1]["epoch"] is None
        assert reg.get("fleet_ledger_publish_errors_total").value(
            labels={"stage": "epoch"}) == 1.0


def test_flatten_ledger_restamps_member_and_epoch():
    recs = [
        SimpleNamespace(value={"member": "m00", "epoch": 1,
                               "entries": [{"tx": "a", "uid": "u", "tier": "device"}]}),
        {"member": "m01", "epoch": 2, "entries": [{"tx": "b", "uid": "v", "tier": "host"}]},
        SimpleNamespace(value="not-a-ledger-record"),  # skipped, not fatal
    ]
    flat = port_ledger.flatten_ledger(recs)
    assert flat == ref_ledger.flatten_ledger(recs)
    assert [(e["tx"], e["member"], e["epoch"]) for e in flat] == [
        ("a", "m00", 1), ("b", "m01", 2)]


# -- the member CR -------------------------------------------------------------


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_build_member_cr_is_the_references_but_the_device(device, tmp_path):
    args = ("m01", "http://127.0.0.1:9", 8123, ["http://127.0.0.1:8001"], str(tmp_path))
    kw = dict(ttl_s=2.0, global_max_inflight=64, monitoring_port=9100,
              overrides={"router": {"max_inflight": 32}, "tracing": True})
    port_cr = port_supervisor.build_member_cr(*args, device=device, **kw)
    ref_cr = ref_supervisor.build_member_cr(*args, **kw)
    assert port_cr["spec"]["fleet"].pop("device") == device
    assert port_cr == ref_cr
    spec = port_cr["spec"]
    for comp in ("retrain", "lifecycle", "audit", "durability"):
        assert spec[comp] is False, comp
    assert spec["engine"]["enabled"] is True and spec["router"]["workers"] == 1
    assert spec["incident"]["dir"].endswith("incidents-m01")
    # the default is the card
    assert port_supervisor.build_member_cr(*args)["spec"]["fleet"]["device"] == "cuda"


def test_the_supervisor_starts_members_as_the_ports_command(tmp_path, monkeypatch):
    """spawn() execs ``python -m ccfd_tpu_torch fleet member --spec S
    --device D`` (a fresh interpreter, never a fork of a process holding a
    CUDA context); add_member refuses an unpinned heartbeat port."""
    import subprocess

    seen = {}

    class _Proc:
        pid = 4242

        def __init__(self, argv, **kw):
            seen["argv"], seen["kw"] = argv, kw

        def poll(self):
            return None

    monkeypatch.setattr(subprocess, "Popen", _Proc)
    sup = port_supervisor.FleetSupervisor("http://127.0.0.1:1", str(tmp_path), device="cpu",
                                          registry=Registry())
    with pytest.raises(ValueError, match="heartbeat_port"):
        sup.add_member("x", port_supervisor.build_member_cr(
            "x", "http://127.0.0.1:1", 0, [], str(tmp_path)))
    path = sup.add_member("m00", port_supervisor.build_member_cr(
        "m00", "http://127.0.0.1:1", 8123, [], str(tmp_path), device="cpu"))
    assert sup.spawn("m00") == 4242
    assert seen["argv"][1:] == ["-m", "ccfd_tpu_torch", "fleet", "member", "--spec", path,
                                "--device", "cpu"]
    assert sup.status()["m00"]["endpoint"] == "http://127.0.0.1:8123"
    sup.members["m00"]["log"].close()
