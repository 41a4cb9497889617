"""The port's crash recovery against the reference's (runtime/recovery.py).

The same bus and engine sequence on both sides: a durable in-process
broker, the fraud and standard processes on a manual clock, a router driven
by ``step()`` scoring by a deterministic rule on the amount, then the
coordinator's checkpoint, more traffic, a restore (the engine "crashed"),
the re-driven gap, a second checkpoint to disk, and a full bounce
(``restore_from_disk`` in a new coordinator on the same log dir). At each
point the cut documents (but for their wall-clock ``ts``), the committed
offsets (the retention pin's included), the audit markers and the restored
engines' snapshots are equal. Tolerance: none.
"""

from __future__ import annotations

import time

import numpy as np

from ccfd_tpu.bus import broker as ref_broker_mod
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.process.clock import ManualClock as RefClock
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu.router.router import Router as RefRouter
from ccfd_tpu.runtime import recovery as ref_recovery
from ccfd_tpu.runtime.supervisor import Supervisor as RefSupervisor
from ccfd_tpu_torch.bus import broker as port_broker_mod
from ccfd_tpu_torch.config import Config as PortConfig
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.metrics.prom import Registry as PortRegistry
from ccfd_tpu_torch.process.clock import ManualClock as PortClock
from ccfd_tpu_torch.process.fraud import build_engine as port_build_engine
from ccfd_tpu_torch.router.router import Router as PortRouter
from ccfd_tpu_torch.runtime import recovery as port_recovery
from ccfd_tpu_torch.runtime.supervisor import Supervisor as PortSupervisor

ENV = {"FRAUD_THRESHOLD": "0.5", "CCFD_AUDIT_TOPIC": "ccd-audit",
       "CCFD_REPLY_TIMEOUT_S": "30"}
AMOUNT = FEATURE_NAMES.index("Amount")


def amount_score(x: np.ndarray) -> np.ndarray:
    return (x[:, AMOUNT] > 150.0).astype(np.float32) * np.float32(0.9)


def _rows(lo: int, hi: int) -> list[dict]:
    rng = np.random.default_rng(lo)
    out = []
    for i in range(lo, hi):
        row = {name: float(v) for name, v in zip(FEATURE_NAMES, rng.normal(size=30))}
        row["Amount"] = float(rng.choice([20.0, 120.0, 400.0, 900.0]))
        row["id"] = i
        out.append(row)
    return out


class _Side:
    def __init__(self, side: str, log_dir: str, cut_path: str):
        ref = side == "ref"
        self.cfg = (RefConfig if ref else PortConfig).from_env(ENV)
        self.bmod = ref_broker_mod if ref else port_broker_mod
        self.broker = self.bmod.Broker(default_partitions=2, log_dir=log_dir)
        self.clock = (RefClock if ref else PortClock)(start=1000.0)
        self.reg = (RefRegistry if ref else PortRegistry)()
        build = ref_build_engine if ref else port_build_engine
        self.factory = lambda: build(self.cfg, self.broker, self.reg, clock=self.clock)
        self.router = (RefRouter if ref else PortRouter)(
            self.cfg, self.broker, amount_score, self.factory(), (RefRegistry if ref
                                                                   else PortRegistry)())
        self.router.stop()  # driven by step(): no loop to ack the barrier
        self.mod = ref_recovery if ref else port_recovery
        self.coord = self.mod.CheckpointCoordinator(self.router, self.broker, self.factory,
                                                    pause_timeout_s=0.0, path=cut_path)
        self.sup = (RefSupervisor if ref else PortSupervisor)()

    def drive(self, rows: list[dict]) -> None:
        self.broker.produce_batch(self.cfg.kafka_topic, rows, [r["id"] for r in rows])
        while self.router.step(0.0):
            pass
        self.clock.advance(1.0)

    def offsets(self) -> dict:
        return {g: self.broker.committed_offsets(g, t) for g, t in (
            ("router", self.cfg.kafka_topic),
            ("router-responses", self.cfg.customer_response_topic),
            (self.bmod.RETENTION_PIN_GROUP, self.cfg.kafka_topic))}

    def audit_markers(self) -> list:
        c = self.broker.consumer("t-audit", (self.cfg.audit_topic,))
        out = [r.value for r in c.poll(100000, 0.0) if r.value.get("event") == "engine_restored"]
        return [{k: v for k, v in m.items() if k != "ts"} for m in out]


def _no_ts(cut):
    return {k: v for k, v in cut.items() if k != "ts"}


def _scenario(side: str, tmp) -> list:
    s = _Side(side, str(tmp / side / "bus"), str(tmp / side / "cut.json"))
    out = []
    s.drive(_rows(0, 200))
    cut1 = s.coord.checkpoint()
    out.append(("cut1", _no_ts(cut1), s.offsets()))
    s.drive(_rows(200, 300))  # the post-cut gap the crash rolls back
    engine = s.coord.restore(reason="test")
    out.append(("restored", engine.snapshot(), s.offsets(), s.router.engine is engine))
    s.drive([])  # re-drive the gap from the rewound bus
    out.append(("redriven", s.router.engine.snapshot(), s.offsets()))
    cut2 = s.coord.checkpoint()
    out.append(("cut2", _no_ts(cut2)))
    s.drive(_rows(300, 340))
    out.append(("markers", s.audit_markers()))
    s.broker.close()
    # the full bounce: a new broker on the same log, a new router and
    # coordinator; bring-up restores the on-disk cut and re-drives its gap
    b = _Side(side, str(tmp / side / "bus"), str(tmp / side / "cut.json"))
    restored = b.coord.restore_from_disk()
    out.append(("boot", restored.snapshot(), b.offsets(), b.coord.restores))
    b.drive([])
    out.append(("bounced", b.router.engine.snapshot(), b.offsets()))
    # the engine as a supervised service: a failure restores the last cut
    b.mod.attach_engine_service(b.sup, b.coord)
    b.sup.start()
    assert b.sup.wait_ready(5.0)
    old = b.router.engine
    assert b.sup.inject_failure("engine", "test")
    deadline = time.monotonic() + 10
    while b.coord.restores < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    out.append(("supervised", b.coord.restores, b.router.engine is not old))
    b.sup.stop()
    b.broker.close()
    return out


def test_same_sequence_same_cuts_and_restored_state(tmp_path):
    ref = _scenario("ref", tmp_path)
    port = _scenario("port", tmp_path)
    assert port == ref
    cut1 = port[0][1]
    assert sum(cut1["offsets"]["router\x00odh-demo"]) == 200
    restored, redriven = port[1], port[2]
    assert restored[3] and restored[1]["next_pid"] == 201  # rolled back to the cut
    assert redriven[1]["next_pid"] == 301  # every gap row started once more
    assert port[-1] == ("supervised", 2, True)


def test_cut_file_is_the_references_format(tmp_path):
    """The port reads the reference's cut file and the reference the
    port's (the checksummed artifact of runtime/durability.py)."""
    from ccfd_tpu.runtime.durability import read_json_artifact as ref_read
    from ccfd_tpu_torch.runtime.durability import read_json_artifact as port_read

    for side in ("ref", "port"):
        s = _Side(side, str(tmp_path / side / "bus"), str(tmp_path / side / "cut.json"))
        s.drive(_rows(0, 50))
        s.coord.checkpoint()
        s.broker.close()
    for side in ("ref", "port"):
        path = str(tmp_path / side / "cut.json")
        a = ref_read(path, artifact="recovery_cut", quarantine=False)
        b = port_read(path, artifact="recovery_cut", quarantine=False)
        assert a == b and a["version"] == 1
    ra = ref_read(str(tmp_path / "ref" / "cut.json"), artifact="c", quarantine=False)
    pa = port_read(str(tmp_path / "port" / "cut.json"), artifact="c", quarantine=False)
    assert _no_ts(ra) == _no_ts(pa)


def test_storage_pin_pins_the_ladder_to_the_rules_tier_as_the_reference():
    """runtime/durability.py's StoragePinGate on the router's heal-gate
    seam (what the operator binds): pinned, the ladder skips the scorer
    edge and the host tier (the rules tier takes every row), unpinned the
    scorer serves again; ComposedHealGate ANDs its gates. Both sides'
    counters equal."""
    from ccfd_tpu.runtime import durability as ref_dur
    from ccfd_tpu_torch.runtime import durability as port_dur

    def run(side):
        ref = side == "ref"
        cfg = (RefConfig if ref else PortConfig).from_env(ENV)
        broker = (ref_broker_mod if ref else port_broker_mod).Broker(default_partitions=1)
        reg = (RefRegistry if ref else PortRegistry)()
        calls = {"device": 0, "host": 0}

        def device(x):
            calls["device"] += 1
            return amount_score(x)

        def host(x):
            calls["host"] += 1
            return amount_score(x)

        build = ref_build_engine if ref else port_build_engine
        router = (RefRouter if ref else PortRouter)(
            cfg, broker, device, build(cfg, broker, (RefRegistry if ref else PortRegistry)()),
            reg, host_score_fn=host, degrade=True)
        dur = ref_dur if ref else port_dur
        gate = dur.StoragePinGate(registry=reg)
        router.set_heal_gate(gate)
        out = []
        for pinned, rows in ((True, _rows(0, 50)), (False, _rows(50, 80))):
            if pinned:
                gate.pin("no params generation verifies")
            else:
                gate.unpin()
            broker.produce_batch(cfg.kafka_topic, rows, [r["id"] for r in rows])
            while router.step(0.0):
                pass
            out.append((dict(calls), reg.counter("router_degraded_total").value(
                {"tier": "rules"}), reg.get("ccfd_storage_pinned").value(), gate.pins))

        class Dev:  # a heal gate that blocks the device but not the host
            def device_allowed(self):
                return False

        composed = dur.ComposedHealGate(gate, Dev(), None)
        out.append((composed.device_allowed(), composed.host_allowed(), len(composed.gates)))
        return out

    port, ref = run("port"), run("ref")
    assert port == ref
    assert port[0] == ({"device": 0, "host": 0}, 50.0, 1.0, 1)
    assert port[1][0]["device"] >= 1 and port[1][1] == 50.0 and port[1][2] == 0.0
    assert port[2] == (False, True, 2)
