"""The port's engine persistence and audit stream
(ccfd_tpu_torch/process/engine.py, process/fraud.py) against the
reference's: the same starts, signals, task completions and timer advances
on a ManualClock give equal snapshots, read sides and audit events; a
snapshot either side saves loads in the other; a corrupt snapshot falls
back to the same last good generation; and ``engine --state-file`` keeps
its state across a SIGTERM."""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.process import fraud as ref_fraud
from ccfd_tpu.process.clock import ManualClock as RefClock
from ccfd_tpu.runtime import durability as ref_durability
from ccfd_tpu_torch.bus.broker import Broker as PortBroker
from ccfd_tpu_torch.config import Config as PortConfig
from ccfd_tpu_torch.metrics.prom import Registry as PortRegistry
from ccfd_tpu_torch.process import fraud as port_fraud
from ccfd_tpu_torch.process.clock import ManualClock as PortClock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = dict(customer_reply_timeout_s=30.0, low_amount_threshold=200.0,
             low_proba_threshold=0.75)
SIDES = {
    "ref": (RefConfig, RefBroker, RefRegistry, RefClock, ref_fraud),
    "port": (PortConfig, PortBroker, PortRegistry, PortClock, port_fraud),
}


def make(side: str, audit_topic: str = "", start: float = 0.0):
    cfg_cls, broker_cls, reg_cls, clock_cls, fraud = SIDES[side]
    broker = broker_cls()
    clock = clock_cls(start=start)
    engine = fraud.build_engine(cfg_cls(audit_topic=audit_topic, **KNOBS), broker,
                                reg_cls(), clock)
    return broker, clock, engine


def tx(rng: random.Random, i: int) -> dict:
    return {"id": f"tx-{i}", "Amount": round(rng.uniform(1, 900), 2),
            "V17": rng.gauss(0, 1), "V10": rng.gauss(0, 1)}


def drive(engines: list, clocks: list, seed: int, steps: int, check) -> None:
    """One seeded sequence of engine operations on every engine in turn,
    ``check()`` after each step."""
    rng = random.Random(seed)
    for step in range(steps):
        op = rng.random()
        if op < 0.3:
            variables = {"transaction": tx(rng, step), "proba": rng.random(),
                         "customer_id": f"c{rng.randrange(20)}"}
            pids = {e.start_process("fraud", variables) for e in engines}
            assert len(pids) == 1
        elif op < 0.4:
            batch = [{"transaction": tx(rng, step * 100 + j), "proba": rng.random()}
                     for j in range(rng.randrange(1, 6))]
            d = rng.choice(("fraud", "standard"))
            got = [e.start_process_batch(d, batch) for e in engines]
            assert all(g == got[0] for g in got)
        elif op < 0.6:
            active = engines[0].instances("active")
            if active:
                pid = rng.choice(active).pid
                payload = {"approved": rng.random() < 0.5}
                got = {e.signal(pid, ref_fraud.CUSTOMER_RESPONSE_SIGNAL, payload)
                       for e in engines}
                assert len(got) == 1
        elif op < 0.75:
            dt = rng.choice((1.0, 5.0, 29.0, 31.0))
            for c in clocks:
                c.advance(dt)
        else:
            tasks = engines[0].tasks()
            if tasks:
                tid = rng.choice(tasks).task_id
                outcome = rng.random() < 0.5
                for e in engines:
                    e.complete_task(tid, outcome)
        check()


def read_side(engine) -> dict:
    """Everything the engine answers about its state, snapshot first (it
    advances the id counters, alike on both)."""
    return {
        "snapshot": engine.snapshot(),
        "objects": engine.object_counts(),
        "recent": engine.recent_completions(50),
        "completed": [engine.completed_info(p) for p in range(1, 60)],
        "tasks": sorted((t.task_id, t.pid, t.status, t.outcome) for t in engine.tasks()),
    }


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("audit", ["", "ccd-audit"], ids=["no-audit", "audit"])
def test_same_operations_give_equal_state(seed, audit):
    rb, rc, ref = make("ref", audit)
    pb, pc, port = make("port", audit)

    def check():
        assert read_side(port) == read_side(ref)

    drive([ref, port], [rc, pc], seed, 150, check)
    assert ref.instances("active") and ref.tasks()  # both kinds of state were live


def audit_events(broker, topic: str) -> list:
    c = broker.consumer("audit-reader", [topic])
    out = []
    while True:
        got = c.poll(1000)
        if not got:
            break
        for r in got:
            ev = dict(r.value)
            ev.pop("engine")  # the engine object's process-wide tag
            out.append((r.partition, r.offset, r.key, ev))
    c.close()
    return out


@pytest.mark.parametrize("seed", [21, 22])
def test_audit_stream_on_the_bus_equals_the_references(seed):
    rb, rc, ref = make("ref", "ccd-audit")
    pb, pc, port = make("port", "ccd-audit")
    drive([ref, port], [rc, pc], seed, 200, lambda: None)
    got, want = audit_events(pb, "ccd-audit"), audit_events(rb, "ccd-audit")
    assert got == want
    kinds = {ev["event"] for *_, ev in got}
    assert {"process_started", "process_completed", "signal", "timer_fired",
            "task_created", "task_completed"} <= kinds
    # per pid, in state-change order on one partition
    by_pid: dict = {}
    for part, _off, key, ev in got:
        assert key == ev["pid"]
        by_pid.setdefault(ev["pid"], set()).add(part)
    assert all(len(parts) == 1 for parts in by_pid.values())
    # delivered completions left the runtime store, as the reference's
    assert port.object_counts() == ref.object_counts()


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")],
                         ids=["port-saves", "reference-saves"])
def test_a_saved_snapshot_loads_in_the_other_engine(tmp_path, writer, reader):
    _, wc, w = make(writer)
    drive([w], [wc], 31, 120, lambda: None)
    path = str(tmp_path / "engine.json")
    w.save(path)
    snap = w.snapshot()
    _, rc2, r = make(reader, start=1000.0)
    r.load(path)
    assert r.snapshot() == snap
    # timers re-armed on the loading engine's clock: the same timeouts fire
    _, wc2, w2 = make(writer, start=1000.0)
    w2.load(path)
    for dt in (10.0, 25.0, 40.0):
        rc2.advance(dt)
        wc2.advance(dt)
        assert read_side(r)["snapshot"] == read_side(w2)["snapshot"]


@pytest.mark.parametrize("side", ["ref", "port"])
def test_corrupt_snapshot_falls_back_to_the_last_good_generation(tmp_path, side):
    """Saved by the other side, loaded here: the newest file corrupt, the
    newest retained generation is what loads, on both sides alike."""
    other = "port" if side == "ref" else "ref"
    _, c, e = make(other)
    path = str(tmp_path / "engine.json")
    snaps = []
    rng = random.Random(41)
    for i in range(3):
        e.start_process("fraud", {"transaction": tx(rng, i), "proba": 0.9})
        e.save(path)
        snaps.append(e.snapshot())
    names = sorted(os.listdir(tmp_path))
    assert names == ["engine.json", "engine.json.g00000001", "engine.json.g00000002",
                     "engine.json.g00000003"]
    # corrupt the main file and the newest generation: g2 is the last good
    for name in ("engine.json", "engine.json.g00000003"):
        ref_durability.flip_bytes(str(tmp_path / name))
    _, _, loaded = make(side)
    loaded.load(path)
    want = snaps[1]
    got = loaded.snapshot()
    assert [i["pid"] for i in got["instances"]] == [i["pid"] for i in want["instances"]]
    assert got["instances"] == want["instances"] and got["tasks"] == want["tasks"]
    assert os.path.exists(path + ".corrupt")
    assert os.path.exists(str(tmp_path / "engine.json.g00000003.corrupt"))


def test_shutdown_silences_the_engine_as_the_reference():
    for side in ("ref", "port"):
        b, c, e = make(side, "ccd-audit")
        pid = e.start_process("fraud", {"transaction": {"id": "t", "Amount": 500.0},
                                        "proba": 0.9})
        e.shutdown()
        before = sum(b.end_offsets("ccd-audit"))
        c.advance(60.0)  # its timer was cancelled: nothing fires, nothing is emitted
        assert sum(b.end_offsets("ccd-audit")) == before
        with pytest.raises(RuntimeError, match="shut down"):
            e.signal(pid, ref_fraud.CUSTOMER_RESPONSE_SIGNAL, {"approved": True})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read())


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5) as r:
        return json.loads(r.read())


def _engine_role(port: int, state: str, log):
    env = {k: v for k, v in os.environ.items() if k not in ("BROKER_URL", "CCFD_BUS_DIR")}
    env.update(PYTHONPATH=REPO, CCFD_REPLY_TIMEOUT_S="3600")
    p = subprocess.Popen([sys.executable, "-m", "ccfd_tpu_torch", "engine", "--host",
                          "127.0.0.1", "--port", str(port), "--state-file", state,
                          "--save-interval-s", "0.2"], cwd=REPO, env=env, stdout=log,
                         stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        assert p.poll() is None, open(log.name).read()
        try:
            _get(f"http://127.0.0.1:{port}/rest/instances")
            return p
        except OSError:
            time.sleep(0.05)
    p.kill()
    raise AssertionError("engine role did not come up")


def test_engine_state_file_round_trips_through_sigterm(tmp_path):
    state = str(tmp_path / "engine.json")
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    with open(tmp_path / "engine1.log", "w") as log:
        p = _engine_role(port, state, log)
        try:
            rng = random.Random(5)
            for i in range(6):
                _post(f"{url}/rest/processes/fraud/instances",
                      {"variables": {"transaction": tx(rng, i), "proba": 0.9}})
            _post(f"{url}/rest/instances/2/signal/{ref_fraud.CUSTOMER_RESPONSE_SIGNAL}",
                  {"payload": {"approved": True}})
            before = _get(f"{url}/rest/instances?status=active")
            time.sleep(0.5)  # at least one periodic save
            p.send_signal(signal.SIGTERM)
            assert p.wait(30) == 0
        finally:
            if p.poll() is None:
                p.kill()
    log1 = open(tmp_path / "engine1.log").read()
    assert f"saved {state} ({os.path.getsize(state)} bytes)" in log1
    assert len(before) == 5
    with open(tmp_path / "engine2.log", "w") as log:
        p = _engine_role(port, state, log)
        try:
            assert _get(f"{url}/rest/instances?status=active") == before
            # the restored engine goes on allocating after the saved ids
            got = _post(f"{url}/rest/processes/standard/instances",
                        {"variables": {"transaction": tx(random.Random(6), 9), "proba": 0.1}})
            assert got["process_id"] == 7
        finally:
            p.send_signal(signal.SIGTERM)
            p.wait(30)
    assert "loaded " + state in open(tmp_path / "engine2.log").read()
    # the reference's engine loads the role's file
    _, _, ref = make("ref")
    ref.load(state)
    assert sorted(i.pid for i in ref.instances("active")) == [i["process_id"]
                                                              for i in before]


@pytest.mark.parametrize("restart", ["sigkill", "sigterm"])
def test_a_restarted_engine_takes_the_next_start_on_a_pooled_connection(tmp_path, restart):
    """ROADMAP C6, pinned: the router's engine client holds keep-alive
    connections, and the engine restarts under them. The reference's client
    sends the next process start into the dead socket: the attempt fails
    (a broken pipe it may retry, or, when the whole request was written
    before the reset came back, a loss: a start is never re-sent once it
    may have reached the engine). The port's finds the peer's close first
    and starts the batch on a fresh connection, with no retry to spend."""
    from ccfd_tpu.process.client import EngineRestClient as RefClient
    from ccfd_tpu_torch.process.client import EngineRestClient

    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    variables = [{"transaction": {"id": "t", "Amount": 1.0}, "proba": 0.1}]
    with open(tmp_path / "engine.log", "w") as log:
        p = _engine_role(port, str(tmp_path / "a.json"), log)
        ref = RefClient(url, pool_size=1, retries=0)
        mine = EngineRestClient(url, pool_size=1, retries=0)
        try:
            assert ref.start_process_batch("standard", variables) == [1]
            assert mine.start_process_batch("standard", variables) == [2]
            getattr(p, "kill" if restart == "sigkill" else "terminate")()
            p.wait(30)
            p = _engine_role(port, str(tmp_path / "b.json"), log)
            with pytest.raises(ConnectionError):
                ref.start_process_batch("standard", variables)
            assert mine.start_process_batch("standard", variables) == [1]
            assert len(_get(f"{url}/rest/instances")) == 1  # only the port's start landed
        finally:
            p.send_signal(signal.SIGTERM)
            p.wait(30)
