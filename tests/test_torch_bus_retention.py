"""The port's Broker retention, log-start offsets and crash restart
(ccfd_tpu_torch/bus/broker.py) against the reference's
(ccfd_tpu/bus/broker.py): one seeded sequence of produces, polls, commits,
rewinds, retention changes and crash restarts drives both, and after every
step their log-start and end offsets, committed offsets (after the clamp),
``records_trimmed``, out-of-range resets and delivered records are equal."""

from __future__ import annotations

import random

import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.bus.server import BrokerServer as RefServer
from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu_torch.bus.broker import Broker as PortBroker
from ccfd_tpu_torch.bus.server import BrokerServer as PortServer
from ccfd_tpu_torch.metrics.prom import Registry as PortRegistry

TOPICS = ("tx", "audit", "labels")
GROUPS = (("router", ("tx",), True), ("tail", ("audit",), False),
          ("trainer", ("labels", "tx"), True))


class Twin:
    """The same operations on a reference and a port broker."""

    def __init__(self, tmp_path, durable: bool, retention: int | None,
                 overrides: dict | None):
        kw = dict(retention_records=retention, retention_overrides=overrides,
                  segment_bytes=600)
        self.ref = RefBroker(log_dir=str(tmp_path / "ref") if durable else None, **kw)
        self.port = PortBroker(log_dir=str(tmp_path / "port") if durable else None, **kw)
        self.members: list[tuple] = []  # (group, auto, ref consumer, port consumer)

    def both(self, name: str, *args, **kw):
        a = getattr(self.ref, name)(*args, **kw)
        b = getattr(self.port, name)(*args, **kw)
        return a, b

    def join(self, group: str, topics: tuple, auto: bool) -> None:
        r, p = self.both("consumer", group, list(topics), auto_commit=auto)
        self.members.append((group, auto, r, p))

    def state(self) -> dict:
        out = {}
        for side, b in (("ref", self.ref), ("port", self.port)):
            snap = b.health_snapshot()
            out[side] = {
                "ends": {t: b.end_offsets(t) for t in TOPICS},
                "begins": {t: b.beginning_offsets(t) for t in TOPICS},
                "committed": {(g, t): b.committed_offsets(g, t)
                              for g, ts, _ in GROUPS for t in ts},
                "trimmed": b.records_trimmed,
                "oor": b.oor_resets,
                "fenced": b.fenced_commits,
                "epochs": {g: b.group_epoch(g) for g, _, _ in GROUPS},
                "snapshot": snap,
            }
        return out


def _view(recs) -> list:
    return [(r.topic, r.partition, r.offset, r.key, r.value) for r in recs]


def run_sequence(twin: Twin, seed: int, steps: int, durable: bool) -> dict:
    rng = random.Random(seed)
    for g, ts, auto in GROUPS:
        twin.join(g, ts, auto)
    seen = {"oor": 0, "trimmed": 0, "restarts": 0}
    for step in range(steps):
        op = rng.random()
        if op < 0.35:
            topic = rng.choice(TOPICS)
            n = rng.randrange(1, 40)
            keys = [rng.choice((None, f"k{rng.randrange(5)}", rng.randrange(9)))
                    for _ in range(n)]
            values = [{"step": step, "j": j, "amt": rng.random()} for j in range(n)]
            # keyless records round-robin: the two brokers' cursors advance alike
            twin.both("produce_batch", topic, values, keys=keys)
        elif op < 0.45:
            topic = rng.choice(TOPICS)
            v = {"one": step}
            a, b = twin.both("produce", topic, v, key=f"s{step % 3}")
            assert (a.partition, a.offset) == (b.partition, b.offset)
        elif op < 0.7 and twin.members:
            g, auto, r, p = rng.choice(twin.members)
            n = rng.randrange(1, 30)
            assert _view(p.poll(n)) == _view(r.poll(n))
            if not auto and rng.random() < 0.6:
                assert p.commit() == r.commit()
        elif op < 0.76:
            g, ts, _ = rng.choice(GROUPS)
            t = ts[0]
            n_parts = len(twin.ref.end_offsets(t))
            offs = [rng.randrange(-3, 60) for _ in range(n_parts)]
            twin.both("reset_offsets", g, t, offs)
        elif op < 0.84:
            twin.both("enforce_retention", rng.choice((None,) + TOPICS))
        elif op < 0.88:
            t = rng.choice(TOPICS)
            cap = rng.choice((None, 0, 5, 20))
            twin.both("set_topic_retention", t, cap)
        elif op < 0.93 and twin.members:
            i = rng.randrange(len(twin.members))
            g, auto, r, p = twin.members.pop(i)
            r.close()
            p.close()
            if rng.random() < 0.7:
                twin.join(g, dict((x[0], x[1]) for x in GROUPS)[g], auto)
        elif durable:
            a, b = twin.both("crash_restart")
            assert b == a
            seen["restarts"] += 1
        st = twin.state()
        assert st["port"] == st["ref"], f"step {step}"
    st = twin.state()["port"]
    seen["oor"], seen["trimmed"] = st["oor"], st["trimmed"]
    return seen


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("durable", [False, True], ids=["memory", "durable"])
def test_seeded_sequence_matches_the_reference(tmp_path, seed, durable):
    twin = Twin(tmp_path, durable, retention=25, overrides={"audit": 8, "labels": None})
    seen = run_sequence(twin, seed, 220, durable)
    assert seen["trimmed"] > 0 and seen["oor"] > 0
    if durable:
        assert seen["restarts"] > 0
    twin.ref.close()
    twin.port.close()


def test_crash_restart_with_consumers_attached(tmp_path):
    """The reference's crash-restart contract, on both: the in-memory state
    is dropped and replayed from disk in place, and a registered member
    keeps reading from its group's committed offset."""
    twin = Twin(tmp_path, True, retention=None, overrides=None)
    twin.join("router", ("tx",), True)
    twin.join("tail", ("audit",), False)
    for i in range(50):
        twin.both("produce", "tx", {"i": i}, key=str(i))
        twin.both("produce", "audit", f"line {i}", key=str(i))
    _, _, r_tx, p_tx = twin.members[0]
    _, _, r_au, p_au = twin.members[1]
    assert _view(p_tx.poll(30)) == _view(r_tx.poll(30))
    assert _view(p_au.poll(20)) == _view(r_au.poll(20))
    assert p_au.commit() == r_au.commit()
    assert _view(p_au.poll(10)) == _view(r_au.poll(10))  # uncommitted: redelivered
    a, b = twin.both("crash_restart")
    assert a == b and twin.port.crash_restarts == twin.ref.crash_restarts == 1
    assert _view(p_tx.poll(100)) == _view(r_tx.poll(100))
    assert _view(p_au.poll(100)) == _view(r_au.poll(100))
    st = twin.state()
    assert st["port"] == st["ref"]


def test_memory_broker_refuses_crash_restart():
    for b in (RefBroker(), PortBroker()):
        with pytest.raises(RuntimeError, match="memory-only broker"):
            b.crash_restart()


@pytest.mark.parametrize("cap", [None, 0, 3, 17])
def test_per_topic_override_and_live_retention(cap):
    ref = RefBroker(retention_records=10, retention_overrides={"audit": cap})
    port = PortBroker(retention_records=10, retention_overrides={"audit": cap})
    for b in (ref, port):
        for i in range(60):
            b.produce("audit", {"i": i}, key="k")
            b.produce("tx", {"i": i}, key="k")
        b.enforce_retention()
    assert port.beginning_offsets("audit") == ref.beginning_offsets("audit")
    assert port.beginning_offsets("tx") == ref.beginning_offsets("tx")
    for b in (ref, port):
        b.set_topic_retention("tx", 2)
        b.set_topic_retention("audit", 5)
    assert port.beginning_offsets("tx") == ref.beginning_offsets("tx")
    assert port.beginning_offsets("audit") == ref.beginning_offsets("audit")
    assert port.records_trimmed == ref.records_trimmed > 0


def _retention_series(server, registry) -> dict:
    server.refresh_health_gauges()
    out = {}
    for line in registry.render().splitlines():
        if line.startswith(("bus_records_trimmed_total", "bus_offset_out_of_range",
                            "bus_topic_log_start_offset", "bus_topic_retained_records")):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_bus_server_publishes_the_references_retention_series(tmp_path):
    ref = RefBroker(log_dir=str(tmp_path / "r"), retention_records=4)
    port = PortBroker(log_dir=str(tmp_path / "p"), retention_records=4)
    rreg, preg = RefRegistry(), PortRegistry()
    rsrv, psrv = RefServer(ref, registry=rreg), PortServer(port, registry=preg)
    for b in (ref, port):
        c = b.consumer("g", ["t"])
        for i in range(40):
            b.produce("t", {"i": i}, key=str(i % 5))
        while c.poll(100):
            pass
        b.enforce_retention()
        b.reset_offsets("g", "t", [0] * len(b.end_offsets("t")))  # below the log start
    first = _retention_series(psrv, preg)
    assert first == _retention_series(rsrv, rreg)
    assert first["bus_records_trimmed_total"] > 0
    assert first["bus_offset_out_of_range_resets_total"] > 0
    # a crash restart reads as a flat spot in the counters, not a reset
    # (the log start falls back to the oldest segment on disk: retention
    # deletes whole segments, and this one never rolled)
    ref.crash_restart()
    port.crash_restart()
    after = _retention_series(psrv, preg)
    assert after == _retention_series(rsrv, rreg)
    for k in ("bus_records_trimmed_total", "bus_offset_out_of_range_resets_total"):
        assert after[k] == first[k]
    ref.close()
    port.close()
