"""The port's durable bus log (ccfd_tpu_torch/bus/log.py, native/log.cpp)
against the reference's (ccfd_tpu/bus/log.py): the same entries byte for
byte, directories either side replays, the same recovery of torn and
corrupt segments, and the native framing equal to its plain version."""

from __future__ import annotations

import os
import random

import pytest

from ccfd_tpu.bus import log as ref_log
from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu_torch import native
from ccfd_tpu_torch.bus import log as port_log
from ccfd_tpu_torch.bus.broker import Broker as PortBroker
from ccfd_tpu_torch.runtime import durability

SEED = 9

VALUES = [
    {"Amount": 12.5, "V1": -1.359807, "id": "tx-1"},
    {"nested": {"a": [1, 2.0, None, True]}, "s": "é ü"},
    "0.0,-1.359807,-0.072781,149.62",
    b"\x00raw\xffbytes",
    b"",
    "",
    [1, 2.5, "x"],
    None,
    3.25,
    1e-300,
]
KEYS = [None, "card-1", 17, b"\x01\x02\xff", "", 2.5]
STAMPS = [0.0, 1.5, 1792212459.263, 1.0 / 3.0, 1e21]


@pytest.mark.parametrize("value", VALUES, ids=[f"v{i}" for i in range(len(VALUES))])
@pytest.mark.parametrize("key", KEYS, ids=[f"k{i}" for i in range(len(KEYS))])
def test_encode_entry_is_the_references_bytes(key, value):
    for ts in STAMPS:
        got = port_log.encode_entry(key, ts, value)
        assert got == ref_log.encode_entry(key, ts, value)
        assert port_log.decode_entry(got) == ref_log.decode_entry(got)
        assert port_log.decode_entry(got) == (key, float(ts), value)


@pytest.fixture
def fixed_time(monkeypatch):
    """``time.time`` on a counter both brokers share in turn: a reset()
    replays the same stamps, so two runs write the same bytes."""
    import time

    state = {"t": 1_700_000_000.0}

    def fake() -> float:
        state["t"] += 0.125
        return state["t"]

    def reset() -> None:
        state["t"] = 1_700_000_000.0

    monkeypatch.setattr(time, "time", fake)
    return reset


def drive(broker_cls, d: str, seed: int = SEED, segment_bytes: int = 400,
          retention: int | None = 6, rounds: int = 60):
    """One seeded workload on a durable broker: keyed dict and CSV records,
    bytes keys, a manual and an auto group, a reset below the log start,
    retention, then a close. Returns the broker's observable state."""
    rng = random.Random(seed)
    b = broker_cls(log_dir=d, segment_bytes=segment_bytes, retention_records=retention,
                   retention_overrides={"audit": None})
    b.create_topic("tx", 3)
    auto = b.consumer("router", ["tx"])
    manual = b.consumer("audit-tail", ["audit"], auto_commit=False)
    for i in range(rounds):
        b.produce("tx", {"i": i, "Amount": rng.random() * 500}, key=f"card-{rng.randrange(9)}")
        b.produce_batch("audit", [f"{i},{j},{rng.random()!r}" for j in range(3)],
                        keys=[bytes([i % 7, j]) for j in range(3)])
        if rng.random() < 0.3:
            auto.poll(rng.randrange(1, 9))
        if rng.random() < 0.2:
            manual.poll(5)
            manual.commit()
    b.reset_offsets("router", "tx", [0, 0, 0])
    b.enforce_retention()
    state = observe(b)
    b.close()
    return state


def observe(b) -> dict:
    return {
        "ends": {t: b.end_offsets(t) for t in ("tx", "audit")},
        "begins": {t: b.beginning_offsets(t) for t in ("tx", "audit")},
        "committed": {(g, t): b.committed_offsets(g, t)
                      for g, t in (("router", "tx"), ("audit-tail", "audit"))},
    }


def records(b, topic: str) -> list:
    c = b.consumer("reader-" + topic, [topic])
    out = []
    while True:
        got = c.poll(1000)
        if not got:
            break
        out.extend((r.partition, r.offset, r.key, r.value, r.timestamp) for r in got)
    c.close()
    return sorted(out, key=lambda r: (r[0], r[1]))


def listing(d: str) -> dict:
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def test_directories_are_byte_identical(tmp_path, fixed_time):
    ref_state = drive(RefBroker, str(tmp_path / "ref"))
    fixed_time()
    port_state = drive(PortBroker, str(tmp_path / "port"))
    assert port_state == ref_state
    ref_files, port_files = listing(str(tmp_path / "ref")), listing(str(tmp_path / "port"))
    assert list(port_files) == list(ref_files)
    # retention trimmed whole segments and the chains rolled
    assert any(name.startswith("t0_p") and not name.endswith("0" * 20 + ".log")
               for name in port_files)
    assert port_files == ref_files


@pytest.mark.parametrize("writer,reader", [(PortBroker, RefBroker), (RefBroker, PortBroker)],
                         ids=["port-writes", "reference-writes"])
def test_either_side_replays_the_others_directory(tmp_path, writer, reader):
    d = str(tmp_path / "bus")
    written = drive(writer, d)
    w = writer(log_dir=d, segment_bytes=400)
    r = reader(log_dir=d, segment_bytes=400)
    try:
        assert observe(r) == observe(w) == written
        for topic in ("tx", "audit"):
            assert records(r, topic) == records(w, topic)
        # a resumed group continues where the writer's group stopped
        assert r.committed_offsets("router", "tx") == w.committed_offsets("router", "tx")
    finally:
        r.close()
        w.close()


@pytest.mark.parametrize("writer,reader", [(PortBroker, RefBroker), (RefBroker, PortBroker)],
                         ids=["port-writes", "reference-writes"])
def test_compacted_offsets_log_cross_reads(tmp_path, writer, reader):
    d = str(tmp_path / "bus")
    b = writer(log_dir=d)
    c = b.consumer("g", ["t"])
    for i in range(300):  # one commit a poll: history far past 4x the live keys
        b.produce("t", {"i": i}, key=str(i))
        c.poll(1)
    b.close()
    size = os.path.getsize(os.path.join(d, "offsets.log"))
    r = reader(log_dir=d)  # the reopen compacts
    try:
        assert os.path.getsize(os.path.join(d, "offsets.log")) < size
        w2 = writer(log_dir=d)
        assert r.committed_offsets("g", "t") == w2.committed_offsets("g", "t")
        assert sum(r.committed_offsets("g", "t")) == 300
        w2.close()
    finally:
        r.close()


def _segment(d: str) -> str:
    names = sorted(n for n in os.listdir(d) if n.startswith("t0_p0."))
    return os.path.join(d, names[0])


@pytest.mark.parametrize("damage", ["torn-tail", "mid-file", "header-length"])
def test_damaged_segment_truncates_to_the_same_prefix(tmp_path, damage):
    import shutil

    a, bdir = str(tmp_path / "a"), str(tmp_path / "b")
    w = PortBroker(default_partitions=1, log_dir=a)
    for i in range(40):
        w.produce("t", {"i": i, "pad": "x" * (i % 13)})
    w.close()
    shutil.copytree(a, bdir)
    seg_a, seg_b = _segment(a), _segment(bdir)
    data = bytearray(open(seg_a, "rb").read())
    if damage == "torn-tail":
        data = data[:-5]
    elif damage == "mid-file":
        data[len(data) // 2] ^= 0xFF
    else:
        data[len(data) // 3: len(data) // 3 + 4] = b"\xff\xff\xff\x7f"
    for seg in (seg_a, seg_b):
        with open(seg, "wb") as f:
            f.write(bytes(data))
    from ccfd_tpu.runtime import durability as ref_durability

    def dropped(mod) -> int:
        return mod.counts().get("log_truncated_records", {}).get("", 0)

    before = dropped(durability), dropped(ref_durability)
    ref_b = RefBroker(default_partitions=1, log_dir=a)
    port_b = PortBroker(default_partitions=1, log_dir=bdir)
    try:
        assert port_b.end_offsets("t") == ref_b.end_offsets("t")
        assert 0 < port_b.end_offsets("t")[0] < 40
        assert records(port_b, "t") == records(ref_b, "t")
        assert os.path.getsize(seg_a) == os.path.getsize(seg_b)
        assert open(seg_a, "rb").read() == open(seg_b, "rb").read()
        # records past a corrupt frame are counted as dropped, on both sides
        n = dropped(durability) - before[0]
        assert n == dropped(ref_durability) - before[1]
        assert (n > 0) == (damage != "torn-tail")
    finally:
        ref_b.close()
        port_b.close()


def _payloads(rng: random.Random, n: int) -> list[bytes]:
    return [rng.randbytes(rng.choice((0, 1, 7, 100, 5000))) for _ in range(n)]


@pytest.mark.parametrize("n", [0, 1, 5, 4096, 4100])
def test_native_framing_equals_the_plain_version(n):
    rng = random.Random(SEED + n)
    payloads = _payloads(rng, n)
    buf = native.frame_records(payloads)
    assert buf == native._frame_records_py(payloads)
    from ccfd_tpu.native import _scan_records_py as ref_scan

    assert native.scan_records(buf) == native._scan_records_py(buf) == ref_scan(buf)
    assert native.scan_records(buf) == (payloads, len(buf), False)


@pytest.mark.parametrize("cut", ["partial-header", "partial-payload", "bad-crc",
                                 "insane-length"])
def test_native_scan_equals_the_plain_version_on_damage(cut):
    rng = random.Random(SEED)
    payloads = _payloads(rng, 50)
    buf = bytearray(native.frame_records(payloads))
    mid = len(native._frame_records_py(payloads[:20]))
    if cut == "partial-header":
        buf = buf[:mid + 5]
    elif cut == "partial-payload":
        buf = buf[:mid + 8 + max(1, len(payloads[20]) // 2)] if payloads[20] else buf[:mid + 7]
    elif cut == "bad-crc":
        buf[mid + 4] ^= 0x01
    else:
        buf[mid: mid + 4] = (1 << 31).to_bytes(4, "little")
    got = native.scan_records(bytes(buf))
    assert got == native._scan_records_py(bytes(buf))
    assert got[0] == payloads[:20]
    assert got[2] == (cut in ("bad-crc", "insane-length"))


def test_log_open_sweeps_orphan_tmp_files(tmp_path):
    d = str(tmp_path / "bus")
    b = PortBroker(log_dir=d)
    b.produce("t", {"x": 1})
    b.close()
    orphan = os.path.join(d, "offsets.log.tmp")
    with open(orphan, "wb") as f:
        f.write(b"half a compaction")
    before = durability.counts().get("tmp_swept", {}).get("", 0)
    b = PortBroker(log_dir=d)
    assert not os.path.exists(orphan)
    assert sum(b.end_offsets("t")) == 1
    assert durability.counts()["tmp_swept"][""] == before + 1
    b.close()
