"""The port's KafkaAdapter (ccfd_tpu_torch/bus/kafka_adapter.py) on the
reference's own cases (tests/test_kafka_adapter.py), against the in-process
kafka-python emulation (tests/fake_kafka.py, backed by the reference's
Broker), and against the reference's adapter on the same fake cluster:
the same bytes on the wire, the same records, the same offsets."""

from __future__ import annotations

import pytest

import tests.fake_kafka as fk
from ccfd_tpu.bus.kafka_adapter import KafkaAdapter as RefAdapter
from ccfd_tpu_torch.bus.broker import Record, StaleEpochError
from ccfd_tpu_torch.bus.kafka_adapter import KafkaAdapter


@pytest.fixture(autouse=True)
def _fresh_clusters():
    fk.reset()
    yield
    fk.reset()


def adapter(bootstrap="test:9092", **kw):
    return KafkaAdapter(bootstrap, kafka_module=fk.module(), **kw)


def test_produce_and_poll_round_trip():
    a = adapter()
    meta = a.produce("odh-demo", {"Amount": 12.5, "V1": -1.0}, key="card-1")
    assert meta["topic"] == "odh-demo" and meta["offset"] == 0
    with a.consumer("router", ["odh-demo"]) as c:
        recs = c.poll(timeout_s=1.0)
    assert len(recs) == 1
    r = recs[0]
    assert isinstance(r, Record)
    assert r.value == {"Amount": 12.5, "V1": -1.0}
    assert r.key == "card-1"
    assert r.topic == "odh-demo" and r.offset == 0
    assert 1e9 < r.timestamp < 1e10  # epoch seconds, not kafka's epoch millis
    a.close()


def test_bytes_values_ride_byte_exact():
    a = adapter()
    line = b"0.0,-1.359807,...,149.62\n"
    a.produce("odh-demo", line)
    with a.consumer("g", ["odh-demo"]) as c:
        [r] = c.poll(timeout_s=1.0)
    assert r.value == line and isinstance(r.value, bytes)


def test_produce_batch_counts_and_orders_within_partition():
    a = adapter(default_partitions=1)
    a.create_topic("t1", 1)
    assert a.produce_batch("t1", [{"i": i} for i in range(20)]) == 20
    with a.consumer("g", ["t1"]) as c:
        recs = c.poll(max_records=100, timeout_s=1.0)
    assert [r.value["i"] for r in recs] == list(range(20))


def test_keyed_records_land_in_one_partition():
    a = adapter()
    a.create_topic("keyed", 3)
    a.produce_batch("keyed", [{"i": i} for i in range(10)], keys=["k"] * 10)
    with a.consumer("g", ["keyed"]) as c:
        recs = c.poll(max_records=100, timeout_s=1.0)
    assert len({r.partition for r in recs}) == 1
    assert [r.value["i"] for r in recs] == list(range(10))


def test_commit_after_poll_discipline():
    a = adapter()
    a.produce("t", {"x": 1})
    c = a.consumer("g", ["t"])
    assert c._kc.enable_auto_commit is False
    assert c._kc.commit_calls == 0
    assert c.poll(timeout_s=1.0) and c._kc.commit_calls == 1
    c.poll(timeout_s=0.0)  # an empty poll commits nothing
    assert c._kc.commit_calls == 1
    c.close()


def test_group_offsets_survive_consumer_reopen():
    a = adapter()
    a.produce_batch("t", [{"i": i} for i in range(4)])
    with a.consumer("g", ["t"]) as c:
        got = {r.value["i"] for r in c.poll(max_records=100, timeout_s=1.0)}
    assert got == {0, 1, 2, 3}
    a.produce("t", {"i": 99})
    with a.consumer("g", ["t"]) as c2:
        recs = c2.poll(max_records=100, timeout_s=1.0)
    assert [r.value["i"] for r in recs] == [99]


def test_end_offsets_and_create_topic_idempotent():
    a = adapter()
    a.create_topic("t", 3)
    a.create_topic("t", 3)  # TopicAlreadyExists swallowed
    a.produce_batch("t", [{"i": i} for i in range(7)], keys=[str(i) for i in range(7)])
    ends = a.end_offsets("t")
    assert len(ends) == 3 and sum(ends) == 7
    assert sum(a.end_offsets("missing")) == 0


def test_closed_consumer_polls_empty():
    a = adapter()
    a.produce("t", {"x": 1})
    c = a.consumer("g", ["t"])
    c.close()
    assert c.poll(timeout_s=0.5) == []


def test_broker_from_url_kafka_scheme_needs_library():
    """Without kafka-python both packages raise the same error text."""
    from ccfd_tpu.bus.client import broker_from_url as ref_from_url
    from ccfd_tpu_torch.bus.client import broker_from_url

    with pytest.raises(RuntimeError) as want:
        ref_from_url("kafka://host:9092")
    with pytest.raises(RuntimeError, match="kafka-python is not installed") as got:
        broker_from_url("kafka://host:9092")
    assert str(got.value) == str(want.value)


def test_broker_reexport():
    from ccfd_tpu_torch.bus import broker

    assert broker.KafkaAdapter is KafkaAdapter


def test_committed_and_reset_offsets_round_trip():
    a = adapter()
    a.create_topic("tx", 1)
    for i in range(10):
        a.produce("tx", {"i": i})
    with a.consumer("router", ["tx"]) as c:
        got = []
        while True:
            recs = c.poll(100, timeout_s=0.1)
            if not recs:
                break
            got.extend(recs)
    assert len(got) == 10
    assert a.committed_offsets("router", "tx") == [10]
    a.reset_offsets("router", "tx", [4])
    assert a.committed_offsets("router", "tx") == [4]
    with a.consumer("router", ["tx"]) as c2:
        redelivered = c2.poll(100, timeout_s=0.2)
    assert [r.value["i"] for r in redelivered] == [4, 5, 6, 7, 8, 9]


def test_reset_offsets_clamps_and_validates():
    a = adapter()
    a.create_topic("tx2", 2)
    a.produce("tx2", {"x": 1}, key="k")
    a.reset_offsets("g", "tx2", [99, 99])
    assert a.committed_offsets("g", "tx2") == a.end_offsets("tx2")
    with pytest.raises(ValueError):
        a.reset_offsets("g", "tx2", [0])


def test_beginning_offsets_parity():
    a = adapter()
    for i in range(10):
        a.produce("t", {"i": i}, key=str(i).encode())
    ends = a.end_offsets("t")
    assert a.beginning_offsets("t") == [0] * len(ends)
    a.close()


def test_manual_commit_with_offsets_uses_the_given_module():
    """The repair against the reference: an explicit-offset commit builds
    its structs from the adapter's kafka module (the reference imports
    ``kafka.structs``, which is absent here)."""
    a = adapter()
    a.create_topic("m", 1)
    a.produce_batch("m", [{"i": i} for i in range(5)])
    c = a.consumer("g", ["m"], auto_commit=False)
    assert len(c.poll(100, timeout_s=0.5)) == 5
    assert c._kc.commit_calls == 0  # manual mode: the poll committed nothing
    assert c.commit({("m", 0): 3}) == {("m", 0): 3}
    assert a.committed_offsets("g", "m") == [3]
    import importlib.util

    if importlib.util.find_spec("kafka") is None:  # kafka-python absent
        ref = RefAdapter("test:9092", kafka_module=fk.module())
        rc = ref.consumer("g2", ["m"], auto_commit=False)
        rc.poll(100, timeout_s=0.5)
        with pytest.raises(ModuleNotFoundError):
            rc.commit({("m", 0): 3})


def test_commit_failed_maps_to_stale_epoch():
    class CommitFailedError(Exception):
        pass

    a = adapter()
    a.produce("t", {"x": 1})
    c = a.consumer("g", ["t"], auto_commit=False)

    def fail(**_kw):
        raise CommitFailedError("generation changed")

    c._kc.commit = fail
    with pytest.raises(StaleEpochError, match="generation changed"):
        c.commit()


@pytest.mark.parametrize("value,key", [
    ({"Amount": 1.5, "id": "t-1"}, "card-9"),
    (b"0.0,1.0,2.0\n", None),
    ("a,b,c", b"\x00\x01"),
    ([1, None, 2.5], 17),
], ids=["dict", "csv-bytes", "str-bytes-key", "list-int-key"])
def test_wire_bytes_and_records_equal_the_references(value, key):
    """Both adapters on one fake cluster: the same serialized bytes land in
    the log, and each reads the other's records back alike."""
    port, ref = adapter(), RefAdapter("test:9092", kafka_module=fk.module())
    port.produce("w", value, key=key, headers={"traceparent": "00-abc"})
    ref.produce("w", value, key=key, headers={"traceparent": "00-abc"})
    raw = fk._cluster("test:9092")
    rc = raw.consumer("raw", ["w"])
    stored = [(r.key, r.value) for r in rc.poll(10)]
    assert len(stored) == 2 and stored[0] == stored[1]
    with port.consumer("pg", ["w"]) as pc, ref.consumer("rg", ["w"]) as qc:
        got = [(r.partition, r.offset, r.key, r.value, r.headers) for r in pc.poll(10)]
        want = [(r.partition, r.offset, r.key, r.value, r.headers) for r in qc.poll(10)]
    assert got == want and got[0][2:] == (key, value, {"traceparent": "00-abc"})
