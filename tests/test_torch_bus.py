"""The port's in-memory broker (ccfd_tpu_torch/bus/broker.py) against the
JAX package's (ccfd_tpu/bus/broker.py): the same produce / poll / commit
sequence on both gives the same records (topic, partition, offset, key,
value) and the same offsets."""

import pytest

from ccfd_tpu.bus import broker as ref
from ccfd_tpu_torch.bus import broker as port


def _view(records):
    return [(r.topic, r.partition, r.offset, r.key, r.value) for r in records]


def _script(mod):
    """One sequence of bus operations; returns everything it observed."""
    b = mod.Broker(default_partitions=3)
    seen = {}
    b.create_topic("wide", n_partitions=5)
    recs = [b.produce("tx", {"id": i, "Amount": float(i)}, key=i) for i in range(12)]
    recs += [b.produce("tx", b"1.0,2.0", key=None) for _ in range(4)]  # round-robin
    recs.append(b.produce("wide", "x", key="k", partition=4))
    seen["produced"] = _view(recs)
    seen["batch"] = b.produce_batch("tx", [{"id": 100 + i} for i in range(9)],
                                    keys=[100 + i for i in range(9)])
    seen["ends"] = b.end_offsets("tx"), b.end_offsets("wide")
    # one auto-commit member, then a second joins: the group rebalances
    c1 = b.consumer("g", ("tx",))
    seen["poll1"] = _view(c1.poll(7))
    c2 = b.consumer("g", ("tx",))
    seen["assign"] = sorted(c1.assignment()), sorted(c2.assignment())
    seen["poll2"] = _view(c1.poll(100)), _view(c2.poll(100))
    seen["committed"] = b.committed_offsets("g", "tx")
    c2.close()
    seen["after_close"] = sorted(c1.assignment()), _view(c1.poll(100))
    # manual commit: positions ride ahead of the committed offset
    m = b.consumer("m", ("tx", "wide"), auto_commit=False)
    seen["manual_poll"] = _view(m.poll(10))
    seen["manual_committed_before"] = b.committed_offsets("m", "tx")
    seen["commit"] = sorted(m.commit().items())
    seen["manual_committed_after"] = b.committed_offsets("m", "tx")
    epoch = b.group_epoch("m")
    m2 = b.consumer("m", ("tx",), auto_commit=False)  # rebalance: the old epoch is fenced
    with pytest.raises(mod.StaleEpochError):
        m.commit(epoch=epoch)
    seen["fenced"] = b.fenced_commits, b.group_epoch("m") - epoch
    seen["m2_poll"] = _view(m2.poll(100))
    # a rewind re-delivers
    b.reset_offsets("g", "tx", [0, 1, 2])
    seen["rewound"] = b.committed_offsets("g", "tx"), _view(c1.poll(100))
    with pytest.raises(ValueError):
        b.reset_offsets("g", "tx", [0])
    with pytest.raises(ValueError):
        b.produce("wide", "x", partition=9)
    seen["empty_poll"] = c1.poll(10, timeout_s=0.01)
    return seen


def test_the_same_sequence_gives_the_same_records_and_offsets():
    want, got = _script(ref), _script(port)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_records_carry_headers_and_timestamps():
    b = port.Broker()
    r = b.produce("t", {"a": 1}, key=1, headers={"h": "v"})
    assert r.headers == {"h": "v"} and r.timestamp > 0
    got = b.consumer("g", ("t",)).poll(10)
    assert got == [r] and isinstance(got[0], port.Record)


def test_keys_route_to_the_reference_partitions():
    rb, pb = ref.Broker(default_partitions=7), port.Broker(default_partitions=7)
    for key in (0, 1, 12345, "cust-9", b"raw", None, None):
        assert pb.produce("t", 1, key=key).partition == rb.produce("t", 1, key=key).partition


def test_concurrent_producers_and_a_consumer_group_lose_and_repeat_nothing():
    """4 producer threads and 3 members of one group on a short switch
    interval: every record is delivered once, in partition order."""
    import sys
    import threading
    import time

    b = port.Broker(default_partitions=4)
    members = [b.consumer("g", ("t",)) for _ in range(3)]
    got: list[list] = [[] for _ in members]
    done = threading.Event()

    def produce(w: int) -> None:
        for i in range(0, 2000, 50):
            b.produce_batch("t", [(w, j) for j in range(i, i + 50)],
                            keys=[f"{w}-{j}" for j in range(i, i + 50)])

    def consume(k: int) -> None:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                not done.is_set() or sum(map(len, got)) < 8000):
            got[k].extend(members[k].poll(64, timeout_s=0.01))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        consumers = [threading.Thread(target=consume, args=(k,)) for k in range(3)]
        producers = [threading.Thread(target=produce, args=(w,)) for w in range(4)]
        for t in consumers + producers:
            t.start()
        for t in producers:
            t.join(timeout=60)
        done.set()
        for t in consumers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in consumers + producers)
    recs = [r for g in got for r in g]
    assert sorted(r.value for r in recs) == sorted((w, j) for w in range(4) for j in range(2000))
    for p in range(4):
        offs = [r.offset for r in recs if r.partition == p]
        assert sorted(offs) == list(range(len(offs)))
    assert b.committed_offsets("g", "t") == b.end_offsets("t")
