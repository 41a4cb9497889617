"""Fenced commits across a consumer-group rebalance, and the router's
commit-after-route, on the port against the reference.

- **The bus** (tests/test_fleet_bus.py's three scenarios, over the real
  HTTP bus of each package fed the same records): a killed member's
  in-flight commit is fenced and not applied, and the batch redelivers in
  full to the group's next member; a commit carrying the pre-join epoch is
  refused after a join; with no rebalance between, the manual commit lands
  exactly the polled positions. The fences, the committed offsets and the
  redelivered rows are equal on both sides.
- **The router** (``commit_after_route=True``, each package's in-process
  bus, engine and router on the same records and the same scores): the
  shed rows of a batch commit with it; a commit fenced by a rebalance
  between poll and route is counted in ``router_fenced_commits_total``,
  applies nothing, and the batch redelivers; no batch is committed before
  its route reaches the engine, on the staged path, under the decision
  plane and in the pipelined run loop (without the discipline the
  commit-on-poll hand-off is visible to the same check).
- **The ledger's stamp**: a batch's entries carry the epoch it was polled
  under, so a redelivery after a rebalance reads as cross-epoch; the
  reference's operator stamps the consumer's current epoch, which reads
  the same redelivery as a same-epoch double route (pinned on both sides).
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from ccfd_tpu.bus import broker as ref_broker
from ccfd_tpu.bus import client as ref_client
from ccfd_tpu.bus import server as ref_server
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.process import fraud as ref_fraud
from ccfd_tpu.router import router as ref_router
from ccfd_tpu_torch.bus import broker as port_broker
from ccfd_tpu_torch.bus import client as port_client
from ccfd_tpu_torch.bus import server as port_server
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.process import fraud as port_fraud
from ccfd_tpu_torch.router import router as port_router

SIDES = {
    "ref": dict(broker=ref_broker, client=ref_client, server=ref_server,
                fraud=ref_fraud, router=ref_router, cfg=RefConfig),
    "port": dict(broker=port_broker, client=port_client, server=port_server,
                 fraud=port_fraud, router=port_router, cfg=Config),
}


def _drain(consumer, want, timeout_s=5.0):
    got = []
    deadline = time.monotonic() + timeout_s
    while len(got) < want and time.monotonic() < deadline:
        got.extend(consumer.poll(max_records=100, timeout_s=0.2))
    return got


def _http_bus(side):
    srv = side["server"].BrokerServer(side["broker"].Broker(default_partitions=2))
    port = srv.start(host="127.0.0.1", port=0)
    return srv, side["client"].RemoteBroker(f"http://127.0.0.1:{port}")


# -- the bus's three scenarios ------------------------------------------------


def killed_member_commit_fenced_not_applied(side, client):
    for i in range(10):
        client.produce("t", i, key=str(i).encode())
    corpse = client.consumer("g", ("t",), auto_commit=False)
    recs = _drain(corpse, 10)
    fenced = client.fence_group("g", idle_s=0.0)
    with pytest.raises(side["broker"].StaleEpochError):
        corpse.commit()
    after_fence = client.committed_offsets("g", "t")
    survivor = client.consumer("g", ("t",), auto_commit=False)
    replay = _drain(survivor, 10)
    committed = survivor.commit()
    out = {"polled": sorted(r.value for r in recs), "closed": fenced["closed"],
           "after_fence": after_fence, "replay": sorted(r.value for r in replay),
           "committed": sorted(committed.items()),
           "end": client.committed_offsets("g", "t")}
    survivor.close()
    assert len(recs) == 10 and out["closed"] >= 1 and sum(after_fence) == 0
    assert out["replay"] == out["polled"] and sum(out["end"]) == 10
    return out


def stale_epoch_commit_refused_after_member_join(side, client):
    for i in range(8):
        client.produce("t", i, key=str(i).encode())
    c1 = client.consumer("g", ("t",), auto_commit=False)
    recs = _drain(c1, 8)
    old_epoch = c1.epoch
    c2 = client.consumer("g", ("t",), auto_commit=False)  # a join: the epoch bumps
    new_epoch = client.group_epoch("g")
    with pytest.raises(side["broker"].StaleEpochError):
        c1.commit({("t", 0): 4, ("t", 1): 4}, epoch=old_epoch)
    after_refusal = client.committed_offsets("g", "t")
    recovered = _drain(c1, 1) + _drain(c2, 1)
    for c in (c1, c2):
        if c.assignment:
            c.commit()
    out = {"polled": sorted(r.value for r in recs), "epochs": (old_epoch, new_epoch),
           "after_refusal": after_refusal,
           "recovered": sorted(r.value for r in recovered),
           "assignments": (sorted(c1.assignment), sorted(c2.assignment)),
           "end": client.committed_offsets("g", "t")}
    c1.close()
    c2.close()
    assert len(recs) == 8 and new_epoch > old_epoch and sum(after_refusal) == 0
    assert out["recovered"] and sum(out["end"]) > 0
    return out


def fresh_epoch_commit_applies_exactly(side, client):
    for i in range(6):
        client.produce("t", i)
    c = client.consumer("g", ("t",), auto_commit=False)
    recs = _drain(c, 6)
    committed = c.commit()
    first = client.committed_offsets("g", "t")
    c.commit()  # idempotent under the same epoch
    out = {"polled": sorted(r.value for r in recs), "committed": sorted(committed.items()),
           "first": first, "again": client.committed_offsets("g", "t")}
    c.close()
    assert len(recs) == 6 and sum(committed.values()) == 6 == sum(first) == sum(out["again"])
    return out


@pytest.mark.parametrize("scenario", [killed_member_commit_fenced_not_applied,
                                      stale_epoch_commit_refused_after_member_join,
                                      fresh_epoch_commit_applies_exactly],
                         ids=lambda f: f.__name__)
def test_each_bus_scenario_equals_the_reference(scenario):
    results = {}
    for name, side in SIDES.items():
        srv, client = _http_bus(side)
        try:
            results[name] = scenario(side, client)
        finally:
            client.close()
            srv.stop()
    assert results["port"] == results["ref"]


# -- the router ----------------------------------------------------------------


def _records(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, len(FEATURE_NAMES))).astype(np.float32)
    return [{"id": f"tx-{i:04d}", **{k: float(v) for k, v in zip(FEATURE_NAMES, row)}}
            for i, row in enumerate(x)]


def _score(x: np.ndarray) -> np.ndarray:
    """The same scores on both sides: a squashed first feature."""
    return (1.0 / (1.0 + np.exp(-x[:, 0].astype(np.float64)))).astype(np.float32)


class _Watched:
    """An engine proxy that records, at every batched start, the group's
    committed offsets and how many rows earlier starts carried."""

    def __init__(self, inner, broker, topic):
        self.inner, self.broker, self.topic = inner, broker, topic
        self.calls: list[tuple[int, int]] = []
        self.seen = 0

    def definitions(self):
        return self.inner.definitions()

    def start_process(self, def_id, variables):
        return self.start_process_batch(def_id, [variables])[0]

    def start_process_batch(self, def_id, vars_list, copy_vars=True):
        self.calls.append((sum(self.broker.committed_offsets("router", self.topic)),
                           self.seen))
        self.seen += len(vars_list)
        return self.inner.start_process_batch(def_id, vars_list, copy_vars=copy_vars)

    def signal(self, pid, name, payload=None):
        return self.inner.signal(pid, name, payload)


def _router(side, partitions=1, score=_score, **kw):
    cfg = side["cfg"]()
    broker = side["broker"].Broker(default_partitions=partitions)
    engine = side["fraud"].build_engine(cfg, broker)
    watched = _Watched(engine, broker, cfg.kafka_topic)
    r = side["router"].Router(cfg, broker, score, watched, **kw)
    return cfg, broker, engine, watched, r


def _total(r, name):
    return r.registry.counter(name).total()


def test_shed_rows_commit_with_their_batch():
    """A static budget of 5 on a poll of 8 sheds the 3 oldest: the batch's
    commit covers all 8, so the shed rows never redeliver."""
    out = {}
    for name, side in SIDES.items():
        cfg, broker, engine, watched, r = _router(side, max_batch=8, max_inflight=5,
                                                   commit_after_route=True)
        try:
            broker.produce_batch(cfg.kafka_topic, _records(8))
            routed = r.step(0.2)
            out[name] = {"routed": routed, "shed": _total(r, "router_shed_total"),
                         "incoming": _total(r, "transaction_incoming_total"),
                         "committed": broker.committed_offsets("router", cfg.kafka_topic),
                         "before_route": watched.calls[0][0],
                         "again": r.step(0.05)}
        finally:
            r.close()
            engine.shutdown()
    assert out["port"] == out["ref"]
    assert out["port"]["routed"] == 5 and out["port"]["shed"] == 3
    assert out["port"]["committed"] == [8] and out["port"]["before_route"] == 0
    assert out["port"]["again"] == 0  # nothing redelivers


def test_a_fenced_commit_is_counted_and_the_batch_redelivers():
    """A member joins the router's group between the poll and the route: the
    post-route commit is refused by the epoch fence, counted (never raised
    into the loop), applies nothing, and the rows redeliver."""
    out = {}
    for name, side in SIDES.items():
        joiner = []

        def score(x, side=side, joiner=joiner):
            if not joiner:
                joiner.append(broker_box[0].consumer("router", (cfg_box[0].kafka_topic,),
                                                     auto_commit=False))
            return _score(x)

        broker_box, cfg_box = [], []
        cfg, broker, engine, watched, r = _router(side, partitions=2, score=score,
                                                   max_batch=64, commit_after_route=True)
        broker_box.append(broker)
        cfg_box.append(cfg)
        try:
            broker.produce_batch(cfg.kafka_topic, _records(12), keys=[str(i) for i in range(12)])
            routed = r.step(0.2)
            fenced = _total(r, "router_fenced_commits_total")
            committed = broker.committed_offsets("router", cfg.kafka_topic)
            again = sorted(rec.value["id"] for rec in joiner[0].poll(64, 0.2))
            routed_again = r.step(0.2)
            out[name] = {"routed": routed, "fenced": fenced, "committed": committed,
                         "joiner_redelivered": again, "router_redelivered": routed_again,
                         "commit_errors": _total(r, "router_commit_errors_total")}
            joiner[0].close()
        finally:
            r.close()
            engine.shutdown()
    assert out["port"] == out["ref"]
    p = out["port"]
    assert p["routed"] == 12 and p["fenced"] == 1 and sum(p["committed"]) == 0
    assert len(p["joiner_redelivered"]) + p["router_redelivered"] == 12
    assert p["commit_errors"] == 0


def _port_plane(rules):
    import torch

    from ccfd_tpu_torch.serving.fused import FusedDecisionScorer
    from ccfd_tpu_torch.serving.scorer import Scorer
    from tests.torch_helpers import mlp_tree

    torch.manual_seed(0)
    x = np.stack([[r[k] for k in FEATURE_NAMES] for r in _records(256, seed=3)]).astype(
        np.float32)
    sc = Scorer(params=mlp_tree(x, hidden=64, seed=1), batch_sizes=(16, 128),
                device="cpu")
    return sc, FusedDecisionScorer(sc, rules)


@pytest.mark.parametrize("path", ["staged", "decision_plane", "run_loop", "commit_on_poll"])
def test_no_batch_commits_before_its_route(path):
    """At every start the router hands the engine, the group's committed
    offset is at most the rows of the starts before it: the batch being
    routed is not committed yet. At the end every row is committed. The
    same check catches the commit-on-poll hand-off of a router without the
    discipline."""
    side = SIDES["port"]
    kw = {"commit_after_route": path != "commit_on_poll", "max_batch": 16}
    score = _score
    if path == "decision_plane":
        from ccfd_tpu_torch.router.rules import default_rules

        rules = default_rules(Config().fraud_threshold)
        sc, plane = _port_plane(rules)
        kw.update(rules=rules, decision_fn=plane)
        score = sc.score
    cfg, broker, engine, watched, r = _router(side, score=score, **kw)
    try:
        broker.produce_batch(cfg.kafka_topic, _records(80, seed=5))
        if path == "run_loop":
            t = r.start(poll_timeout_s=0.02)
            deadline = time.monotonic() + 30
            while watched.seen < 80 and time.monotonic() < deadline:
                time.sleep(0.02)
            r.stop()
            t.join(10)
        else:
            while r.step(0.05):
                pass
        if path == "decision_plane":
            assert r._decision_fn is plane and plane.dispatch_total() > 0
        assert watched.seen == 80 and len(watched.calls) >= 5
        early = [(c, seen) for c, seen in watched.calls if c > seen]
        if path == "commit_on_poll":
            assert early  # the poll committed the batch before its route
        else:
            assert early == []
            deadline = time.monotonic() + 5
            while (broker.committed_offsets("router", cfg.kafka_topic) != [80]
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        assert broker.committed_offsets("router", cfg.kafka_topic) == [80]
    finally:
        r.close()
        engine.shutdown()


def test_recycled_consumers_keep_manual_commit():
    """Crash recovery rebuilds the consumers from the same specs: the tx
    consumer comes back manual-commit, the signal consumers do not."""
    cfg, broker, engine, watched, r = _router(SIDES["port"], commit_after_route=True)
    try:
        r.recycle_consumers()
        assert r._tx_consumer._auto_commit is False
        assert r._resp_consumer._auto_commit is True
        broker.produce_batch(cfg.kafka_topic, _records(10))
        while r.step(0.05):
            pass
        assert broker.committed_offsets("router", cfg.kafka_topic) == [10]
    finally:
        r.close()
        engine.shutdown()
    _, _, engine2, _, plain = _router(SIDES["port"])
    try:
        assert plain._tx_consumer._auto_commit is True
    finally:
        plain.close()
        engine2.shutdown()


def test_the_ledger_stamps_the_epoch_its_batch_was_polled_under():
    """A member joins between a batch's poll and its route: the port's
    ledger entries carry the poll's epoch (the router hands it to the audit
    seam with the batch), so the rows the joiner re-reads under the new
    epoch count as cross-epoch redeliveries. The reference's operator
    stamps the tx consumer's CURRENT epoch, which the join already moved:
    its entries carry the new epoch, the same as the joiner's, and the
    conservation check would read the redelivery as a same-epoch double
    route (ROADMAP C)."""
    from ccfd_tpu.fleet.ledger import FleetLedgerTap as RefTap
    from ccfd_tpu.fleet.ledger import flatten_ledger as ref_flatten
    from ccfd_tpu.fleet.protocol import check_ledger_conservation as ref_check
    from ccfd_tpu_torch.fleet.ledger import LEDGER_TOPIC, FleetLedgerTap, flatten_ledger
    from ccfd_tpu_torch.fleet.protocol import check_ledger_conservation

    out = {}
    for name, side in SIDES.items():
        box: dict = {}

        def score(x, box=box):
            if "joiner" not in box:
                box["before"] = box["router"]._tx_consumer.epoch
                box["joiner"] = box["broker"].consumer(
                    "router", (box["cfg"].kafka_topic,), auto_commit=False)
            return _score(x)

        cfg = side["cfg"]()
        broker = side["broker"].Broker(default_partitions=1)
        tap = (FleetLedgerTap if name == "port" else RefTap)(broker, "m00")
        engine = side["fraud"].build_engine(cfg, broker)
        r = side["router"].Router(cfg, broker, score, engine, max_batch=64,
                                  commit_after_route=True, audit=tap)
        tap.epoch_fn = ((lambda: r.batch_epoch) if name == "port"
                        else (lambda: r._tx_consumer.epoch))
        box.update(router=r, broker=broker, cfg=cfg)
        try:
            ids = [rec["id"] for rec in _records(10)]
            broker.produce_batch(cfg.kafka_topic, _records(10), keys=ids)
            r.step(0.2)
            r.step(0.2)  # the router's redelivery, if it kept the partition
            joiner = box["joiner"]
            again = joiner.poll(64, 0.2)  # the joiner's, if the partition moved
            entries = (flatten_ledger if name == "port" else ref_flatten)(
                broker.consumer("t-led", (LEDGER_TOPIC,)).poll(64, 0.2))
            redelivered = [{"tx": rec.value["id"], "member": "m01", "epoch": joiner.epoch}
                           for rec in again]
            check = check_ledger_conservation if name == "port" else ref_check
            out[name] = {"stamped": sorted({e["epoch"] for e in entries}),
                         "before": box["before"], "after": joiner.epoch,
                         "verdict": check(ids, entries + redelivered)}
            joiner.close()
        finally:
            r.close()
            engine.shutdown()
    port, ref = out["port"], out["ref"]
    assert port["after"] == port["before"] + 1 == ref["after"] == ref["before"] + 1
    assert port["stamped"][0] == port["before"] and ref["stamped"] == [ref["after"]]
    assert port["verdict"]["conserved"] and port["verdict"]["cross_epoch_redeliveries"] == 10
    assert not ref["verdict"]["conserved"] and len(ref["verdict"]["same_epoch_dupes"]) == 10
