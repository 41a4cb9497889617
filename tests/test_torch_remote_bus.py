"""Wire compatibility of the port's networked bus with the JAX package's.

One scripted session (produce single and batched records with bytes, keys,
explicit partitions and trace headers; offsets; a consumer group's polls
and rebalance; manual commits under the epoch fence; offset reset; group
fencing; a bad request) runs against a bus server on loopback for each
pairing of client and server: the reference's ``RemoteBroker`` against
the port's ``BrokerServer``, the port's client against the reference's
server, and the port against itself. Each must give exactly what the
reference's client gives against the reference's server: the same
records (timestamps aside), offsets, commits, epochs and errors.
"""

import pytest

from ccfd_tpu.bus import client as ref_client
from ccfd_tpu.bus import server as ref_server
from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.bus.broker import StaleEpochError as RefStale
from ccfd_tpu_torch.bus import client as port_client
from ccfd_tpu_torch.bus import server as port_server
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.bus.broker import StaleEpochError

TP = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


def _view(recs):
    return [(r.topic, r.partition, r.offset, r.key, r.value, r.headers) for r in recs]


def _session(client_mod):
    out = {}
    rb = client_mod.RemoteBroker(URL[0], timeout_s=10.0)
    try:
        out["single"] = rb.produce("tx", {"id": 1, "Amount": 2.5}, key=1)
        out["bytes"] = rb.produce("tx", b"1.0,2.0\n", key=b"k")
        out["part"] = rb.produce("tx", "ctl", partition=2, headers={"traceparent": TP})
        out["batch"] = rb.produce_batch("tx", [{"i": i} for i in range(25)],
                                        keys=list(range(25)), headers={"traceparent": TP})
        out["batch_nokeys"] = rb.produce_batch("tx", ["a", "b", "c"])
        out["end"] = rb.end_offsets("tx")
        out["begin"] = rb.beginning_offsets("tx")
        c1 = rb.consumer("g", ["tx"], auto_commit=False)
        out["epoch1"] = c1.epoch
        got = []
        for _ in range(6):
            got += _view(c1.poll(max_records=7, timeout_s=0.2))
        out["polled"] = sorted(got, key=lambda r: (r[1], r[2]))
        out["commit"] = sorted(c1.commit().items())
        out["committed"] = rb.committed_offsets("g", "tx")
        # a second member joins: the group rebalances and c1's next commit
        # with its stale epoch is fenced
        c2 = rb.consumer("g", ["tx"], auto_commit=False)
        out["epoch2"] = (c2.epoch, rb.group_epoch("g"))
        try:
            c1.commit({("tx", 0): 1}, epoch=out["epoch1"])
            out["fenced"] = None
        except (StaleEpochError, RefStale) as e:
            out["fenced"] = (type(e).__name__, e.epoch, e.current_epoch)
        rb.reset_offsets("g", "tx", [0, 1, 2])
        out["reset"] = rb.committed_offsets("g", "tx")
        try:
            rb.reset_offsets("g", "tx", [0])
        except ConnectionError as e:
            out["bad_reset"] = "400" in str(e)
        out["fence"] = rb.fence_group("g", idle_s=0.0)
        out["epoch3"] = rb.group_epoch("g")
        auto = rb.consumer("auto", ["tx"])
        recs = []
        for _ in range(8):
            recs += _view(auto.poll(max_records=10, timeout_s=0.2))
        out["auto"] = sorted(recs, key=lambda r: (r[1], r[2]))
        out["auto_committed"] = rb.committed_offsets("auto", "tx")
        auto.close()
        out["closed_poll"] = auto.poll()
        try:
            rb.produce("tx", "x", partition=9)
            out["bad_partition"] = None
        except ConnectionError as e:
            out["bad_partition"] = "400" in str(e)
    finally:
        rb.close()
    return out


URL = [""]


def _serve(server_mod, broker):
    srv = server_mod.BrokerServer(broker)
    port = srv.start("127.0.0.1", 0)
    URL[0] = f"http://127.0.0.1:{port}"
    return srv


@pytest.fixture(scope="module")
def baseline():
    srv = _serve(ref_server, RefBroker())
    try:
        return _session(ref_client)
    finally:
        srv.stop()


@pytest.mark.parametrize("client,server", [
    ("ref", "port"), ("port", "ref"), ("port", "port")])
def test_bus_wire_is_compatible_both_ways(baseline, client, server):
    server_mod, broker = ((port_server, Broker()) if server == "port"
                          else (ref_server, RefBroker()))
    srv = _serve(server_mod, broker)
    try:
        got = _session(port_client if client == "port" else ref_client)
    finally:
        srv.stop()
    assert got == baseline
    assert len(got["polled"]) == sum(got["end"]) == 31
    assert got["fenced"] is not None and got["bad_partition"] and got["bad_reset"]
    assert any(r[5] == {"traceparent": TP} for r in got["polled"])
    assert any(r[4] == b"1.0,2.0\n" for r in got["polled"])


def test_bus_server_scrape_and_health_match_the_reference():
    """The same traffic through each package's server: the same health
    answers and bus_* families in the scrape."""
    import http.client

    scrapes = []
    for server_mod, broker, client_mod in ((ref_server, RefBroker(), ref_client),
                                           (port_server, Broker(), port_client)):
        srv = _serve(server_mod, broker)
        try:
            rb = client_mod.RemoteBroker(URL[0])
            rb.produce_batch("tx", list(range(40)), keys=list(range(40)))
            c = rb.consumer("g", ["tx"])
            c.poll(max_records=15, timeout_s=0.1)
            conn = http.client.HTTPConnection("127.0.0.1", int(URL[0].rsplit(":", 1)[1]))
            conn.request("GET", "/health/status")
            health = conn.getresponse().read()
            conn.request("GET", "/prometheus")
            body = conn.getresponse().read().decode()
            conn.close()
            rb.close()
        finally:
            srv.stop()
        keep = ("bus_records_produced_total", "bus_records_delivered_total", "bus_consumers",
                "bus_topic_records_in_total", "bus_topic_end_offset", "bus_topic_backlog",
                "bus_topic_log_start_offset", "bus_topic_retained_records")
        scrapes.append((health, [ln for ln in body.splitlines()
                                 if ln.split("{")[0].split(" ")[0] in keep]))
    assert scrapes[0] == scrapes[1]
    assert any(ln.startswith("bus_topic_backlog") for ln in scrapes[1][1])


def test_broker_from_url_refuses_kafka():
    assert port_client.broker_from_url("inproc://local") is None
    assert isinstance(port_client.broker_from_url("http://127.0.0.1:1"),
                      port_client.RemoteBroker)
    # kafka:// is the Kafka adapter, which needs kafka-python (absent here)
    with pytest.raises(RuntimeError, match="kafka-python is not installed"):
        port_client.broker_from_url("kafka://bootstrap:9092")
