"""Wire compatibility of the port's engine REST with the JAX package's.

One scripted session (single and batched process starts, an unknown
process, a customer-response signal, a timed-out customer whose case goes
to investigation, the task list, a task completion and a repeated one, an
instance view and a missing one) runs for each pairing of client and
server: the reference's ``EngineRestClient`` against the port's
``EngineServer``, the port's client against the reference's server, and the
port against itself. Each must give exactly what the reference's client
gives against the reference's server: the same process ids, signal
answers, instance and task views, errors and KIE histogram counts.
"""

import http.client

import pytest

from ccfd_tpu.bus.broker import Broker as RefBroker
from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.process import client as ref_client
from ccfd_tpu.process import server as ref_server
from ccfd_tpu.process.clock import ManualClock as RefClock
from ccfd_tpu.process.fraud import build_engine as ref_build_engine
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.process import client as port_client
from ccfd_tpu_torch.process import server as port_server
from ccfd_tpu_torch.process.clock import ManualClock
from ccfd_tpu_torch.process.fraud import build_engine


def _tx(i, amount):
    return {"id": i, "Amount": amount}


def _session(client_mod, engine, clock, base_url):
    out = {}
    c = client_mod.EngineRestClient(base_url, timeout_s=10.0)
    out["single"] = c.start_process("standard", {"transaction": _tx(1, 5.0), "proba": 0.1,
                                                 "customer_id": 1})
    out["batch_std"] = c.start_process_batch(
        "standard", [{"transaction": _tx(i, 10.0 + i), "proba": 0.2, "customer_id": i}
                     for i in range(2, 6)])
    out["batch_fraud"] = c.start_process_batch(
        "fraud", [{"transaction": _tx(i, a), "proba": p, "customer_id": i}
                  for i, a, p in ((10, 500.0, 0.9), (11, 50.0, 0.6), (12, 900.0, 0.95),
                                  (13, 20.0, 0.99))])
    try:
        c.start_process("nope", {})
        out["unknown"] = None
    except RuntimeError as e:
        out["unknown"] = "404" in str(e)
    pids = out["batch_fraud"]
    out["signal"] = c.signal(pids[0], "customer-response", {"approved": True})
    out["signal_again"] = c.signal(pids[0], "customer-response", {"approved": True})
    out["signal_missing"] = c.signal(99999, "customer-response", {})
    clock.advance(31.0)  # the others stay silent: the DMN decides
    view = dict(c.instance(pids[2]))
    out["instance"] = view
    try:
        c.instance(123456)
        out["missing"] = None
    except KeyError:
        out["missing"] = True
    tasks = c.tasks("open")
    out["tasks"] = tasks
    if tasks:
        tid = tasks[0]["task_id"]
        c.complete_task(tid, True)
        try:
            c.complete_task(tid, True)
            out["again"] = None
        except RuntimeError as e:
            out["again"] = "409" in str(e)
    out["done_tasks"] = c.tasks("completed")
    out["kie"] = {h: engine.registry.histogram(h).count() for h in (
        "fraud_approved_amount", "fraud_rejected_amount", "fraud_approved_low_amount",
        "fraud_investigation_amount")}
    host, port = base_url.rsplit(":", 1)
    conn = http.client.HTTPConnection("127.0.0.1", int(port))
    conn.request("GET", "/health/status")
    out["health"] = conn.getresponse().read()
    conn.request("GET", "/rest/instances?status=active")
    out["active"] = conn.getresponse().read()
    conn.request("GET", "/rest/metrics")
    resp = conn.getresponse()
    out["metrics"] = [ln for ln in resp.read().decode().splitlines()
                      if ln.startswith("process_instances")]
    conn.close()
    return out


def _run(client, server):
    if server == "ref":
        clock = RefClock()
        engine = ref_build_engine(RefConfig(), RefBroker(), clock=clock)
        srv = ref_server.EngineServer(engine)
    else:
        clock = ManualClock()
        engine = build_engine(Config(), Broker(), clock=clock)
        srv = port_server.EngineServer(engine)
    port = srv.start("127.0.0.1", 0)
    try:
        return _session(port_client if client == "port" else ref_client, engine, clock,
                        f"http://127.0.0.1:{port}")
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def baseline():
    return _run("ref", "ref")


@pytest.mark.parametrize("client,server", [
    ("ref", "port"), ("port", "ref"), ("port", "port")])
def test_engine_rest_is_compatible_both_ways(baseline, client, server):
    got = _run(client, server)
    assert got == baseline
    assert got["signal"] is True and got["signal_again"] is False
    assert got["unknown"] and got["missing"] and got["again"]
    assert got["tasks"] and got["done_tasks"]
    assert sum(got["kie"].values()) >= 3


def test_rest_client_batches_take_the_routers_copy_flag():
    """The router hands every engine ``copy_vars=False``; over REST it is
    moot and accepted."""
    engine = build_engine(Config(), Broker(), clock=ManualClock())
    srv = port_server.EngineServer(engine)
    port = srv.start("127.0.0.1", 0)
    try:
        c = port_client.EngineRestClient(f"http://127.0.0.1:{port}")
        pids = c.start_process_batch("standard", [{"transaction": _tx(1, 1.0), "proba": 0.0}],
                                     copy_vars=False)
        assert pids == [1] and [i.pid for i in engine.instances()] == [1]
        c.close()
    finally:
        srv.stop()
