"""The five service roles as separate processes on the CPU.

``python -m ccfd_tpu_torch bus | engine | router --device cpu | notify |
producer``, each its own subprocess on free loopback ports, wired by the
reference's environment (BROKER_URL, KIE_SERVER_URL), route 2,000
transactions of a seeded dataset (CCFD_CSV) scored by seeded params
(``router --params``). Silent customers (``notify --reply-prob 0``) make the
fraud process's outcome depend on the DMN alone, so the run is
deterministic: every transaction is routed, with no score error, degraded
row or shed, and the routed counts and the engine's KIE histogram counts
equal ``cli.build_pipeline``'s on the same data, params and seed.
"""

import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from ccfd_tpu_torch.cli import build_pipeline
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import load_csv, to_csv_bytes
from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
from ccfd_tpu_torch.params import load_params, save_params
from tests.torch_helpers import mlp_tree

REPO = Path(__file__).resolve().parents[1]
N = 2000
REPLY_TIMEOUT_S = 0.5
KIE = ("fraud_approved_amount", "fraud_rejected_amount", "fraud_approved_low_amount",
       "fraud_investigation_amount")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape(url: str) -> dict[str, float]:
    with urllib.request.urlopen(url, timeout=5) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def _decided(count) -> float:
    """Fraud instances the DMN has decided: with every customer silent each
    one ends on its reply timer in exactly one of the KIE histograms, and a
    loaded host may fire the timers late, so both runs wait for all of them."""
    return sum(count(h) for h in KIE)


def _wait_http(url: str, proc, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{proc.args} exited {proc.returncode}")
        try:
            urllib.request.urlopen(url, timeout=1).read()
            return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"{url} did not come up")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("roles")
    ds = kaggle_surrogate(n=N, seed=13)
    csv = d / "tx.csv"
    csv.write_bytes(to_csv_bytes(ds))
    npz = d / "params.npz"
    save_params(mlp_tree(ds.X, hidden=64, seed=4), npz)
    return csv, npz


def test_five_roles_route_as_the_in_process_pipeline(inputs):
    csv, npz = inputs
    bus, kie, rport, nport = (_free_port() for _ in range(4))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), CCFD_CSV=str(csv), BROKER_URL=f"http://127.0.0.1:{bus}",
               KIE_SERVER_URL=f"http://127.0.0.1:{kie}",
               CCFD_REPLY_TIMEOUT_S=str(REPLY_TIMEOUT_S), JAX_PLATFORMS="cpu")
    role = [sys.executable, "-m", "ccfd_tpu_torch"]
    procs = []

    def spawn(*args):
        p = subprocess.Popen(role + list(args), cwd=str(REPO), env=env,
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        procs.append(p)
        return p

    try:
        b = spawn("bus", "--host", "127.0.0.1", "--port", str(bus))
        _wait_http(f"http://127.0.0.1:{bus}/health/status", b)
        e = spawn("engine", "--host", "127.0.0.1", "--port", str(kie))
        n = spawn("notify", "--metrics-port", str(nport), "--reply-prob", "0", "--seed", "1")
        r = spawn("router", "--metrics-port", str(rport), "--device", "cpu",
                  "--params", str(npz))
        _wait_http(f"http://127.0.0.1:{kie}/health/status", e)
        _wait_http(f"http://127.0.0.1:{nport}/prometheus", n)
        _wait_http(f"http://127.0.0.1:{rport}/prometheus", r, timeout=120.0)
        out = subprocess.run(role + ["producer", "--limit", str(N)], cwd=str(REPO), env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert f"streamed {N} rows" in out.stderr
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            m = _scrape(f"http://127.0.0.1:{rport}/prometheus")
            k = _scrape(f"http://127.0.0.1:{kie}/rest/metrics")
            fraud = m.get('transaction_outgoing_total{type="fraud"}', 0.0)
            routed = sum(v for key, v in m.items() if key.startswith("transaction_outgoing_total"))
            if routed >= N and _decided(lambda h: k.get(f"{h}_count", 0.0)) >= fraud:
                break
            time.sleep(0.1)
        notes = _scrape(f"http://127.0.0.1:{nport}/prometheus")
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    got = {
        "in": m["transaction_incoming_total"],
        "fraud": m.get('transaction_outgoing_total{type="fraud"}', 0.0),
        "standard": m.get('transaction_outgoing_total{type="standard"}', 0.0),
        "kie": {h: k.get(f"{h}_count", 0.0) for h in KIE},
    }
    for c in ("router_score_errors_total", "router_shed_total",
              "router_process_start_errors_total"):
        assert m.get(c, 0.0) == 0.0, c
    assert not any(key.startswith("router_degraded_total") and v for key, v in m.items())
    assert m['router_worker_batches_total{worker="0"}'] > 0
    assert m['ccfd_scorer_dispatches'] > 0 and m["ccfd_breaker_state{edge=\"scorer\"}"] == 0
    assert notes["notifications_sent_total"] == got["fraud"]

    # the in-process pipeline on the same data, params and seed
    cfg = Config.from_env({"CCFD_REPLY_TIMEOUT_S": str(REPLY_TIMEOUT_S)})
    pipe = build_pipeline(cfg, load_csv(str(csv)), device="cpu", params=load_params(npz),
                          seed=1)
    pipe.notify.reply_prob = 0.0
    pipe.start(poll_timeout_s=0.02)
    try:
        pipe.producer.run(limit=N, wire_format="csv")
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            s = pipe.summary()
            if (s["fraud_routed"] + s["standard_routed"] >= N
                    and _decided(lambda h: pipe.reg_kie.histogram(h).count()) >= s["fraud_routed"]):
                break
            time.sleep(0.1)
    finally:
        pipe.stop()
    s = pipe.summary()
    want = {"in": s["transactions"], "fraud": s["fraud_routed"],
            "standard": s["standard_routed"],
            "kie": {h: pipe.reg_kie.histogram(h).count() for h in KIE}}
    assert got == want
    assert got["in"] == N and got["fraud"] and got["standard"]
    assert got["kie"]["fraud_investigation_amount"] and got["kie"]["fraud_approved_low_amount"]


@pytest.mark.parametrize("argv,env,match", [
    (["router"], {"CCFD_LIFECYCLE_DIR": "/tmp/lc"}, "CCFD_LIFECYCLE_DIR"),
    (["serve", "--device", "cpu"], {"CCFD_OVERLOAD_REST_QUEUE_ROWS": "64"},
     "CCFD_OVERLOAD_REST_QUEUE_ROWS"),
    (["producer"], {"CCFD_DEVICE_FAULTS": "oom"}, "CCFD_DEVICE_FAULTS"),
    (["bus", "--port", "0"], {"CCFD_OVERLOAD_SERVE_CODEL_TARGET_MS": "5"},
     "CCFD_OVERLOAD_SERVE_CODEL_TARGET_MS"),
    (["engine", "--port", "0"], {"CCFD_LIFECYCLE_DIR": "/tmp/lc"}, "CCFD_LIFECYCLE_DIR"),
    (["notify"], {"CCFD_INLINE_ROWS": "64"}, "CCFD_INLINE_ROWS"),
    (["audit", "tx-1"], {}, "provenance plane"),
    (["audit"], {"CCFD_STORAGE_FAULTS": "bitrot"}, "CCFD_STORAGE_FAULTS"),
])
def test_roles_refuse_unported_knobs_by_name(monkeypatch, argv, env, match):
    from ccfd_tpu_torch.cli import main

    monkeypatch.setenv("KIE_SERVER_URL", "http://127.0.0.1:1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=match):
        main(argv)


def test_router_role_needs_the_engine_rest_and_the_card(monkeypatch):
    import torch

    from ccfd_tpu_torch.cli import build_router, main

    monkeypatch.delenv("KIE_SERVER_URL", raising=False)
    assert main(["router"]) == 2  # no KIE_SERVER_URL: refused before any scoring
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_router(Config(kie_server_url="http://127.0.0.1:1"))


def test_config_reads_the_roles_knobs_as_the_reference():
    from ccfd_tpu.config import Config as RefConfig

    env = {"BROKER_URL": "http://bus:9092", "KIE_SERVER_URL": "http://kie:8090",
           "SELDON_URL": "http://scorer:8000", "SELDON_ENDPOINT": "predict",
           "SELDON_TIMEOUT": "750", "SELDON_POOL_SIZE": "3", "CCFD_CLIENT_RETRIES": "4",
           "CCFD_TRACE_SAMPLE": "0.5", "CCFD_TRACE_SLOW_MS": "20",
           "CCFD_ROUTER_WORKERS": "0", "CCFD_ROUTER_COALESCE": "off", "CCFD_OVERLOAD": "0",
           "CCFD_OVERLOAD_TARGET_MS": "30", "CCFD_OVERLOAD_SERVE_TARGET_MS": "10",
           "CCFD_OVERLOAD_MIN_INFLIGHT": "100", "CCFD_OVERLOAD_MAX_INFLIGHT": "900",
           "CCFD_OVERLOAD_CODEL_TARGET_MS": "250", "CCFD_OVERLOAD_DISPATCH_DEADLINE_MS": "80"}
    fields = ("broker_url", "kie_server_url", "seldon_url", "seldon_endpoint",
              "seldon_timeout_ms", "seldon_pool_size", "client_retries", "trace_sample",
              "trace_slow_ms", "router_workers", "router_coalesce", "overload_enabled",
              "overload_target_ms", "overload_serve_target_ms", "overload_min_inflight",
              "overload_max_inflight", "overload_codel_target_ms",
              "overload_dispatch_deadline_ms", "host_tier_rows", "dispatch_deadline_ms")
    env.update(CCFD_DISPATCH_DEADLINE_MS="50")
    for e in (env, {}):
        got, want = Config.from_env(e), RefConfig.from_env(e)
        for f in fields:
            if not e and f == "dispatch_deadline_ms":
                # unset is off in the port, auto (-1) in the reference
                assert got.dispatch_deadline_ms is None and want.dispatch_deadline_ms == -1
                continue
            assert getattr(got, f) == getattr(want, f), f
    assert Config.from_env(env).unported() == []


# -- the repairs: serve refuses the unported knobs (C1), the services tune
# the GC as the reference does (C2), the router on SELDON_URL falls to the
# rules tier as the reference's role does (C3)

UNPORTED = [("CCFD_STORAGE_FAULTS", "bitrot"), ("CCFD_OVERLOAD_SERVE_CODEL_TARGET_MS", "5"),
            ("CCFD_OVERLOAD_REST_QUEUE_ROWS", "64"), ("CCFD_LIFECYCLE_DIR", "/tmp/lc"),
            ("CCFD_HOST_TIER_ROWS", "256"), ("CCFD_INLINE_ROWS", "64")]


@pytest.mark.parametrize("key,value", UNPORTED)
def test_serve_refuses_each_unported_knob_by_name(key, value):
    import re

    from ccfd_tpu_torch.cli import build_server

    cfg = Config.from_env({key: value, "CCFD_BATCH_SIZES": "16"})
    with pytest.raises(NotImplementedError, match=re.escape(key) + ".*") as err:
        build_server(cfg, device="cpu")
    assert "unset to run serve" in str(err.value)


def _reference_gen0(monkeypatch, env: dict) -> int:
    """The gen-0 threshold the reference's tune_for_service sets under
    ``env`` (gc's setters stubbed, so this process is not tuned), or
    Python's default where it opts out."""
    import gc

    from ccfd_tpu.utils import gctune as ref_gctune

    set_to = []
    monkeypatch.delenv("CCFD_GC_THRESHOLD", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(gc, "collect", lambda *a: 0)
    monkeypatch.setattr(gc, "freeze", lambda: None)
    monkeypatch.setattr(gc, "set_threshold", lambda *a: set_to.append(a[0]))
    applied = ref_gctune.tune_for_service()
    if applied:
        return set_to[-1]
    fresh = subprocess.run([sys.executable, "-c", "import gc; print(gc.get_threshold()[0])"],
                           capture_output=True, text=True, timeout=60)
    return int(fresh.stdout)


@pytest.mark.parametrize("role,env", [
    ("bus", {}), ("engine", {}), ("notify", {}), ("serve", {}),
    ("bus", {"CCFD_GC_THRESHOLD": "0"}), ("serve", {"CCFD_GC_THRESHOLD": "50000"}),
])
def test_the_services_tune_gc_as_the_reference(monkeypatch, role, env):
    want = _reference_gen0(monkeypatch, env)
    port = _free_port()
    args = {"bus": ["--host", "127.0.0.1", "--port", str(port)],
            "engine": ["--host", "127.0.0.1", "--port", str(port)],
            "notify": ["--metrics-port", str(port)],
            "serve": ["--device", "cpu", "--host", "127.0.0.1", "--port", str(port)]}[role]
    penv = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CCFD_GC_THRESHOLD")}
    penv.update(PYTHONPATH=str(REPO), CCFD_BATCH_SIZES="16", **env)
    p = subprocess.Popen([sys.executable, "-m", "ccfd_tpu_torch", role, *args], cwd=str(REPO),
                         env=penv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not line.startswith(f"[{role}]"):
            line = p.stderr.readline()
            if not line and p.poll() is not None:
                break
        assert line.startswith(f"[{role}]"), f"{role} printed no start-up line"
        assert f"gc_threshold={want}" in line, line
    finally:
        p.send_signal(signal.SIGTERM)
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def test_router_on_seldon_url_falls_to_rules_as_the_reference():
    """Both packages' router roles from the same env, SELDON_URL on a port
    nothing listens on (every scorer call refused): no host tier, so every
    row goes to the rules tier, with the same routes on both sides."""
    from ccfd_tpu.bus.broker import Broker as RefBroker
    from ccfd_tpu.config import Config as RefConfig
    from ccfd_tpu.metrics.prom import Registry as RefRegistry
    from ccfd_tpu.process.client import EngineRestClient as RefEngineClient
    from ccfd_tpu.router.router import Router as RefRouter
    from ccfd_tpu.serving.client import SeldonClient as RefSeldonClient
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.cli import build_router
    from ccfd_tpu_torch.data.ccfd import iter_transactions
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.process.fraud import build_engine
    from ccfd_tpu_torch.process.server import EngineServer

    txs = list(iter_transactions(kaggle_surrogate(n=300, seed=23)))
    env = {"SELDON_URL": f"http://127.0.0.1:{_free_port()}", "CCFD_TRACE_SAMPLE": "0",
           "CCFD_OVERLOAD": "0", "CCFD_CLIENT_RETRIES": "0", "SELDON_TIMEOUT": "2000"}
    servers, results = [], {}
    try:
        for side in ("ref", "port"):
            engine = build_engine(Config(), Broker(), Registry())
            srv = EngineServer(engine)
            servers.append(srv)
            e = {**env, "KIE_SERVER_URL": f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"}
            if side == "port":
                cfg = Config.from_env(e)
                router, reg, _sink, _collectors = build_router(cfg)
            else:  # the reference's router role, as its cmd_router wires it
                cfg = RefConfig.from_env(e)
                reg = RefRegistry()
                engine_client = RefEngineClient(cfg.kie_server_url,
                                                timeout_s=cfg.seldon_timeout_ms / 1000.0,
                                                retries=cfg.client_retries)
                router = RefRouter(cfg, RefBroker(), RefSeldonClient(cfg).score,
                                   engine_client, registry=reg, host_score_fn=None,
                                   degrade=True)
            for i in range(0, len(txs), 50):
                chunk = txs[i:i + 50]
                router.broker.produce_batch(cfg.kafka_topic, chunk, [t["id"] for t in chunk])
                while router.step():
                    pass
            routes = {inst.vars["transaction"]["id"]: inst.definition.id
                      for inst in engine.instances() if "transaction" in inst.vars}
            c = reg.counter
            results[side] = (
                routes,
                {t: c("router_degraded_total").value({"tier": t}) for t in ("host", "rules")},
                {t: c("transaction_outgoing_total").value({"type": t})
                 for t in ("fraud", "standard")})
    finally:
        for srv in servers:
            srv.stop()
    assert results["port"] == results["ref"]
    routes, tiers, out = results["port"]
    assert tiers == {"host": 0, "rules": len(txs)} and len(routes) == len(txs)
    assert sum(out.values()) == len(txs)


# -- slice 9: the durable bus, engine persistence, the Kafka adapter, the
# audit stream and CCFD_FAULTS on the roles

SLICE9 = {"CCFD_BUS_DIR": "/tmp/bus", "CCFD_BUS_FSYNC": "1",
          "CCFD_BUS_RETENTION_RECORDS": "100", "CCFD_BUS_RETENTION_OVERRIDES": "ccd-audit:0",
          "BROKER_URL": "kafka://bus:9092", "bootstrap": "kafka:9092",
          "CCFD_AUDIT_TOPIC": "ccd-audit", "CCFD_FAULTS": "scorer:error=0.5"}


def test_config_takes_this_slices_knobs_as_the_reference():
    from ccfd_tpu.config import Config as RefConfig

    got, want = Config.from_env(SLICE9), RefConfig.from_env(SLICE9)
    for f in ("bus_log_dir", "bus_fsync", "bus_retention_records", "bus_retention_overrides",
              "broker_url", "bootstrap", "audit_topic", "faults_spec"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.parsed_retention_overrides() == want.parsed_retention_overrides()
    assert got.unported() == []
    # what is left names only parts still to port
    left = Config.from_env({**SLICE9, "CCFD_DEVICE_FAULTS": "oom",
                            "CCFD_LIFECYCLE_DIR": "/tmp/lc"}).unported()
    assert [x.split(" ")[0] for x in left] == ["CCFD_LIFECYCLE_DIR", "CCFD_DEVICE_FAULTS"]


@pytest.mark.parametrize("argv", [["notify"], ["producer", "--limit", "1"],
                                  ["engine", "--port", "0"], ["audit"]])
def test_roles_on_kafka_raise_the_references_error(monkeypatch, argv):
    """BROKER_URL=kafka:// is the Kafka adapter on every role; without
    kafka-python it fails as the reference's does, not as unported."""
    from ccfd_tpu_torch.cli import main

    monkeypatch.setenv("BROKER_URL", "kafka://bootstrap:9092")
    with pytest.raises(RuntimeError, match="kafka-python is not installed"):
        main(argv)


def _spawn_bus(port: int, d: str | None, log, fsync: bool = False):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CCFD_BUS_DIR")}
    env.update(PYTHONPATH=str(REPO), CCFD_BUS_FSYNC="1" if fsync else "0")
    p = subprocess.Popen([sys.executable, "-m", "ccfd_tpu_torch", "bus", "--host",
                          "127.0.0.1", "--port", str(port)] + (["--dir", d] if d else []),
                         cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT)
    _wait_http(f"http://127.0.0.1:{port}/health/status", p)
    return p


def test_durable_bus_role_keeps_its_offsets_across_sigkill(tmp_path):
    """``bus --dir`` SIGKILLed and restarted on the same port and dir
    serves the same end offsets and committed group offsets, and the
    reference's Broker replays the directory the role wrote to the same
    state."""
    from ccfd_tpu.bus.broker import Broker as RefBroker
    from ccfd_tpu_torch.bus.client import RemoteBroker, RemoteBusError

    port, d = _free_port(), str(tmp_path / "bus")
    url = f"http://127.0.0.1:{port}"
    with open(tmp_path / "bus.log", "w") as log:
        p = _spawn_bus(port, d, log, fsync=True)
        try:
            rb = RemoteBroker(url)
            rb.produce_batch("odh-demo", [f"0.0,{i}.5,{i}" for i in range(500)],
                             keys=[str(i) for i in range(500)])
            c = rb.consumer("router", ["odh-demo"])
            while c.poll(97):
                pass
            m = rb.consumer("tail", ["ccd-audit"], auto_commit=False)
            rb.produce_batch("ccd-audit", [{"pid": i} for i in range(40)],
                             keys=list(range(40)))
            m.poll(25)
            m.commit()
            before = (rb.end_offsets("odh-demo"), rb.committed_offsets("router", "odh-demo"),
                      rb.committed_offsets("tail", "ccd-audit"), rb.end_offsets("ccd-audit"))
            p.kill()
            p.wait(10)
            with pytest.raises(RemoteBusError):
                c.poll(10)  # the bus is gone: the client's poll fails
            p = _spawn_bus(port, d, log)
            after = (rb.end_offsets("odh-demo"), rb.committed_offsets("router", "odh-demo"),
                     rb.committed_offsets("tail", "ccd-audit"), rb.end_offsets("ccd-audit"))
            assert after == before
            assert sum(before[0]) == 500 and before[1] == before[0]
            assert sum(before[2]) == 25
            # the old consumer's id died with the bus: it registers anew
            # and resumes at the group's committed offset
            rb.produce("odh-demo", "1.0,2.0", key="x")
            assert [r.value for r in c.poll(10, timeout_s=2.0)] == ["1.0,2.0"]
        finally:
            p.send_signal(signal.SIGTERM)
            p.wait(20)
    assert "durable: " + d in open(tmp_path / "bus.log").read()
    ref = RefBroker(log_dir=d)
    try:
        grown = [a - b for a, b in zip(ref.end_offsets("odh-demo"), before[0])]
        assert sorted(grown) == [0, 0, 1]  # the one record produced after the restart
        assert ref.committed_offsets("tail", "ccd-audit") == before[2]
    finally:
        ref.close()


def test_routers_on_a_killed_bus_fail_as_the_reference(tmp_path):
    """The bus role is SIGKILLed under the routers: the reference's router
    loop and the port's both fail their next poll with RemoteBusError (the
    role exits; its restart policy brings it back), neither idles."""
    from ccfd_tpu.bus.client import RemoteBroker as RefRemote
    from ccfd_tpu.config import Config as RefConfig
    from ccfd_tpu.router.router import Router as RefRouter
    from ccfd_tpu_torch.bus.client import RemoteBroker
    from ccfd_tpu_torch.router.router import Router

    class Engine:
        def definitions(self):
            return ("fraud", "standard")

    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    with open(tmp_path / "bus.log", "w") as log:
        p = _spawn_bus(port, None, log)
    score = lambda x: [0.0] * len(x)  # noqa: E731
    ref = RefRouter(RefConfig(), RefRemote(url), score, Engine(), degrade=True)
    mine = Router(Config(), RemoteBroker(url), score, Engine(), degrade=True)
    assert ref.step() == 0 and mine.step() == 0
    p.kill()
    p.wait(10)
    errors = []
    for r in (ref, mine):
        with pytest.raises(ConnectionError) as e:
            r.step()
        errors.append(type(e.value).__name__)
    assert errors == ["RemoteBusError", "RemoteBusError"]


def test_audit_tails_the_engine_stream_as_the_reference(tmp_path, capsys, monkeypatch):
    """An engine with CCFD_AUDIT_TOPIC on a durable in-process bus; then
    ``audit`` of the port and of the reference on copies of that dir print
    the same lines, and --limit stops where asked."""
    import shutil

    from ccfd_tpu.cli import main as ref_main
    from ccfd_tpu_torch.cli import local_broker, main
    from ccfd_tpu_torch.process.clock import ManualClock
    from ccfd_tpu_torch.process.fraud import build_engine

    d = str(tmp_path / "bus")
    cfg = Config.from_env({"CCFD_BUS_DIR": d, "CCFD_AUDIT_TOPIC": "ccd-audit"})
    broker = local_broker(cfg)
    clock = ManualClock()
    engine = build_engine(cfg, broker, clock=clock)
    for i in range(12):
        engine.start_process("fraud" if i % 3 else "standard",
                             {"transaction": {"id": i, "Amount": 10.0 * i}, "proba": 0.9})
    clock.advance(60.0)
    broker.close()
    shutil.copytree(d, str(tmp_path / "ref"))
    outs = []
    for fn, where in ((main, d), (ref_main, str(tmp_path / "ref"))):
        monkeypatch.setenv("CCFD_BUS_DIR", where)
        monkeypatch.setenv("CCFD_AUDIT_TOPIC", "ccd-audit")
        assert fn(["audit"]) == 0
        outs.append(capsys.readouterr().out.splitlines())
    assert outs[0] == outs[1] and len(outs[0]) > 24
    monkeypatch.setenv("CCFD_BUS_DIR", d)
    assert main(["audit", "--group", "other", "--limit", "5"]) == 0
    assert capsys.readouterr().out.splitlines() == outs[0][:5]
    assert main(["audit", "--group", "other"]) == 0  # the group resumes after the 5
    assert capsys.readouterr().out.splitlines() == outs[0][5:]


def test_demo_pipeline_takes_the_durable_bus_and_the_audit_topic(tmp_path):
    from ccfd_tpu_torch.cli import build_pipeline
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
    from tests.torch_helpers import mlp_tree

    ds = kaggle_surrogate(n=200, seed=3)
    d = str(tmp_path / "bus")
    cfg = Config.from_env({"CCFD_BUS_DIR": d, "CCFD_AUDIT_TOPIC": "ccd-audit",
                           "CCFD_BUS_RETENTION_OVERRIDES": "ccd-audit:0",
                           "CCFD_BATCH_SIZES": "16,128"})
    pipe = build_pipeline(cfg, ds, device="cpu", params=mlp_tree(ds.X, hidden=16, seed=1))
    pipe.producer.run(limit=100)
    while pipe.router.step():
        pass
    assert pipe.broker._log is not None and os.path.isdir(d)
    # a start for each of the 100, an end for each standard one
    standard = pipe.reg_router.counter("transaction_outgoing_total").value(
        {"type": "standard"})
    assert sum(pipe.broker.end_offsets("ccd-audit")) == 100 + standard
    pipe.broker.close()
