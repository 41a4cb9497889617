"""The port's platform operator against the reference's
(platform/operator.py, ``up -f cr.yaml``).

- **The same platform on both sides.** The reference's ``minimal_cr``
  (tests/test_platform.py) with the blocks the port refuses switched off,
  on ``logreg`` (both scorers serving the same seeded params, whose logits
  spread over about N(0, 1) on the rows), with the
  store seeded with the dataset and a store-sourced producer of 300 rows, a
  one-partition bus so that the notification service's seeded replies meet
  the same cases in the same order: equal status keys, router counters
  (routed by type, notifications and replies) and KIE histogram counts, and
  the same ``/healthz`` sources, all healthy. Routes may differ only on rows
  within 1e-5 of FRAUD_THRESHOLD (there are none on this data).
- **Parsing.** ``PlatformSpec`` of ``deploy/platform_cr.yaml`` equals the
  reference's, block for block.
- **Refusals.** Each knob that selects a part the port does not have
  makes ``Platform.up`` and ``up -f`` raise one error naming it; the
  reference's own CR with both set names both at once. What the port
  refused until A17 where the reference degrades now degrades as the
  reference's does, with its warning.
- **The port's CR** differs from the reference's only in those blocks'
  ``enabled``.
- **Crash recovery** on the CPU as the reference's TestCrashRecovery: an
  injected engine failure restores the last cut and re-drives the gap, and
  a full bounce restores the cut from disk; every transaction is started
  exactly once (the restored engine's ``next_pid``).
- **The exporter's planes**: /profile (bus, router.* and the batcher's
  stages), /debug/device, /debug/profile, the SLO gauges and the build
  counter at zero while serving.
- **Tracing the REST front**: with tracing and ``rest: true`` on, an idle
  native front leaves the tail-sampling sink without a trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import yaml

from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.platform.operator import Platform as RefPlatform
from ccfd_tpu.platform.operator import PlatformSpec as RefSpec
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.platform.operator import REFUSED_COMPONENTS, Platform, PlatformSpec
from tests import torch_helpers
from tests.test_platform import minimal_cr

REPO = Path(__file__).resolve().parents[1]
REF_CR = REPO / "deploy" / "platform_cr.yaml"
PORT_CR = REPO / "ccfd_tpu_torch" / "assets" / "platform_cr.yaml"
# the blocks the tests' CRs switch off: the parts still refused and (since
# A9, A12 and A14) the lifecycle, the analytics, the replay, the incident
# and the capacity planes, which these tests do not drive
OFF = {name: {"enabled": False}
       for name in (*REFUSED_COMPONENTS, "lifecycle", "analytics", "replay", "incident",
                    "capacity")}
ENV = {"CCFD_BATCH_SIZES": "16,128,1024", "CCFD_NATIVE_FRONT": "0"}
_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)
KIE = ("fraud_approved_amount", "fraud_rejected_amount", "fraud_approved_low_amount",
       "fraud_investigation_amount")
N = 300


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _settle(p, timeout: float = 60.0) -> dict:
    """Wait until every row is routed and the replies and KIE histograms
    stopped moving for a second; returns the observed counters."""
    deadline = time.monotonic() + timeout
    last, since = None, time.monotonic()
    while time.monotonic() < deadline:
        rr, kie = p.registries["router"], p.registries["kie"]
        out = rr.counter("transaction_outgoing_total")
        resp = rr.counter("notifications_incoming_total")
        now = {
            "incoming": rr.counter("transaction_incoming_total").value(),
            "fraud": out.value({"type": "fraud"}),
            "standard": out.value({"type": "standard"}),
            "notifications": rr.counter("notifications_outgoing_total").value(),
            "approved": resp.value({"response": "approved"}),
            "non_approved": resp.value({"response": "non_approved"}),
            "degraded": rr.counter("router_degraded_total").total(),
            "score_errors": rr.counter("router_score_errors_total").value(),
            "kie": {h: kie.histogram(h, buckets=(1.0,)).count() for h in KIE},
        }
        if now != last:
            last, since = now, time.monotonic()
        elif now["incoming"] >= N and time.monotonic() - since >= 1.0:
            return now
        time.sleep(0.05)
    raise AssertionError(f"platform did not settle: {last}")


def _health(p) -> tuple:
    code, body = _get(p.exporter.endpoint + "/healthz")
    doc = json.loads(body)
    return code, {k: v["healthy"] for k, v in doc["sources"].items()}


def _seeded_logreg(X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Seeded logreg params whose logits spread over about N(0, 1) on ``X``
    (the registry's init saturates on the dataset's raw scales)."""
    rng = np.random.default_rng(17)
    w = rng.normal(size=X.shape[1]).astype(np.float32)
    z = X @ w
    w = (w / z.std()).astype(np.float32)
    return w, np.asarray(-(X @ w).mean(), np.float32)


@contextlib.contextmanager
def _serving(registry_mod, params):
    """The registry's logreg init replaced by ``params`` (both sides serve
    the same seeded model)."""
    spec = registry_mod._REGISTRY["logreg"]
    registry_mod._REGISTRY["logreg"] = dataclasses.replace(spec, init=lambda *a, **k: params)
    try:
        yield
    finally:
        registry_mod._REGISTRY["logreg"] = spec


@pytest.fixture(scope="module")
def both():
    import jax.numpy as jnp
    import torch

    from ccfd_tpu.models import registry as ref_registry
    from ccfd_tpu_torch.data.ccfd import load_dataset
    from ccfd_tpu_torch.models import registry as port_registry

    x = load_dataset().X[:N]
    w, b = _seeded_logreg(x)
    cr = minimal_cr(**OFF, store={"enabled": True}, bus={"partitions": 1},
                    producer={"enabled": True, "transactions": N})
    with _serving(ref_registry, {"w": jnp.asarray(w), "b": jnp.asarray(b)}):
        ref = RefPlatform(RefSpec.from_cr(cr, cfg=RefConfig.from_env(ENV))).up(wait_ready_s=60)
        try:
            ref_out = (_settle(ref), ref.status(), _health(ref))
            p_ref = np.asarray(ref.scorer.score(x), np.float32)
        finally:
            ref.down()
    # a module fixture runs before the autouse guard saves anything
    with _serving(port_registry, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}), \
            torch_helpers.port_process_state():
        port = Platform(PlatformSpec.from_cr(cr, cfg=Config.from_env(ENV)), device="cpu")
        port.up(wait_ready_s=60)
        try:
            port_out = (_settle(port), port.status(), _health(port))
            p_port = port.scorer.score(x)
        finally:
            port.down()
    return ref_out, port_out, p_ref, p_port


def test_same_platform_same_counters_and_health(both):
    (r_cnt, r_st, r_h), (p_cnt, p_st, p_h), p_ref, p_port = both
    np.testing.assert_allclose(p_port, p_ref, rtol=0, atol=1e-5)
    near = int((np.abs(p_ref - 0.5) < 1e-5).sum())
    if near == 0:
        assert p_cnt == r_cnt
    else:  # a near-threshold row may route either way
        assert abs(p_cnt["fraud"] - r_cnt["fraud"]) <= near
    assert p_cnt["incoming"] == N and p_cnt["fraud"] + p_cnt["standard"] == N
    assert p_cnt["fraud"] and p_cnt["standard"] and p_cnt["approved"]
    assert set(p_st["services"]) == set(r_st["services"])
    assert set(p_st["endpoints"]) == set(r_st["endpoints"]) == {"store", "metrics", "health"}
    assert p_h == r_h == (200, {"supervisor": True, "device": True, "storage": True,
                                "scorer_edge": True})


def test_spec_parsing_of_the_references_cr():
    ref, port = RefSpec.from_yaml(str(REF_CR), cfg=RefConfig()), \
        PlatformSpec.from_yaml(str(PORT_CR), cfg=Config())
    ref_full = PlatformSpec.from_yaml(str(REF_CR), cfg=Config())
    for name in ref.components:
        r, p = ref.component(name), ref_full.component(name)
        assert (p.enabled, dict(p.options)) == (r.enabled, dict(r.options)), name
        q = port.component(name)
        assert dict(q.options) == dict(r.options), name
        assert q.enabled == (r.enabled and name not in REFUSED_COMPONENTS), name
    defaults = PlatformSpec.from_cr({"spec": {}}, cfg=Config())
    ref_defaults = RefSpec.from_cr({"spec": {}}, cfg=RefConfig())
    assert {n: c.enabled for n, c in defaults.components.items()} == \
        {n: c.enabled for n, c in ref_defaults.components.items()}
    assert PlatformSpec.from_cr({"spec": {"notify": False}}, cfg=Config()).component(
        "notify").enabled is False


def test_port_cr_differs_only_in_the_refused_blocks_enabled():
    """Since A14a the reference's CR turns on no block the port refuses, so
    the port's CR is the reference's line for line."""
    ref_lines = REF_CR.read_text().splitlines()
    port_lines = PORT_CR.read_text().splitlines()
    assert len(ref_lines) == len(port_lines)
    diff = [(a, b) for a, b in zip(ref_lines, port_lines) if a != b]
    assert all(a.strip() == "enabled: true" and b.strip() == "enabled: false"
               for a, b in diff)
    ref, port = (yaml.safe_load(p.read_text())["spec"] for p in (REF_CR, PORT_CR))
    changed = {k for k in ref if ref[k] != port[k]}
    assert changed == {k for k in REFUSED_COMPONENTS if ref.get(k, {}).get("enabled")}
    assert changed == set() and port["incident"]["enabled"] and port["capacity"]["enabled"]
    assert PlatformSpec.from_yaml(str(PORT_CR), cfg=Config()).refused() == []


# investigator, engine.usertask_model, scorer.model: seq|seq_q8, the
# batcher's queue policies, the lifecycle (the seq family's too), the
# analytics, the replay, the incident and the capacity planes are served
# since A11, A13, A15a, A12, A12b, A14, A14a and A9, and the fleet since A10:
# their cases keep their ids and now pair the served part with a knob still
# refused (CCFD_HOST_TIER_ROWS or CCFD_INLINE_ROWS > 0; until A17 the
# vehicle was mesh.devices: 0 on the CPU platform, which now serves
# unsharded as the reference does)
_HOST_TIER = ({"CCFD_HOST_TIER_ROWS": "64"}, "CCFD_HOST_TIER_ROWS")
_INLINE = ({"CCFD_INLINE_ROWS": "64"}, "CCFD_INLINE_ROWS")
REFUSALS = [(name, {name: {"enabled": True}}, {}, name) for name in REFUSED_COMPONENTS] + [
    ("fleet", {"fleet": {"enabled": True}}, *_HOST_TIER),
    ("incident", {"incident": {"enabled": True}}, *_INLINE),
    ("capacity", {"capacity": {"enabled": True}}, *_HOST_TIER),
    ("lifecycle", {"lifecycle": {"enabled": True}}, *_INLINE),
    ("analytics", {"analytics": {"enabled": True}}, *_HOST_TIER),
    ("replay", {"replay": {"enabled": True}}, *_INLINE),
    ("investigator", {"investigator": {"enabled": True}}, *_HOST_TIER),
    ("engine.usertask_model", {"engine": {"usertask_model": True}}, *_INLINE),
    # the fault plans are served since A6: the plan beside a knob still refused
    ("CCFD_DEVICE_FAULTS", {}, {"CCFD_DEVICE_FAULTS": "device_hang",
                                "CCFD_HOST_TIER_ROWS": "64"}, "CCFD_HOST_TIER_ROWS"),
    ("CCFD_STORAGE_FAULTS", {}, {"CCFD_STORAGE_FAULTS": "bitrot",
                                 "CCFD_INLINE_ROWS": "64"}, "CCFD_INLINE_ROWS"),
    ("overload.rest_queue_rows", {"overload": {"rest_queue_rows": 64}},
     {"CCFD_INLINE_ROWS": "64"}, "CCFD_INLINE_ROWS"),
]


@pytest.mark.parametrize("name,blocks,env,match", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_each_refused_part_is_named(name, blocks, env, match):
    cr = minimal_cr(**{**OFF, **blocks})
    p = Platform(PlatformSpec.from_cr(cr, cfg=Config.from_env(env)), device="cpu")
    with pytest.raises(NotImplementedError) as err:
        p.up()
    msg = str(err.value)
    assert match in msg
    item = REFUSED_COMPONENTS.get(name)
    if item:
        assert item.split(" ")[0] in msg  # the ROADMAP item
    assert p.supervisor is None or not p.supervisor.status()  # nothing started


_SEQ = {"history_length": 8, "dtype": "float32"}
# the parts the port refused until A17 where the reference degrades: each
# keeps its id and now comes up as the reference's does, with its warning
DEGRADED = [
    # a mesh of two logical CPU shards: the decision plane declines the
    # mesh scorer and the router serves the staged path
    ("mesh.devices", {"mesh": {"devices": 2}, "scorer": {"fused_decision": True},
                      "lifecycle": {"enabled": False}},
     "mesh-sharded scorer", {"mesh": 2, "fused": False}),
    # 0 on a CPU platform: the one CPU device, unsharded
    ("mesh.devices=0", {"mesh": {"devices": 0}}, "mesh.devices=0 on a CPU platform",
     {"mesh": None}),
    ("seq", {"scorer": {"model": "seq", **_SEQ}, "retrain": {"enabled": True}},
     "skipping retrain", {"retrain": False}),
    ("seq_q8", {"scorer": {"model": "seq_q8", "fused_decision": True, **_SEQ}},
     "remote and seq scorers have no fusable decision program", {"fused": False}),
    ("lifecycle.seq", {"scorer": {"model": "seq", **_SEQ}, "lifecycle": {"enabled": True},
                       "retrain": {"enabled": True}},
     "skipping retrain", {"retrain": False, "lifecycle": True}),
    ("lifecycle.seq_q8", {"scorer": {"model": "seq_q8", "fused_decision": True, **_SEQ},
                          "lifecycle": {"enabled": True}},
     "remote and seq scorers have no fusable decision program",
     {"fused": False, "lifecycle": True}),
    ("lifecycle.fused_decision", {"scorer": {"model": "mlp", "fused_decision": True},
                                  "lifecycle": {"enabled": True}},
     "incompatible with the lifecycle serving lane", {"fused": False, "lifecycle": True}),
]


@pytest.mark.parametrize("name,blocks,warning,want", DEGRADED, ids=[r[0] for r in DEGRADED])
def test_each_degraded_part_serves_as_the_reference(name, blocks, warning, want):
    """No longer refused: the platform comes up, logs the reference's
    warning, and degrades as the reference's operator does (no retrain
    service under a seq scorer, the staged path for the decision plane, a
    CPU platform's mesh.devices: 0 unsharded)."""
    cfg = Config.from_env({**ENV, "CCFD_SEQ_LEN_BUCKETS": "4"})
    spec = PlatformSpec.from_cr(minimal_cr(**{**OFF, **blocks}), cfg=cfg)
    assert spec.refused() == []
    with torch_helpers.warnings_of("ccfd_tpu_torch.platform.operator",
                                   "ccfd_tpu_torch.serving.fused") as said:
        p = Platform(spec, device="cpu").up(wait_ready_s=60)
    try:
        assert any(warning in m for m in said), (name, said)
        services = set(p.status()["services"])
        if "retrain" in want:
            assert ("retrain" in services) == want["retrain"]
        if "fused" in want:
            assert p.fused_decision is None and p.router._decision_fn is None
        if "mesh" in want:
            got = p.mesh.size if p.mesh is not None else None
            assert got == want["mesh"] and (p.scorer.mesh is None) == (got is None)
        if "lifecycle" in want:
            assert (p.lifecycle is not None) == want["lifecycle"]
    finally:
        p.down()


def test_the_references_cr_is_refused_with_every_name_at_once(tmp_path, monkeypatch):
    """The reference's CR as shipped comes up whole since A14a; with the
    fleet on (served since A10), a mesh the CPU platform serves unsharded
    (0; the mesh is served since A15b) and both unported knobs set, it is
    refused with every refused name in one error and nothing starts."""
    from ccfd_tpu_torch.cli import main

    assert PlatformSpec.from_yaml(str(REF_CR), cfg=Config()).refused() == []
    cr = yaml.safe_load(REF_CR.read_text())
    cr["spec"]["fleet"]["enabled"] = True
    cr["spec"]["mesh"]["devices"] = 0
    path = tmp_path / "cr.yaml"
    path.write_text(yaml.safe_dump(cr))
    assert PlatformSpec.from_yaml(str(path), cfg=Config()).refused() == []
    monkeypatch.setenv("CCFD_HOST_TIER_ROWS", "64")
    monkeypatch.setenv("CCFD_INLINE_ROWS", "64")
    with pytest.raises(NotImplementedError) as err:
        main(["up", "-f", str(path), "--device", "cpu"])
    msg = str(err.value)
    assert "fleet" not in msg and "mesh" not in msg
    assert [r.split(" (")[0] for r in PlatformSpec.from_yaml(str(path)).refused()] == \
        ["CCFD_HOST_TIER_ROWS > 0", "CCFD_INLINE_ROWS > 0"]
    # a default-on block is no longer refused when absent, and the opt-in
    # fleet is served: the knobs alone are named
    p = Platform(PlatformSpec.from_cr({"spec": {"fleet": True, "mesh": {"devices": 0}}}),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="CCFD_HOST_TIER_ROWS") as err:
        p.up()
    assert "fleet" not in str(err.value) and p.supervisor is None


def _recovery_cr(tmp, **engine):
    return minimal_cr(**OFF, scorer={"enabled": True, "model": "logreg"},
                      bus={"partitions": 2, "log_dir": str(tmp / "buslog")},
                      engine={"enabled": True, "crash_recovery": True, "rest": True,
                              "checkpoint_interval_s": 0.3,
                              "checkpoint_file": str(tmp / "cut.json"), **engine})


def _rows(lo, hi):
    from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES

    return [{FEATURE_NAMES[j]: float(j) for j in range(30)} | {"id": i} for i in range(lo, hi)]


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.02)


def test_engine_crash_and_bounce_start_every_transaction_once(tmp_path):
    cfg = Config.from_env({**ENV, "FRAUD_THRESHOLD": "2.0"})  # all standard: deterministic
    spec = PlatformSpec.from_cr(_recovery_cr(tmp_path), cfg=cfg)
    p = Platform(spec, device="cpu").up(wait_ready_s=30)
    try:
        incoming = p.registries["router"].counter("transaction_incoming_total")
        p.broker.produce_batch(cfg.kafka_topic, _rows(0, 40))
        _wait(lambda: incoming.value() >= 40)
        _wait(lambda: p.recovery.checkpoints > 0)
        old = p.engine
        assert p.supervisor.inject_failure("engine", "test")
        _wait(lambda: p.recovery.restores == 1 and p.engine is not old)
        assert p.engine_server.engine is p.engine and p.router.engine is p.engine
        p.broker.produce_batch(cfg.kafka_topic, _rows(40, 60))
        _wait(lambda: p.engine.snapshot()["next_pid"] - 1 == 60)
        _wait(lambda: p.recovery.checkpoints >= 3)  # a cut past every row
        saved = p.recovery._last
    finally:
        p.down()
    assert p.engine._dead  # down() silenced its timers
    p2 = Platform(PlatformSpec.from_cr(_recovery_cr(tmp_path), cfg=cfg), device="cpu")
    p2.up(wait_ready_s=30)
    try:
        assert p2.recovery.restores == 1  # restore_from_disk at boot
        snap = p2.engine.snapshot()
        assert snap["next_pid"] - 1 == 60
        assert p2.recovery._last["offsets"] == saved["offsets"] or \
            sum(p2.recovery._last["offsets"]["router\x00odh-demo"]) <= 60
    finally:
        p2.down()


def test_exporter_planes_and_no_build_while_serving(tmp_path):
    from ccfd_tpu_torch.observability.profile import builds_total

    cr = minimal_cr(**OFF, scorer={"enabled": True, "model": "logreg", "rest": True},
                    router={"enabled": True, "workers": 2}, tracing={"sample": 1.0})
    cfg = Config.from_env(ENV)
    p = Platform(PlatformSpec.from_cr(cr, cfg=cfg), device="cpu").up(wait_ready_s=30)
    try:
        warm = builds_total()
        incoming = p.registries["router"].counter("transaction_incoming_total")
        routed = p.registries["router"].counter("transaction_outgoing_total")
        p.broker.produce_batch(cfg.kafka_topic, _rows(0, 200))
        # routed, not only consumed: the route stage's profile lands after
        # the batch's last start
        _wait(lambda: incoming.value() >= 200 and routed.total() >= 200
              and "router.route" in p.profiler.snapshot()["stages"])
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", p.prediction_port, timeout=10)
        body = json.dumps({"data": {"ndarray": [[0.0] * 30] * 16}})
        conn.request("POST", "/api/v0.1/predictions", body,
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 200
        ep = p.exporter.endpoint
        prof = json.loads(_get(ep + "/profile")[1])
        stages = prof["stages"]
        for stage in ("bus", "router.decode", "router.score", "router.route",
                      "router.coalesce.batcher", "router.coalesce.dispatch",
                      "rest.batcher", "rest.dispatch"):
            assert stage in stages and {"queue", "service", "dispatch"} <= set(stages[stage])
        assert stages["bus"]["queue"]["count"] > 0
        assert stages["router.score"]["dispatch"]["count"] > 0
        dev = json.loads(_get(ep + "/debug/device")[1])
        assert dev["h2d"]["bytes_total"] > 0 and dev["h2d"]["transfer"]["count"] > 0
        assert dev["executables"]["scorer"]["warmed"] == [16, 128, 1024]
        cap = json.loads(_get(ep + "/debug/profile?seconds=0.05")[1])
        assert os.path.exists(os.path.join(cap["trace_dir"], "trace.json"))
        slo = _get(ep + "/prometheus/slo")[1].decode()
        assert "ccfd_slo_burn_rate" in slo and "ccfd_stage_latency_ms" in slo
        assert _get(ep + "/healthz")[0] == 200
        assert builds_total() == warm  # nothing built while serving
        assert prof["compile"]["count"] == 0
    finally:
        p.down()


def test_an_idle_traced_rest_front_keeps_no_trace():
    cr = minimal_cr(**OFF, scorer={"enabled": True, "model": "logreg", "rest": True},
                    tracing={"sample": 1.0})
    cfg = Config.from_env({**ENV, "CCFD_NATIVE_FRONT": "1"})
    p = Platform(PlatformSpec.from_cr(cr, cfg=cfg), device="cpu").up(wait_ready_s=30)
    try:
        assert p.prediction_server.tracer is not None and p.trace_sink.slow_s <= 0.2
        time.sleep(0.7)  # each of the front's takers times out three times
    finally:
        p.down()
    p.trace_sink.flush(0.0)
    assert [t for t in p.trace_sink.traces() if "seldon" in t["components"]] == []


def test_up_command_drains_and_exits(tmp_path):
    cr = yaml.safe_load(PORT_CR.read_text())
    s = cr["spec"]
    s["scorer"].update(port=0, train_steps=2, rest=True)
    s["monitoring"]["port"] = 0
    s["health"]["port"] = 0
    s["bus"]["log_dir"] = str(tmp_path / "buslog")
    s["engine"]["checkpoint_file"] = str(tmp_path / "cut.json")
    s["producer"]["transactions"] = 1000
    path = tmp_path / "cr.yaml"
    path.write_text(yaml.safe_dump(cr))
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(REPO),
           "CCFD_BATCH_SIZES": "16,128,1024", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-m", "ccfd_tpu_torch", "up", "-f", str(path),
                          "--exit-after-producer", "--drain-s", "60", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "router drained" in out.stderr
    got = {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
           for line in out.stderr.splitlines()
           if line.startswith(("transaction_incoming_total ", "process_instances_started_total"))}
    assert got["transaction_incoming_total"] == 1000
    assert sum(v for k, v in got.items() if k.startswith("process_instances")) == 1000
