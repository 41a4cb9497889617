"""The port's Grafana boards against the reference's.

``ccfd_tpu_torch/observability/dashboards.py::build_all_dashboards`` gives
the reference's boards in full, Fleet included (the fleet's families are
registered by ``ccfd_tpu_torch/fleet/`` and the router's commit-after-route
counters), with the same panels (ids, types,
grid, thresholds, legend) and the same expressions once the reference's
build families are renamed (``NAME_MAP``: ``ccfd_xla_compile_*`` ->
``ccfd_build_*``). Every metric family a port board reads is registered
by a port module (found by AST at the call sites of ``counter``, ``gauge``
and ``histogram``, plus the families a registry and the durability
counters create), or is named below with the reason it is absent.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from ccfd_tpu.observability import dashboards as ref_dash
from ccfd_tpu_torch.observability import build_all_dashboards, write_dashboards
from ccfd_tpu_torch.observability import dashboards as port_dash

PORT = Path(__file__).resolve().parents[1] / "ccfd_tpu_torch"

# families a port board reads that no port module registers, with why
ABSENT = {
    **{f: "exported by a real Kafka cluster's exporter (the KafkaCluster board's "
          "deployment mode), by no module of either package"
       for f in ("kafka_consumergroup_lag",
                 "kafka_controller_kafkacontroller_offlinepartitionscount",
                 "kafka_server_brokertopicmetrics_bytesin_total",
                 "kafka_server_brokertopicmetrics_bytesout_total",
                 "kafka_server_brokertopicmetrics_messagesin_total",
                 "kafka_server_replicamanager_leadercount",
                 "kafka_server_replicamanager_partitioncount",
                 "kafka_server_replicamanager_underreplicatedpartitions")},
    "ccfd_host_fallback_scores_total": "the Scorer's host latency tier, refused in the "
                                       "port by design (ROADMAP A, not to be ported: A5)",
}
_PROMQL = {"rate", "sum", "by", "min", "max", "histogram_quantile", "increase", "avg",
           "irate", "without", "group_left", "group_right", "on", "ignoring", "bool", "and",
           "or", "unless", "offset", "count", "topk", "clamp_min", "abs"}


def families(expr: str) -> set[str]:
    """The metric families a PromQL expression reads (label matchers,
    ranges and grouping clauses stripped)."""
    e = re.sub(r"\{[^}]*\}", "", expr)
    e = re.sub(r"\[[^\]]*\]", "", e)
    e = re.sub(r"\b(by|without|on|ignoring|group_left|group_right)\s*\([^)]*\)", "", e)
    return {t for t in re.findall(r"[a-zA-Z_][a-zA-Z0-9_]*", e) if t not in _PROMQL}


def registered_families() -> set[str]:
    out = set()
    for path in PORT.rglob("*.py"):
        if path.name == "dashboards.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and node.args
                    and getattr(node.func, "attr", getattr(node.func, "id", None))
                    in ("counter", "gauge", "histogram", "Counter", "Gauge", "Histogram")
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.add(node.args[0].value)
    from ccfd_tpu_torch.metrics.prom import LABELSETS_DROPPED
    from ccfd_tpu_torch.runtime import durability

    out.add(LABELSETS_DROPPED)
    out.update(name for name, _help in durability._HELP.values())
    return out


def _mapped(board: dict) -> dict:
    """The reference's board with its families renamed as the port's."""
    text = json.dumps(board)
    for old, new in port_dash.NAME_MAP.items():
        text = text.replace(old, new)
    return json.loads(text)


def _without_titles(board: dict) -> dict:
    b = dict(board)
    b["panels"] = [{k: v for k, v in p.items() if k != "title"} for p in board["panels"]]
    return b


def test_the_boards_are_the_references_minus_fleet():
    """Named for the boards before the fleet was ported; since then the
    port has every reference board, Fleet included, in the same order."""
    ref, port = ref_dash.build_all_dashboards(), build_all_dashboards()
    assert list(port) == list(ref)
    assert "Fleet" in port and len(port) == 21
    assert port_dash.NAME_MAP == {"ccfd_xla_compile_events_total": "ccfd_build_events_total",
                                  "ccfd_xla_compile_seconds_total": "ccfd_build_seconds_total"}


@pytest.mark.parametrize("name", list(ref_dash.build_all_dashboards()))
def test_each_board_is_the_references_after_the_name_map(name):
    ref = _mapped(ref_dash.build_all_dashboards()[name])
    port = build_all_dashboards()[name]
    assert _without_titles(port) == _without_titles(ref)
    # titles too, but the build panels', which name the port's builds
    for a, b in zip(port["panels"], ref["panels"]):
        if "XLA" in b["title"]:
            assert "build" in a["title"].lower() and "XLA" not in a["title"]
        else:
            assert a["title"] == b["title"]
    text = json.dumps(port)
    assert "xla" not in text.lower()


def test_every_family_read_is_registered_or_named_absent():
    reg = registered_families()
    unknown = {}
    for name, board in build_all_dashboards().items():
        for panel in board["panels"]:
            for target in panel["targets"]:
                for fam in families(target["expr"]):
                    base = re.sub(r"_(bucket|count|sum)$", "", fam)
                    if fam not in reg and base not in reg and fam not in ABSENT:
                        unknown.setdefault(name, set()).add(fam)
    assert unknown == {}
    # each named absence is real: no port module registers it
    assert not (set(ABSENT) & reg)
    # the families this slice's planes export are among those read
    read = {f for b in build_all_dashboards().values() for p in b["panels"]
            for t in p["targets"] for f in families(t["expr"])}
    for fam in ("ccfd_build_events_total", "ccfd_incidents_total",
                "ccfd_capacity_model_error_ratio", "ccfd_capacity_bottleneck",
                "ccfd_fleet_members", "ccfd_fleet_partition_owner",
                "router_fenced_commits_total", "fleet_ledger_entries_total",
                "fleet_member_kill_bundles_total", "ccfd_mesh_devices", "ccfd_mesh_axis_size",
                "ccfd_mesh_publishes_total", "ccfd_mesh_publish_pause_timeouts_total",
                "analytics_workers"):
        assert fam in read and fam in reg, fam


def test_a_build_under_the_scorers_warmup_leaves_the_heal_boards_serving_compiles_at_0(
        monkeypatch):
    """The row scorer's warmup bills its builds to ``scorer.warmup``, the
    label the Heal board's serving-compile expression (the reference's)
    excludes: a kernel build on first use during warmup reads 0 there."""
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.observability import profile
    from ccfd_tpu_torch.ops import fused_mlp
    from ccfd_tpu_torch.serving.scorer import Scorer

    reg = Registry()
    prof = profile.StageProfiler(registry=reg)
    assert prof.arm_compile_listener()
    real = fused_mlp.fused_mlp_score

    def building(kp, x):  # a build at each bucket's first launch
        profile.record_build(0.25)
        return real(kp, x)

    monkeypatch.setattr(fused_mlp, "fused_mlp_score", building)
    Scorer("mlp", device="cpu", batch_sizes=(16, 128)).warmup()
    expr, = [t["expr"] for p in build_all_dashboards()["Heal"]["panels"]
             for t in p["targets"] if "ccfd_compile_stage_seconds_total{stage!~" in t["expr"]]
    excluded = re.search(r'stage!~"([^"]*)"', expr).group(1).replace("\\\\", "\\")
    by_stage = {dict(k)["stage"]: v for k, v in
                reg.counter("ccfd_compile_stage_seconds_total").items()}
    assert by_stage.get("scorer.warmup") == 0.5
    serving = sum(v for stage, v in by_stage.items() if not re.fullmatch(excluded, stage))
    assert serving == 0
    assert not re.fullmatch(excluded, "scorer.warm")  # the label the port used to bill


def test_the_families_parse_from_promql():
    assert families('sum by (span, le) (rate(trace_span_seconds_bucket{x="1"}[5m]))') == {
        "trace_span_seconds_bucket"}
    assert families("sum(kafka_consumergroup_lag) by (consumergroup)") == {
        "kafka_consumergroup_lag"}


def test_write_dashboards_emits_one_importable_file_a_board(tmp_path):
    paths = write_dashboards(str(tmp_path / "grafana"))
    assert sorted(Path(p).stem for p in paths) == sorted(build_all_dashboards())
    for p in paths:
        doc = json.loads(Path(p).read_text())
        assert doc["uid"].startswith("ccfd-") and doc["panels"]
