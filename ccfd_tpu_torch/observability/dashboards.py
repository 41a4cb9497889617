"""Grafana dashboard generation: the reference's metrics contract, regenerated.

The port's copy of ccfd_tpu/observability/dashboards.py, over the metric
families the port exports. Two differences from the reference's boards:
the build panels read ``ccfd_build_events_total`` and
``ccfd_build_seconds_total`` (kernel and native-library builds,
``observability/profile.py``) where the reference's read
``ccfd_xla_compile_*`` (:data:`NAME_MAP`); and there is no Fleet board,
since the fleet (ROADMAP A10) is not ported and its families do not exist.
The Device board's mesh row reads families only the sharded path (ROADMAP
A15b) would export, as the reference's does on a single device.

The reference ships six hand-exported Grafana dashboards
(reference deploy/grafana/{KIE,Kafka,ModelPrediction,Router,SeldonCore,
SparkMetrics}.json, ~4k lines) that define its observability contract
(SURVEY.md §5). Rather than hand-maintaining 4k lines of panel JSON, this
module *generates* the equivalent dashboards from the framework's actual
metric names, one function per board:

- Router      — transaction/notification counters (reference Router.json:88-326)
- KIE         — the four amount histograms (reference KIE.json bucket panels)
- ModelPrediction — proba_1 / Amount / V17 / V10 gauges
  (reference ModelPrediction.json:96-322)
- SeldonCore  — request rate / status codes / latency quantiles
  (reference SeldonCore.json:119-531)
- Bus         — in-process broker depth/throughput (the Kafka.json analog)
- Analytics   — mesh analytics jobs + drift PSI (the SparkMetrics.json analog:
  Spark executor panels become device-mesh worker/job panels)
- Retrain     — online-training health (new capability; no reference analog)
- Resilience  — fault-injection / circuit-breaker / degradation-ladder
  surface (new capability; no reference analog)
- ModelLifecycle — shadow/canary/promotion/rollback surface of the model
  lifecycle controller (new capability; no reference analog)
- Overload     — adaptive admission / priority shedding / backpressure
  surface of the overload-control plane (new capability; no reference
  analog)
- SeqServing   — overlapped sequence-serving dataflow: assembly/dispatch
  split, (L, B)-bucket executable mix, async in-flight depth, stale-commit
  crash-replay tripwire (new capability; no reference analog)
- SLO          — burn-rate SLO monitoring + stage-profile surface:
  multi-window error-budget burn per SLO, budget remaining, breach
  alerts, the REST per-layer latency-budget ledger, and the live
  queueing/service/dispatch stage decomposition with build
  attribution (new capability; no reference analog)
- Device       — device & transfer telemetry + incident flight recorder:
  per-device memory by kind, measured H2D bytes/latency on the scorer
  staging path, per-stage compile attribution, and the incident plane's
  snapshot/bundle economics (new capability; no reference analog)
- Heal         — device self-healing surface: per-device health state
  machine, canary outcomes, heal-ladder attempts by rung, quarantine/
  re-promotion incidents, and the warm-re-promotion compile proof
  (new capability; no reference analog)
- Capacity     — queueing-model observatory: predicted vs observed p99
  per stage and end-to-end, the model-error trust gauge, utilization/
  headroom per stage, bottleneck attribution, and the service-curve
  regression sentinel (new capability; no reference analog)

``write_dashboards(dir)`` emits one importable JSON file per board.
"""

from __future__ import annotations

import json
import os
from typing import Any

# the reference's metric names the port exports under another name
NAME_MAP = {
    "ccfd_xla_compile_events_total": "ccfd_build_events_total",
    "ccfd_xla_compile_seconds_total": "ccfd_build_seconds_total",
}

_PANEL_W = 12
_PANEL_H = 8


def _panel(panel_id: int, title: str, exprs: list[str], panel_type: str = "timeseries") -> dict:
    x = (panel_id % 2) * _PANEL_W
    y = (panel_id // 2) * _PANEL_H
    return {
        "id": panel_id + 1,
        "title": title,
        "type": panel_type,
        "datasource": {"type": "prometheus", "uid": "${DS_PROMETHEUS}"},
        "gridPos": {"h": _PANEL_H, "w": _PANEL_W, "x": x, "y": y},
        "targets": [
            {"expr": expr, "refId": chr(ord("A") + i), "legendFormat": "__auto"}
            for i, expr in enumerate(exprs)
        ],
    }


def _alert_stat(
    panel_id: int, title: str, exprs: list[str],
    red_above: float | None = None, red_below: float | None = None,
) -> dict:
    """Stat panel with alert-style threshold coloring — the shape the
    reference's Kafka board uses for its broker-health stats (Brokers
    Online / Under Replicated Partitions / Offline Partitions,
    reference deploy/grafana/Kafka.json singlestat panels): green when
    healthy, red past the threshold, so the operational signal reads at a
    glance instead of needing a query."""
    p = _panel(panel_id, title, exprs, "stat")
    if red_above is not None:
        steps = [
            {"color": "green", "value": None},
            {"color": "red", "value": red_above},
        ]
    elif red_below is not None:
        steps = [
            {"color": "red", "value": None},
            {"color": "green", "value": red_below},
        ]
    else:  # pragma: no cover - callers always pick a direction
        steps = [{"color": "green", "value": None}]
    p["fieldConfig"] = {
        "defaults": {"thresholds": {"mode": "absolute", "steps": steps}},
        "overrides": [],
    }
    return p


def _dashboard(title: str, uid: str, panels: list[dict]) -> dict:
    return {
        "title": title,
        "uid": uid,
        "schemaVersion": 39,
        "version": 1,
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": []},
        "panels": panels,
        "__inputs": [
            {
                "name": "DS_PROMETHEUS",
                "label": "Prometheus",
                "type": "datasource",
                "pluginId": "prometheus",
            }
        ],
    }


def router_dashboard() -> dict:
    p = [
        _panel(0, "Incoming transactions / s",
               ["rate(transaction_incoming_total[5m])"]),
        _panel(1, "Outgoing by type / s",
               ['rate(transaction_outgoing_total{type="standard"}[5m])',
                'rate(transaction_outgoing_total{type="fraud"}[5m])']),
        _panel(2, "Customer notifications out",
               ["notifications_outgoing_total"], "stat"),
        _panel(3, "Customer responses",
               ['notifications_incoming_total{response="approved"}',
                'notifications_incoming_total{response="non_approved"}'], "stat"),
        _panel(4, "Scoring batch size p50/p95",
               ["histogram_quantile(0.5, rate(router_batch_size_bucket[5m]))",
                "histogram_quantile(0.95, rate(router_batch_size_bucket[5m]))"]),
        _panel(5, "Scorer dispatch latency p99",
               ["histogram_quantile(0.99, rate(router_score_seconds_bucket[5m]))"]),
        _panel(6, "Decode errors / s", ["rate(transaction_decode_errors_total[5m])"]),
        # business SLO quantiles (the reference tracks these on its
        # SeldonCore board, reference SeldonCore.json:499-531): wall time
        # from a record's produce timestamp to its process-start decision
        _panel(7, "Decision latency p50/p99 (produce → process start)",
               ["histogram_quantile(0.5, rate(router_decision_seconds_bucket[5m]))",
                "histogram_quantile(0.99, rate(router_decision_seconds_bucket[5m]))"]),
        # partition-parallel fan-out (router/parallel.py): batches per
        # worker loop show the partition split is actually balanced, and
        # the coalesced-dispatch rate against the pooled worker-batch rate
        # shows the fan-in onto one device (fewer dispatches than batches
        # == concurrent workers' sub-batches merged)
        _panel(8, "Batches per router worker / s",
               ["rate(router_worker_batches_total[5m])"]),
        _panel(9, "Coalesced device dispatches vs worker batches / s",
               ["rate(router_coalesced_dispatches_total[5m])",
                "sum(rate(router_worker_batches_total[5m]))"]),
        _panel(10, "Coalesced rows / s",
               ["rate(router_coalesced_rows_total[5m])"]),
        _alert_stat(11, "Load shed / s", ["rate(router_shed_total[5m])"],
                    red_above=1),
    ]
    return _dashboard("CCFD Router", "ccfd-router", p)


def kie_dashboard() -> dict:
    hists = [
        "fraud_investigation_amount",
        "fraud_approved_low_amount",
        "fraud_approved_amount",
        "fraud_rejected_amount",
    ]
    p = []
    for i, h in enumerate(hists):
        p.append(_panel(2 * i, f"{h} rate", [f"rate({h}_count[5m])"]))
        p.append(_panel(2 * i + 1, f"{h} mean amount",
                        [f"rate({h}_sum[5m]) / rate({h}_count[5m])"]))
    p.append(_panel(8, "Process starts by definition",
                    ['rate(process_instances_started_total[5m])']))
    p.append(_panel(9, "Process completions by status",
                    ['rate(process_instances_completed_total[5m])']))
    return _dashboard("CCFD Process Engine (KIE)", "ccfd-kie", p)


def model_prediction_dashboard() -> dict:
    p = [
        _panel(0, "proba_1 (last scored)", ["proba_1"]),
        _panel(1, "Amount (last scored)", ["Amount"]),
        _panel(2, "V17", ["V17"]),
        _panel(3, "V10", ["V10"]),
    ]
    return _dashboard("CCFD Model Prediction", "ccfd-modelpred", p)


def seldon_core_dashboard() -> dict:
    h = "seldon_api_executor_client_requests_seconds"
    p = [
        _panel(0, "Request rate / s", [f"rate({h}_count[5m])"]),
        _panel(1, "Success vs error codes / s",
               ['rate(seldon_api_executor_server_requests_total{code="200"}[5m])',
                'rate(seldon_api_executor_server_requests_total{code=~"4.."}[5m])',
                'rate(seldon_api_executor_server_requests_total{code=~"5.."}[5m])']),
    ]
    for i, q in enumerate((0.5, 0.75, 0.9, 0.95, 0.99)):
        p.append(
            _panel(2 + i, f"Latency p{int(q*100)}",
                   [f"histogram_quantile({q}, rate({h}_bucket[5m]))"])
        )
    # dispatch-health alerts: wedged attachment / deadline hits / requests
    # the host tier absorbed while the device was out (serving/dispatch.py)
    p.append(_alert_stat(7, "Device wedged", ["ccfd_device_wedged"], red_above=1))
    p.append(_alert_stat(8, "Dispatch timeouts",
                         ["rate(ccfd_dispatch_timeouts_total[5m])"], red_above=0.1))
    p.append(_panel(9, "Host-fallback scores / s",
                    ["rate(ccfd_host_fallback_scores_total[5m])"]))
    return _dashboard("CCFD Serving (SeldonCore)", "ccfd-seldon", p)


def bus_dashboard() -> dict:
    # broker-health panels mirror the reference Kafka board's shape:
    # messages-in rate, per-topic throughput, partition end offsets, and
    # consumer-group lag in place of under-replicated/offline-partition
    # stats (the single-log bus has no replication to degrade; lag is its
    # equivalent health signal) — reference deploy/grafana/Kafka.json
    p = [
        _panel(0, "Records in / s (cluster)", ["rate(bus_records_produced_total[5m])"]),
        _panel(1, "Records delivered / s", ["rate(bus_records_delivered_total[5m])"]),
        _panel(2, "Messages in by topic / s",
               ["rate(bus_topic_records_in_total[5m])"]),
        _panel(3, "Log end offset by topic/partition", ["bus_topic_end_offset"]),
        _panel(4, "Consumer-group backlog (lag)", ["bus_topic_backlog"]),
        # retention/log-size panels (reference Kafka.json "Log size" row):
        # retained window per partition plus the retention trim counter —
        # flat retained + rising start offset == bounded bus
        _panel(10, "Retained records by topic/partition",
               ["bus_topic_retained_records"]),
        _panel(11, "Log start offset (retention floor)",
               ["bus_topic_log_start_offset"]),
        _panel(12, "Records trimmed by retention",
               ["rate(bus_records_trimmed_total[5m])"]),
        # alert-depth health stats (the operational point of the reference
        # Kafka board): red when no consumer is attached, when backlog
        # grows past a stall-scale threshold, or when the serving side has
        # marked its device wedged
        _alert_stat(5, "Live consumers", ["bus_consumers"], red_below=1),
        _alert_stat(6, "Max consumer lag", ["max(bus_topic_backlog)"],
                    red_above=100_000),
        _alert_stat(7, "Scorer device wedged", ["max(ccfd_device_wedged)"],
                    red_above=1),
        _panel(8, "Producer rows / s", ["rate(producer_rows_total[5m])"]),
        _panel(9, "Notifications sent / replies",
               ["rate(notifications_sent_total[5m])",
                "rate(notifications_replied_total[5m])",
                "rate(notifications_no_reply_total[5m])"]),
    ]
    return _dashboard("CCFD Bus", "ccfd-bus", p)


def kafka_cluster_dashboard() -> dict:
    """Broker-health board for the REAL-Kafka deployment mode.

    When `bus/kafka_adapter.py` points the pipeline at an actual cluster
    (the reference's 3-broker Strimzi, frauddetection_cr.yaml:73-77), the
    in-proc Bus board's series don't exist — the cluster is scraped via the
    Kafka JMX exporter instead. This board carries the reference Kafka
    board's operational stat panels with the same JMX metric names and
    alert thresholds (reference deploy/grafana/Kafka.json: Brokers Online /
    Online Partitions / Under Replicated Partitions / Offline Partitions
    Count) plus throughput/lag views.
    """
    p = [
        _alert_stat(0, "Brokers Online",
                    ["count(kafka_server_replicamanager_leadercount)"],
                    red_below=3),
        _alert_stat(1, "Online Partitions",
                    ["sum(kafka_server_replicamanager_partitioncount)"],
                    red_below=1),
        _alert_stat(2, "Under Replicated Partitions",
                    ["sum(kafka_server_replicamanager_underreplicatedpartitions)"],
                    red_above=1),
        _alert_stat(3, "Offline Partitions Count",
                    ["sum(kafka_controller_kafkacontroller_offlinepartitionscount)"],
                    red_above=1),
        _panel(4, "Messages in / s",
               ["sum(rate(kafka_server_brokertopicmetrics_messagesin_total[5m]))"]),
        _panel(5, "Bytes in / out per second",
               ["sum(rate(kafka_server_brokertopicmetrics_bytesin_total[5m]))",
                "sum(rate(kafka_server_brokertopicmetrics_bytesout_total[5m]))"]),
        _panel(6, "Consumer group lag", ["sum(kafka_consumergroup_lag) by (consumergroup)"]),
        _alert_stat(7, "Adapter send failures",
                    ["rate(kafka_adapter_send_errors_total[5m])"], red_above=1),
    ]
    return _dashboard("CCFD Kafka Cluster", "ccfd-kafka", p)


def analytics_dashboard() -> dict:
    p = [
        _panel(0, "Analytics jobs / s",
               ["rate(analytics_jobs_completed_total[5m])"]),
        _panel(1, "Job duration p50/p95",
               ["histogram_quantile(0.5, rate(analytics_job_seconds_bucket[5m]))",
                "histogram_quantile(0.95, rate(analytics_job_seconds_bucket[5m]))"]),
        _panel(2, "Rows aggregated / s",
               ["rate(analytics_rows_processed_total[5m])"]),
        _panel(3, "Mesh workers", ["analytics_workers"], "stat"),
        _panel(4, "Per-feature drift PSI", ["analytics_drift_psi"]),
        _panel(5, "Worst-feature PSI", ["analytics_drift_max_psi"], "stat"),
    ]
    return _dashboard("CCFD Analytics", "ccfd-analytics", p)


def resilience_dashboard() -> dict:
    """Degraded-edge health board (no reference analog).

    Reads the fault-injection / circuit-breaker / degradation-ladder
    surface: breaker state per edge (``ccfd_breaker_state``: 0 closed,
    1 half-open, 2 open — runtime/breaker.py), per-tier degraded scoring
    and load shedding from the router's ladder (router/router.py), and the
    chaos layer's injected-fault rates (runtime/faults.py), so an operator
    can see AT A GLANCE which edge is sick, which tier is absorbing it,
    and whether the storm is injected or real.
    """
    p = [
        _alert_stat(0, "Any circuit open", ["max(ccfd_breaker_state)"],
                    red_above=2),
        _panel(1, "Breaker state by edge (0 closed / 1 half-open / 2 open)",
               ["ccfd_breaker_state"]),
        _panel(2, "Breaker transitions / s",
               ["rate(ccfd_breaker_transitions_total[5m])"]),
        _panel(3, "Degraded scoring by tier / s",
               ['rate(router_degraded_total{tier="host"}[5m])',
                'rate(router_degraded_total{tier="rules"}[5m])']),
        _alert_stat(4, "Load shedding / s", ["rate(router_shed_total[5m])"],
                    red_above=1),
        _panel(5, "Injected faults by edge+kind / s",
               ["rate(faults_injected_total[5m])"]),
        _panel(6, "Scorer-edge failures / s",
               ["rate(router_score_errors_total[5m])"]),
        _panel(7, "Chaos: service kills / fault windows per s",
               ["rate(chaos_injections_total[5m])",
                "rate(chaos_fault_windows_total[5m])"]),
        # memory-drift surface (observability/memory.py): RSS slope is the
        # endurance signal, per-component object counts name the suspect
        _panel(8, "Process RSS (bytes)", ["ccfd_process_rss_bytes"]),
        _panel(9, "Component object counts", ["ccfd_component_objects"]),
        # overload plane (runtime/overload.py): the adaptive in-flight
        # limit MOVING against its utilization is the live evidence the
        # AIMD loop is in control (the full surface is the Overload board)
        _panel(10, "Adaptive in-flight limit vs used (by stage)",
               ["ccfd_inflight_limit", "ccfd_inflight_used"]),
    ]
    return _dashboard("CCFD Resilience", "ccfd-resilience", p)


def overload_dashboard() -> dict:
    """Overload-control board (runtime/overload.py).

    The adaptive-admission surface: the AIMD in-flight limit against its
    utilization per stage (the limit visibly dropping under a latency
    step and recovering after IS the control loop working), admission
    decisions and sheds broken out by priority class and stage (bulk must
    shed first, critical last — the priority-inversion tripwire alerts if
    that ordering ever breaks), the dispatch-watchdog kill rate, REST
    429s, and the bus backlog the backpressure path parks load in instead
    of consuming it into an unbounded shed."""
    p = [
        _panel(0, "Adaptive in-flight limit vs used (by stage)",
               ["ccfd_inflight_limit", "ccfd_inflight_used"]),
        _panel(1, "Admission decisions (rows/s) by stage+priority",
               ['rate(ccfd_admission_total{decision="admit"}[5m])',
                'rate(ccfd_admission_total{decision!="admit"}[5m])']),
        _panel(2, "Shed rows / s by priority and stage",
               ["rate(ccfd_shed_total[5m])"]),
        _alert_stat(3, "Priority inversions (must be 0)",
                    ["ccfd_priority_inversions_total"], red_above=1),
        _alert_stat(4, "Dispatch watchdog kills / s",
                    ["rate(ccfd_dispatch_timeout_total[5m])"],
                    red_above=0.1),
        _panel(5, "REST admission: 429 responses / s",
               ['rate(seldon_api_executor_server_requests_total{code="429"}[5m])']),
        _panel(6, "Bus backlog under backpressure (consumer lag)",
               ["bus_topic_backlog"]),
        _panel(7, "Admitted-traffic decision latency p50/p99",
               ["histogram_quantile(0.5, rate(router_decision_seconds_bucket[5m]))",
                "histogram_quantile(0.99, rate(router_decision_seconds_bucket[5m]))"]),
        _alert_stat(8, "Router shed rate (rows/s)",
                    ["rate(router_shed_total[5m])"], red_above=1),
        _panel(9, "Batcher queue depth (serving REST / router coalescing)",
               ['ccfd_component_objects{component="serving_batcher_queue"}',
                'ccfd_component_objects{component="router_batcher_queue"}']),
    ]
    return _dashboard("CCFD Overload", "ccfd-overload", p)


def tracing_dashboard() -> dict:
    """Distributed-tracing board (observability/trace.py).

    Per-stage latency decomposition from the span histograms every
    component tracer exports (``trace_span_seconds{span=...}`` on the
    component's own scraped registry), the critical-path share each stage
    contributes (sum-of-durations normalized — the "where did this
    transaction's 40 ms go" view), and the tail sampler's keep/drop
    economics so an operator can see both what tracing shows and what it
    costs. The labelset-guard panel watches the cardinality protection
    that keeps span/edge labels from blowing up the scrape surface
    (metrics/prom.py)."""
    h = "trace_span_seconds"
    p = [
        _panel(0, "Per-stage latency p50 (by span)",
               [f"histogram_quantile(0.5, sum by (span, le) (rate({h}_bucket[5m])))"]),
        _panel(1, "Per-stage latency p99 (by span)",
               [f"histogram_quantile(0.99, sum by (span, le) (rate({h}_bucket[5m])))"]),
        _panel(2, "Critical-path share by stage",
               [f"sum by (span) (rate({h}_sum[5m])) "
                f"/ ignoring(span) group_left sum(rate({h}_sum[5m]))"]),
        _panel(3, "Spans recorded / s (by component)",
               ["rate(ccfd_trace_spans_total[5m])"]),
        _panel(4, "Sampler keep vs drop / s",
               ["rate(ccfd_traces_kept_total[5m])",
                "rate(ccfd_traces_dropped_total[5m])"]),
        _panel(5, "Forced keeps by reason / s",
               ['rate(ccfd_traces_kept_total{reason!="sampled"}[5m])']),
        _alert_stat(6, "Retained traces", ["ccfd_traces_retained"],
                    red_below=1),
        _panel(7, "Traces pending decision", ["ccfd_traces_pending"]),
        _alert_stat(8, "Label-sets folded to overflow / s",
                    ["rate(ccfd_metric_labelsets_dropped_total[5m])"],
                    red_above=1),
    ]
    return _dashboard("CCFD Tracing", "ccfd-tracing", p)


def lifecycle_dashboard() -> dict:
    """Model-lifecycle board (lifecycle/).

    The governed-rollout surface: which stage the candidate is in
    (``ccfd_lifecycle_stage``: 0 idle / 1 shadow / 2 canary), the
    promotion/rejection/rollback economics, shadow-scoring throughput and
    drops (the off-hot-path contract: drops, not latency), the evaluator's
    champion-vs-challenger evidence (label AUC, alert-rate delta,
    score-distribution PSI against its 0.25 action threshold), and the
    canary traffic split by arm. An operator reads it as: what is in
    flight, how close is the verdict, and did anything roll back."""
    p = [
        _alert_stat(0, "Candidate stage (0 idle / 1 shadow / 2 canary)",
                    ["ccfd_lifecycle_stage"], red_above=2),
        _panel(1, "Champion / candidate version",
               ["ccfd_lifecycle_champion_version",
                "ccfd_lifecycle_candidate_version"], "stat"),
        _panel(2, "Promotions / rollbacks / rejections",
               ["ccfd_lifecycle_promotions_total",
                "ccfd_lifecycle_rollbacks_total",
                "ccfd_lifecycle_rejections_total"], "stat"),
        _alert_stat(3, "Rollbacks / s",
                    ["rate(ccfd_lifecycle_rollbacks_total[5m])"],
                    red_above=0.01),
        _panel(4, "Candidates accepted vs coalesced / s",
               ["rate(ccfd_lifecycle_candidates_total[5m])",
                "rate(ccfd_lifecycle_submissions_coalesced_total[5m])"]),
        _panel(5, "Shadow rows scored / dropped per s",
               ["rate(ccfd_lifecycle_shadow_rows_total[5m])",
                "rate(ccfd_lifecycle_shadow_dropped_total[5m])"]),
        _panel(6, "Label AUC by model",
               ["ccfd_lifecycle_auc"]),
        _panel(7, "Labels / shadow rows joined for the candidate",
               ["ccfd_lifecycle_eval_labels",
                "ccfd_lifecycle_eval_shadow_rows"]),
        _alert_stat(8, "Champion vs challenger score PSI",
                    ["ccfd_lifecycle_score_psi"], red_above=0.25),
        _panel(9, "Alert-rate delta (challenger - champion)",
               ["ccfd_lifecycle_alert_rate_delta"]),
        _panel(10, "Canary rows by arm / s",
               ['rate(ccfd_lifecycle_canary_rows_total{arm="champion"}[5m])',
                'rate(ccfd_lifecycle_canary_rows_total{arm="challenger"}[5m])']),
        _alert_stat(11, "Shadow scoring errors / s",
                    ["rate(ccfd_lifecycle_shadow_errors_total[5m])",
                     "rate(ccfd_lifecycle_canary_errors_total[5m])"],
                    red_above=0.1),
    ]
    return _dashboard("CCFD Model Lifecycle", "ccfd-lifecycle", p)


def seq_serving_dashboard() -> dict:
    """Sequence Serving board (serving/history.py).

    The overlapped seq dataflow's surface: host assembly vs device
    dispatch per router batch (the BENCH_r05 1412-vs-13 ms split, now
    live numbers — dispatch here counts only the blocking waits the
    overlap failed to hide), the (L, B)-bucket executable mix (short L
    buckets firing = the cold-row fast lane actually serving), async
    in-flight depth, the anonymous lock-free fast path, live-history
    customers against the LRU cap, and the stale-generation commit
    counter — nonzero only when a dispatch was in flight across a crash
    restore, where the no-op commit is exactly what keeps replay from
    double-appending."""
    p = [
        _panel(0, "Assembly vs dispatch p50 (s / batch)",
               ["histogram_quantile(0.5, rate(seq_assembly_seconds_bucket[5m]))",
                "histogram_quantile(0.5, rate(seq_dispatch_seconds_bucket[5m]))"]),
        _panel(1, "Assembly vs dispatch p99 (s / batch)",
               ["histogram_quantile(0.99, rate(seq_assembly_seconds_bucket[5m]))",
                "histogram_quantile(0.99, rate(seq_dispatch_seconds_bucket[5m]))"]),
        _panel(2, "Dispatches by (L, B) bucket / s",
               ["rate(seq_bucket_dispatch_total[5m])"]),
        _panel(3, "Rows by L bucket / s",
               ["rate(seq_bucket_rows_total[5m])"]),
        _panel(4, "Async dispatches in flight", ["seq_inflight_dispatches"]),
        _panel(5, "Anonymous fast-path rows / s",
               ["rate(seq_anonymous_rows_total[5m])"]),
        _panel(6, "Customers with live history", ["seq_history_customers"],
               "stat"),
        _alert_stat(7, "Stale-generation commits (crash-replay no-ops)",
                    ["rate(seq_stale_commits_total[5m])"], red_above=1),
    ]
    return _dashboard("CCFD Sequence Serving", "ccfd-seq", p)


def slo_dashboard() -> dict:
    """SLO board (observability/slo.py + profile.py).

    The objective-side view the Overload board's mechanisms defend: per
    SLO, the multi-window error-budget burn rate (the fast 5m/1h pair is
    the page condition; the slow 6h window is the budget-consumption
    trend), error budget remaining, and the edge-triggered breach
    counter. Below it, the stage-profile surface: the per-layer REST
    latency-budget ledger (which layer is eating the budget — transport
    floor, batcher wait, device dispatch, H2D), the live queueing vs
    service vs dispatch decomposition per pipeline stage, and build-event
    attribution (a mid-traffic compile explains a p99
    spike no traffic change does)."""
    p = [
        _panel(0, "Error-budget burn rate by SLO and window",
               ["ccfd_slo_burn_rate"]),
        _alert_stat(1, "Fast-window burn (page at threshold)",
                    ['max(ccfd_slo_burn_rate{window="5m"})',
                     'max(ccfd_slo_burn_rate{window="1h"})'],
                    red_above=14.4),
        _alert_stat(2, "Error budget remaining by SLO",
                    ["ccfd_slo_error_budget_remaining"], red_below=0.1),
        _alert_stat(3, "SLO breaches (edge-triggered)",
                    ["ccfd_slo_breach_total"], red_above=1),
        _panel(4, "SLO breaching now (0/1)", ["ccfd_slo_breaching"]),
        _panel(5, "REST budget spent ratio by layer "
                  "(>1 = layer blows its slice)",
               ["ccfd_slo_budget_spent_ratio"]),
        _panel(6, "Stage latency p99 by component (ms)",
               ['ccfd_stage_latency_ms{quantile="p99"}']),
        _panel(7, "Stage latency p50 by component (ms)",
               ['ccfd_stage_latency_ms{quantile="p50"}']),
        _panel(8, "Queueing share: bus wait vs scorer dispatch p99 (ms)",
               ['ccfd_stage_latency_ms{stage="bus",component="queue",quantile="p99"}',
                'ccfd_stage_latency_ms{stage="router.score",component="dispatch",quantile="p99"}']),
        _alert_stat(9, "Kernel builds under traffic / s",
                    ["rate(ccfd_build_events_total[5m])"],
                    red_above=0.1),
        _panel(10, "Cumulative kernel build seconds",
               ["ccfd_build_seconds_total"]),
    ]
    return _dashboard("CCFD SLO", "ccfd-slo", p)


def device_dashboard() -> dict:
    """Device telemetry + incident board (observability/device.py
    + observability/incident.py).

    The measured side of the H2D/HBM story: per-device memory by kind
    (allocator in-use/peak/limit where the backend reports them, live
    buffer bytes everywhere), H2D staging throughput and per-put latency
    from the scorer's instrumented dispatch path (the numbers the
    BudgetLedger's h2d layer now reads instead of a reservation),
    per-stage build attribution, and the incident flight recorder's
    economics — ring depth, snapshot reasons, and the bundle counter an
    operator checks after a page to find the post-mortem at
    ``/incidents``."""
    p = [
        _panel(0, "Device memory by kind (bytes)",
               ["ccfd_device_memory_bytes"]),
        _panel(1, "H2D staged bytes / s",
               ["rate(ccfd_h2d_bytes_total[5m])"]),
        _panel(2, "H2D put latency p50/p99",
               ["histogram_quantile(0.5, rate(ccfd_h2d_seconds_bucket[5m]))",
                "histogram_quantile(0.99, rate(ccfd_h2d_seconds_bucket[5m]))"]),
        _panel(3, "H2D puts / s",
               ["rate(ccfd_h2d_seconds_count[5m])"]),
        _panel(4, "Compile seconds by stage",
               ["ccfd_compile_stage_seconds_total"]),
        _alert_stat(5, "Kernel builds under traffic / s",
                    ["rate(ccfd_build_events_total[5m])"],
                    red_above=0.1),
        _panel(6, "Flight-recorder snapshots / s (by reason)",
               ["rate(ccfd_incident_snapshots_total[5m])"]),
        _alert_stat(7, "Incident bundles dumped",
                    ["ccfd_incidents_total"], red_above=1),
        _panel(8, "Snapshot ring depth", ["ccfd_incident_ring_size"],
               "stat"),
        _alert_stat(9, "Dispatch watchdog kills / s "
                       "(each snapshots the ring)",
                    ["rate(ccfd_dispatch_timeout_total[5m])"],
                    red_above=0.1),
        # -- Mesh row (parallel/partition.py): the multi-chip
        # serving surface — device count + named axis sizes of the live
        # mesh (absent/0 = unsharded single-device serving), and the
        # publish path's health: every sharded param swap should pause
        # the router pool at a batch boundary; a pause TIMEOUT means the
        # publish went through under double-buffering only (the pool was
        # not quiescent — investigate a wedged worker)
        _panel(10, "Mesh devices (serving mesh; 0/absent = unsharded)",
               ["ccfd_mesh_devices"], "stat"),
        _panel(11, "Mesh axis sizes (data / fsdp / tp)",
               ["ccfd_mesh_axis_size"], "stat"),
        _panel(12, "Sharded param publishes / s (through the pause gate)",
               ["rate(ccfd_mesh_publishes_total[5m])"]),
        _alert_stat(13, "Publish pause timeouts / s (pool not quiescent)",
                    ["rate(ccfd_mesh_publish_pause_timeouts_total[5m])"],
                    red_above=0.01),
    ]
    return _dashboard("CCFD Device", "ccfd-device", p)


def heal_dashboard() -> dict:
    """Device-heal board (runtime/heal.py).

    The device-as-fallible-component surface: the per-device health state
    machine (one-hot ``ccfd_device_health{device,state}`` — quarantined
    is the alert), canary dispatch outcomes, heal-ladder attempts by rung
    (canary retry → backend reinit → scorer respawn), quarantine /
    re-promotion incident bundles, and the two proofs the re-promotion
    contract makes: the host tier absorbing traffic while quarantined
    (``router_degraded_total{tier="host"}``) and zero serving-stage
    compiles after the warm flip (compile-stage attribution)."""
    p = [
        _alert_stat(0, "Device quarantined now",
                    ['max(ccfd_device_health{state="quarantined"})'],
                    red_above=1),
        _panel(1, "Device health state (one-hot by device)",
               ["ccfd_device_health"]),
        _panel(2, "Health transitions / s (by target state)",
               ["rate(ccfd_heal_transitions_total[5m])"]),
        _panel(3, "Canary outcomes / s",
               ['rate(ccfd_heal_canary_total{outcome="pass"}[5m])',
                'rate(ccfd_heal_canary_total{outcome="fail"}[5m])']),
        _panel(4, "Heal-ladder attempts / s (by rung)",
               ["rate(ccfd_heal_attempts_total[5m])"]),
        _panel(5, "Quarantine / re-promotion bundles",
               ['ccfd_incidents_total{trigger="device_quarantine"}',
                'ccfd_incidents_total{trigger="device_repromote"}'],
               "stat"),
        _panel(6, "Host tier absorbing quarantined traffic (rows/s)",
               ['rate(router_degraded_total{tier="host"}[5m])',
                'rate(router_degraded_total{tier="rules"}[5m])']),
        _alert_stat(7, "Serving-stage compiles / s (warm flip ⇒ 0)",
                    # non-serving stages excluded: the warm step ITSELF
                    # emits a heal.warm compile burst (that is the
                    # contract working, not a violation) — same exclusion
                    # set as the supervisor's compile-storm signal
                    ['sum(rate(ccfd_compile_stage_seconds_total{stage!~"'
                     'total|heal\\\\..*|scorer\\\\.warmup|seq\\\\.warmup|'
                     'seq\\\\.swap"}[5m]))'],
                    red_above=0.1),
        _panel(8, "Compile seconds by stage (heal.warm = the warm step)",
               ["ccfd_compile_stage_seconds_total"]),
        _alert_stat(9, "H2D staging put failures / s",
                    ["rate(ccfd_h2d_put_failures_total[5m])"],
                    red_above=0.1),
    ]
    return _dashboard("CCFD Heal", "ccfd-heal", p)


def storage_dashboard() -> dict:
    """Durable-state integrity board (runtime/durability.py).

    The disk-as-fallible-component surface: corrupt artifacts detected
    and quarantined (the alert — every count here is a file that would
    previously have crashed bring-up or silently served garbage),
    last-good generation fallbacks, failed durable writes (full disk /
    injected storage faults; in-memory state stays authoritative and
    re-lands on the next save), verified vs legacy-unverified reads, the
    startup orphan-tmp sweep, mid-file bus-log corruption (valid records
    dropped past a corrupt frame — offset safety demands the truncation,
    this counter makes the loss loud), and the rules-tier storage pin
    (1 = NO params generation verifies; serving refuses unverified
    trees)."""
    p = [
        _alert_stat(0, "Corrupt artifacts detected (quarantined)",
                    ["sum(ccfd_storage_corrupt_total)"], red_above=1),
        _alert_stat(1, "Serving pinned to rules tier (storage)",
                    ["max(ccfd_storage_pinned)"], red_above=1),
        _panel(2, "Corruption by artifact / s",
               ["rate(ccfd_storage_corrupt_total[5m])"]),
        _panel(3, "Last-good generation fallbacks",
               ["ccfd_storage_fallback_total"], "stat"),
        _alert_stat(4, "Durable write errors / s",
                    ["sum(rate(ccfd_storage_write_errors_total[5m]))"],
                    red_above=0.1),
        _panel(5, "Reads: verified vs legacy-unverified / s",
               ["sum(rate(ccfd_storage_verified_reads_total[5m]))",
                "sum(rate(ccfd_storage_unverified_reads_total[5m]))"]),
        _panel(6, "Orphan tmp files swept at startup",
               ["ccfd_storage_tmp_swept_total"], "stat"),
        _alert_stat(7, "Bus-log records dropped past mid-file corruption",
                    ["ccfd_storage_log_truncated_records_total"],
                    red_above=1),
    ]
    return _dashboard("CCFD Storage", "ccfd-storage", p)


def audit_dashboard() -> dict:
    """Decision provenance board (observability/audit.py).

    The compliance surface: decision records stamped per routed
    transaction (the conservation claim — this rate must track the
    outgoing rate exactly), the two durable-loss alerts kept in their
    OWN units (log_write counts RECORDS whose append failed; torn_tail
    counts truncation EVENTS at crash recovery — the records inside a
    torn frame are unparseable, so an event is the honest unit), the
    segmented log's on-disk footprint, and the bounded query ring's
    depth."""
    p = [
        _panel(0, "Decision records stamped / s",
               ["rate(ccfd_audit_records_total[5m])"]),
        _panel(1, "Routed vs recorded / s (conservation: identical)",
               ["sum(rate(transaction_outgoing_total[5m]))",
                "rate(ccfd_audit_records_total[5m])"]),
        _alert_stat(2, "Records lost to failed appends",
                    ["sum(ccfd_audit_dropped_total"
                     "{reason=\"log_write\"})"],
                    red_above=1),
        _alert_stat(3, "Torn tails truncated at recovery (events)",
                    ["sum(ccfd_audit_dropped_total"
                     "{reason=\"torn_tail\"})"],
                    red_above=1),
        _panel(4, "Drops by reason / s",
               ["rate(ccfd_audit_dropped_total[5m])"]),
        _panel(5, "Audit log bytes on disk", ["ccfd_audit_log_bytes"],
               "stat"),
        _panel(6, "Query-ring depth", ["ccfd_audit_ring_records"]),
    ]
    return _dashboard("CCFD Audit", "ccfd-audit", p)


def replay_dashboard() -> dict:
    """Bulk replay & backtest board (replay/).

    The conservation surface: replayed rows by outcome (match must be
    the only moving series), divergences by classified cause with the
    one alert that matters — ``nondeterminism`` must stay 0 (every other
    cause is an EXPLAINED finding: a promote, a tier change, a threshold
    move), drops/ghosts (window accounting holes), replay throughput
    next to the bulk admission ceiling actually in force (the
    zero-live-SLO-impact evidence reads alongside the SLO board's burn
    rates), verdicts diverted at the route seam, and the durable
    cursor's progress (flat while rows flow = a wedged window)."""
    p = [
        _panel(0, "Replayed rows by outcome / s",
               ["rate(ccfd_replay_rows_total[5m])"]),
        _alert_stat(1, "Unexplained divergences (nondeterminism)",
                    ["sum(ccfd_replay_divergence_total"
                     "{cause=\"nondeterminism\"})"],
                    red_above=1),
        _panel(2, "Divergences by cause / s",
               ["rate(ccfd_replay_divergence_total[5m])"]),
        _alert_stat(3, "Window rows dropped (no verdict after retries)",
                    ["sum(ccfd_replay_rows_total{outcome=\"drop\"})"],
                    red_above=1),
        _alert_stat(4, "Ghost verdicts (uid outside the window)",
                    ["sum(ccfd_replay_rows_total{outcome=\"ghost\"})"],
                    red_above=1),
        _panel(5, "Replay throughput (rows / s, last window)",
               ["ccfd_replay_rows_per_s"]),
        _panel(6, "Bulk admission ceiling in force (by stage)",
               ["ccfd_bulk_ceiling"]),
        _panel(7, "Bulk rows shed at the ceiling / s",
               ["sum(rate(ccfd_shed_total{stage=\"bulk_ceiling\"}[5m]))"]),
        _panel(8, "Replay verdicts at the route seam / s (by fate)",
               ["rate(ccfd_replay_verdicts_total[5m])"]),
        _panel(9, "Durable cursor seq", ["ccfd_replay_cursor_seq"]),
        _panel(10, "Windows completed (clean vs findings)",
               ["sum(ccfd_replay_windows_total)"], "stat"),
    ]
    return _dashboard("CCFD Replay", "ccfd-replay", p)


def capacity_dashboard() -> dict:
    """Capacity observatory board (observability/capacity.py).

    The predictive surface the item-3 planner will actuate against: the
    model's own trustworthiness SLI first (predicted-vs-observed e2e p99
    error ratio — above 1.0 the model mispredicts by more than the
    observation itself and nothing downstream should trust it), then
    predicted p99 per stage against the live observation, utilization
    and headroom per stage, the current bottleneck attribution (one-hot
    by stage), and the service-curve regression sentinel's edge counter
    — a fired regression after a lifecycle promotion or a heal
    re-promotion is the "new executable, new service curve" signal."""
    p = [
        _alert_stat(0, "Model error ratio (|pred-obs|/obs, e2e p99)",
                    ["ccfd_capacity_model_error_ratio"], red_above=1.0),
        _panel(1, "Predicted p99 by stage (ms)",
               ['ccfd_capacity_predicted_p99_ms{stage!="e2e"}']),
        _panel(2, "Predicted vs observed e2e p99 (ms)",
               ['ccfd_capacity_predicted_p99_ms{stage="e2e"}',
                'ccfd_stage_latency_ms{quantile="p99"}']),
        _panel(3, "Stage utilization (rho)",
               ["ccfd_capacity_utilization"]),
        _panel(4, "Headroom ratio by stage (capacity / admitted)",
               ["ccfd_capacity_headroom_ratio"]),
        _alert_stat(5, "Min headroom (saturation at 1.0)",
                    ["min(ccfd_capacity_headroom_ratio)"], red_below=1.2),
        _panel(6, "Bottleneck attribution (one-hot by stage)",
               ["ccfd_capacity_bottleneck"]),
        _alert_stat(7, "Service-curve regressions fired",
                    ["sum(ccfd_capacity_regression_total)"], red_above=1),
        _panel(8, "Regressions by stage / s",
               ["rate(ccfd_capacity_regression_total[5m])"]),
    ]
    return _dashboard("CCFD Capacity", "ccfd-capacity", p)


def retrain_dashboard() -> dict:
    p = [
        _panel(0, "Labels ingested by class / s", ["rate(retrain_labels_total[5m])"]),
        _panel(1, "Optimizer steps / s", ["rate(retrain_steps_total[5m])"]),
        _panel(2, "Serving hot swaps", ["retrain_param_swaps_total"], "stat"),
        _panel(3, "Last training loss", ["retrain_last_loss"], "stat"),
    ]
    return _dashboard("CCFD Online Retrain", "ccfd-retrain", p)


def build_all_dashboards() -> dict[str, dict]:
    return {
        "Router": router_dashboard(),
        "KIE": kie_dashboard(),
        "ModelPrediction": model_prediction_dashboard(),
        "SeldonCore": seldon_core_dashboard(),
        "Bus": bus_dashboard(),
        "KafkaCluster": kafka_cluster_dashboard(),
        "Analytics": analytics_dashboard(),
        "Retrain": retrain_dashboard(),
        "Resilience": resilience_dashboard(),
        "Tracing": tracing_dashboard(),
        "ModelLifecycle": lifecycle_dashboard(),
        "Overload": overload_dashboard(),
        "SeqServing": seq_serving_dashboard(),
        "SLO": slo_dashboard(),
        "Device": device_dashboard(),
        "Heal": heal_dashboard(),
        "Storage": storage_dashboard(),
        "Audit": audit_dashboard(),
        "Replay": replay_dashboard(),
        "Capacity": capacity_dashboard(),
    }


def write_dashboards(out_dir: str) -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, board in build_all_dashboards().items():
        path = os.path.join(out_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(board, f, indent=2, sort_keys=True)
            f.write("\n")
        paths.append(path)
    return paths


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "grafana"
    for p in write_dashboards(out):
        print(p)
