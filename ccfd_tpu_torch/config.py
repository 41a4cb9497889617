"""Configuration for the port, from the reference's environment.

Only the knobs the port reads, parsed from the same environment variables
as ccfd_tpu/config.py, with the same defaults:

    CCFD_MODEL, CCFD_DTYPE, CCFD_BATCH_SIZES            scorer
    CCFD_GRAPH_CR                                       a SeldonDeployment CR
                                                        that `serve` and
                                                        `score` serve in place
                                                        of CCFD_MODEL
    CCFD_Q8_WIRE                                        mlp_q8 rows on the
                                                        wire: int8 (default,
                                                        kernel B3) or f32
                                                        (kernel B2); read by
                                                        the reference's Scorer
    CCFD_BATCH_DEADLINE_MS, CCFD_BATCH_WORKERS,
    CCFD_DYNAMIC_BATCHING                               request coalescing
                                                        (the REST batcher and
                                                        the router's poll)
    SELDON_TOKEN, CCFD_SERVE_HOST, CCFD_SERVE_PORT      REST front
    CCFD_NATIVE_FRONT                                   the REST transport: the
                                                        C++ epoll front (1, the
                                                        reference's default) or
                                                        the Python server (0)
    CCFD_DISPATCH_DEADLINE_MS                           the Scorer's dispatch
                                                        deadline (below)
    CCFD_GC_THRESHOLD                                   the services' gen-0 GC
                                                        threshold (read by
                                                        utils/gctune.py, as the
                                                        reference reads it)
    BROKER_URL                                          the bus: http:// for a
                                                        `bus` role, kafka://
                                                        for a Kafka cluster
                                                        (bus/kafka_adapter.py),
                                                        anything else
                                                        in-process
    bootstrap                                           the Kafka bootstrap
                                                        (read, unused: the
                                                        kafka:// URL carries
                                                        it, as in the
                                                        reference)
    CCFD_BUS_DIR, CCFD_BUS_FSYNC                        the in-process bus's
                                                        durable segment log
                                                        (bus/log.py) and its
                                                        fsync per append
    CCFD_BUS_RETENTION_RECORDS,
    CCFD_BUS_RETENTION_OVERRIDES                        bus retention: records
                                                        kept per partition,
                                                        "topic:cap,..." (0 =
                                                        keep everything)
    KIE_SERVER_URL                                      the engine REST (the
                                                        `router` role)
    SELDON_URL, SELDON_ENDPOINT, SELDON_TIMEOUT,
    SELDON_POOL_SIZE, CCFD_CLIENT_RETRIES               the router's remote
                                                        scorer (http:// = a
                                                        `serve` role)
    KAFKA_TOPIC, CUSTOMER_NOTIFICATION_TOPIC,
    CUSTOMER_RESPONSE_TOPIC, topic (the producer's)     bus topics
    FRAUD_THRESHOLD, CCFD_RULES                         the router's rules
    CCFD_REPLY_TIMEOUT_S, CCFD_LOW_AMOUNT,
    CCFD_LOW_PROBA, CONFIDENCE_THRESHOLD                the fraud process
    CCFD_LABELS_TOPIC                                   resolved-case labels
    CCFD_AUDIT_TOPIC                                    the engine's audit
                                                        stream ("" = off)
    CCFD_FAULTS                                         the router role's
                                                        standing fault plan
                                                        (runtime/faults.py)
    CCFD_RETRAIN_BATCH, CCFD_RETRAIN_MIN_LABELS         the online trainer
                                                        (parallel/online.py)
    CCFD_FUSED_DECISION, CCFD_FUSED_DECISION_STRICT     the decision plane
    CCFD_TRACE_SAMPLE, CCFD_TRACE_SLOW_MS               tracing (0 = off)
    CCFD_ROUTER_WORKERS, CCFD_ROUTER_COALESCE           ParallelRouter
    CCFD_OVERLOAD, CCFD_OVERLOAD_TARGET_MS,
    CCFD_OVERLOAD_SERVE_TARGET_MS,
    CCFD_OVERLOAD_MIN_INFLIGHT, CCFD_OVERLOAD_MAX_INFLIGHT,
    CCFD_OVERLOAD_CODEL_TARGET_MS,
    CCFD_OVERLOAD_DISPATCH_DEADLINE_MS                  overload control
    CCFD_OVERLOAD_SERVE_CODEL_TARGET_MS,
    CCFD_OVERLOAD_REST_QUEUE_ROWS                       the REST batcher's
                                                        CoDel target and
                                                        bounded priority
                                                        queue (0 = off; the
                                                        Python transport only)
    CCFD_SEQ_STRIPES, CCFD_SEQ_INFLIGHT,
    CCFD_SEQ_LEN_BUCKETS                                the seq family's
                                                        history store and
                                                        scorer
                                                        (serving/history.py)
    s3endpoint, s3bucket, filename, ACCESS_KEY_ID,
    SECRET_ACCESS_KEY                                   the object store: the
                                                        producer's source and
                                                        the `store` command
    CCFD_SLO, CCFD_SLO_INTERVAL_S,
    CCFD_SLO_E2E_TARGET_MS, CCFD_SLO_REST_TARGET_MS,
    CCFD_SLO_OBJECTIVE, CCFD_SLO_MAX_ERROR_RATE,
    CCFD_SLO_WINDOWS, CCFD_SLO_FAST_BURN,
    CCFD_SLO_TRANSPORT_FLOOR_MS                         the operator's stage
                                                        profiler and SLO
                                                        engine
    CCFD_DEVICE                                         the operator's device
                                                        telemetry
    CCFD_STORAGE_RETAIN, CCFD_STORAGE_FSYNC,
    CCFD_STORAGE_SWEEP                                  the operator's
                                                        durability block
    CCFD_MESH_DEVICES                                   the operator's mesh
                                                        block (1 only)

    CCFD_HEAL, CCFD_HEAL_INTERVAL_S,
    CCFD_HEAL_CANARY_DEADLINE_MS,
    CCFD_HEAL_SUSPECT_STRIKES,
    CCFD_HEAL_PROBATION_CANARIES,
    CCFD_HEAL_PARITY_TOL, CCFD_HEAL_OOM_RATIO,
    CCFD_HEAL_COMPILE_STORM_PER_S,
    CCFD_HEAL_BACKOFF_BASE_S, CCFD_HEAL_BACKOFF_CAP_S,
    CCFD_HEAL_FLAP_WINDOW_S                             the operator's device
                                                        heal supervisor
                                                        (runtime/heal.py)
    CCFD_DEVICE_FAULTS, CCFD_STORAGE_FAULTS             the standing device and
                                                        storage fault plans
                                                        (runtime/faults.py);
                                                        only the operator
                                                        installs them, as in
                                                        the reference
    CCFD_AUDIT, CCFD_AUDIT_DIR, CCFD_AUDIT_RING,
    CCFD_AUDIT_SEGMENT_BYTES, CCFD_AUDIT_SEGMENTS,
    CCFD_AUDIT_FLUSH_INTERVAL_S                         the operator's decision
                                                        provenance plane
                                                        (observability/audit.py)
    CCFD_INCIDENT, CCFD_INCIDENT_INTERVAL_S,
    CCFD_INCIDENT_RING, CCFD_INCIDENT_DIR               the operator's incident
                                                        flight recorder
                                                        (observability/incident.py)
    CCFD_CAPACITY, CCFD_CAPACITY_INTERVAL_S,
    CCFD_CAPACITY_BASELINE,
    CCFD_CAPACITY_REGRESSION_TOL,
    CCFD_CAPACITY_MIN_SAMPLES                           the operator's capacity
                                                        observatory
                                                        (observability/capacity.py)
    CCFD_LIFECYCLE_SHADOW_TOPIC, CCFD_LIFECYCLE_DIR,
    CCFD_LIFECYCLE_MIN_LABELS,
    CCFD_LIFECYCLE_MIN_SHADOW_ROWS,
    CCFD_LIFECYCLE_AUC_MARGIN,
    CCFD_LIFECYCLE_MAX_ALERT_DELTA,
    CCFD_LIFECYCLE_MAX_PSI,
    CCFD_LIFECYCLE_CANARY_WEIGHT,
    CCFD_LIFECYCLE_CANARY_MIN_LABELS,
    CCFD_LIFECYCLE_MIN_SUBMIT_INTERVAL_S                the model lifecycle's
                                                        topic, lineage store
                                                        and guardrails
                                                        (lifecycle/)
    CCFD_REPLAY, CCFD_REPLAY_BATCH,
    CCFD_REPLAY_TIMEOUT_S, CCFD_REPLAY_RETRIES,
    CCFD_REPLAY_BULK_CEILING, CCFD_REPLAY_PACING,
    CCFD_REPLAY_DIR                                     the bulk replay plane
                                                        (replay/)

Knobs that select a part of the reference this port does not have are read
too, so that setting one is refused by name rather than ignored
(``unported``): the two ways
the reference scores small requests round the kernel: the Scorer's host
latency tier (CCFD_HOST_TIER_ROWS > 0) and the REST front's in-IO-thread
host model (CCFD_INLINE_ROWS > 0). Their auto value (-1, or unset) is off
in the port.

**The Scorer's dispatch deadline is off unless the environment sets it**,
where the reference arms it by default on an accelerator.
``scorer_dispatch_deadline_ms`` resolves CCFD_DISPATCH_DEADLINE_MS:

    unset or empty   off
    0                off
    > 0              the deadline in milliseconds
    -1               the reference's auto, asked for explicitly:
                     SELDON_TIMEOUT on the card, off on the CPU

A dispatch past it answers 503 (serving/scorer.py). The router's dispatch
watchdog keeps its own resolution (``watchdog_deadline_ms``), where an
unset CCFD_DISPATCH_DEADLINE_MS still means auto.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Sequence


def _flag(value: str) -> bool:
    return value.strip().lower() in ("1", "true", "yes", "on")


def _on_unless_off(value: str) -> bool:
    return value.strip().lower() not in ("0", "false", "no", "off")


@dataclass(frozen=True)
class Config:
    seldon_token: str = ""  # bearer token; empty = no auth
    model_name: str = "mlp"
    compute_dtype: str = "bfloat16"
    batch_sizes: Sequence[int] = (16, 128, 1024, 4096, 16384)
    q8_wire: str = "int8"  # "f32" opts out of the host-prequantized wire
    batch_deadline_ms: float = 2.0
    batch_workers: int = 4  # overlapped dispatches
    dynamic_batching: bool = True  # serving-side request coalescing
    serve_host: str = "0.0.0.0"
    serve_port: int = 8000
    native_front: bool = True  # C++ REST front; False = the Python server
    # the Scorer's dispatch deadline (the module docstring: None = unset =
    # off, -1 = the reference's auto, > 0 explicit)
    dispatch_deadline_ms: float | None = None
    # --- bus / topics (reference router.yaml:54-62) ---
    broker_url: str = "inproc://local"
    kafka_topic: str = "odh-demo"
    customer_notification_topic: str = "ccd-customer-outgoing"
    customer_response_topic: str = "ccd-customer-response"
    producer_topic: str = "odh-demo"
    labels_topic: str = "ccd-labels"
    # --- online retrain (parallel/online.py) ---
    retrain_batch: int = 1024
    retrain_min_labels: int = 256
    # --- service endpoints (reference router.yaml:63-68) ---
    kie_server_url: str = "inproc://engine"
    seldon_url: str = "inproc://scorer"
    seldon_endpoint: str = "api/v0.1/predictions"  # URL path, not a model
    seldon_timeout_ms: int = 5000
    seldon_pool_size: int = 5
    client_retries: int = 2
    # --- decision thresholds (reference router.yaml:69-70) ---
    fraud_threshold: float = 0.5
    rules_file: str = ""  # JSON rule base (CCFD_RULES) -> router/rules.py
    confidence_threshold: float = 1.0
    # --- process engine ---
    customer_reply_timeout_s: float = 30.0
    low_amount_threshold: float = 200.0
    low_proba_threshold: float = 0.75
    # --- the decision plane (serving/fused.py); off by default, as in the
    # reference ---
    fused_decision: bool = False
    fused_decision_strict: bool = False
    # --- tracing (observability/trace.py): the tail sampler's keep rate for
    # unflagged traces (0 turns tracing off in the roles) and the bar above
    # which a trace is always kept ---
    trace_sample: float = 0.02
    trace_slow_ms: float = 100.0
    # --- router fan-out (router/parallel.py): 1 = one Router, 0 = one
    # worker per bus partition, >1 explicit ---
    router_workers: int = 1
    router_coalesce: bool = True
    # --- sequence serving (serving/history.py) ---
    seq_stripes: int = 8  # HistoryStore stripe count
    # dispatches in flight before the scoring loop waits on the oldest;
    # 0 = the synchronous chunk loop
    seq_inflight: int = 2
    # short-sequence ladder, off by default (empty): cold rows' scores
    # differ between rungs, as the attention has no padding mask
    seq_len_buckets: Sequence[int] = ()
    # --- overload control (runtime/overload.py) ---
    overload_enabled: bool = True
    overload_target_ms: float = 50.0        # the router's AIMD latency budget
    overload_serve_target_ms: float = 25.0  # the REST gate's
    overload_min_inflight: int = 0          # 0 = auto: one router max_batch
    overload_max_inflight: int = 0          # 0 = auto: 4x the initial limit
    overload_codel_target_ms: float = 0.0   # bus sojourn deadline; 0 = off
    # the REST batcher's CoDel target and bounded queue (0 = off)
    overload_serve_codel_target_ms: float = 0.0
    overload_rest_queue_rows: int = 0
    # router dispatch watchdog: -1 = auto (SELDON_TIMEOUT when the router
    # scores on the card, off on the CPU), 0 = off
    overload_dispatch_deadline_ms: float = -1.0
    # --- durability, Kafka, audit and faults (the reference's roles) ---
    bus_log_dir: str = ""  # durable segment-log dir (CCFD_BUS_DIR); "" = memory
    bus_fsync: bool = False  # fsync per append (CCFD_BUS_FSYNC=1)
    # per-partition retained-record cap; 0 = keep everything
    bus_retention_records: int = 0
    bus_retention_overrides: str = ""  # "topic:cap,topic2:0"
    bootstrap: str = "odh-message-bus-kafka-brokers:9092"
    audit_topic: str = ""  # "" = the engine's audit stream is off
    # the router role's standing fault plan,
    # "edge:latency=50,jitter=20,error=0.1;edge2:blackhole"; "" = none
    faults_spec: str = ""
    # --- the object store (store/; the producer's source when s3endpoint
    # is set, reference ProducerDeployment.yaml:77-97) ---
    s3_endpoint: str = ""
    s3_bucket: str = "ccdata"
    filename: str = "creditcard.csv"
    access_key_id: str = ""
    secret_access_key: str = ""
    # --- the operator's planes (platform/operator.py) ---
    slo_enabled: bool = True
    slo_interval_s: float = 5.0
    slo_e2e_target_ms: float = 50.0
    slo_rest_target_ms: float = 25.0
    slo_objective: float = 0.99
    slo_max_error_rate: float = 0.01
    slo_windows: str = "300,3600,21600"
    slo_fast_burn: float = 14.4
    # the budget ledger's static transport layer: the reference's default,
    # not a measurement on the card
    slo_transport_floor_ms: float = 0.072
    device_enabled: bool = True
    storage_retain: int = 3
    storage_fsync: bool = True
    storage_sweep: bool = True
    mesh_devices: int = 1
    # --- the device heal supervisor (runtime/heal.py; CR block `heal:`),
    # on by default with a local scorer; CCFD_HEAL=0 is the kill switch ---
    heal_enabled: bool = True
    heal_interval_s: float = 5.0           # supervision tick
    heal_canary_deadline_ms: float = 250.0  # one canary dispatch's deadline
    heal_suspect_strikes: int = 2          # strike ticks before quarantine
    heal_probation_canaries: int = 3       # passes before the warm flip
    heal_parity_tol: float = 0.05          # max |device - host| in p
    heal_oom_ratio: float = 0.92           # bytes_in_use / bytes_limit
    heal_compile_storm_per_s: float = 2.0  # serving-label builds a second
    heal_backoff_base_s: float = 0.5       # heal-ladder backoff
    heal_backoff_cap_s: float = 30.0
    heal_flap_window_s: float = 60.0       # re-quarantine = a flap
    # the device and storage fault plans (runtime/faults.py): standing
    # plans only the operator installs; "" = none
    device_faults_spec: str = ""
    storage_faults_spec: str = ""
    # --- the decision provenance plane (observability/audit.py; CR block
    # `audit:`); CCFD_AUDIT=0 is the kill switch ---
    audit_enabled: bool = True
    audit_dir: str = ""                    # "" = the ring only
    audit_ring: int = 65536
    audit_segment_bytes: int = 4 * 1024 * 1024
    audit_segments: int = 8
    audit_flush_interval_s: float = 0.25
    # --- the incident flight recorder (observability/incident.py; CR block
    # `incident:`); CCFD_INCIDENT=0 kills the plane (breaches still page,
    # they stop dumping bundles) ---
    incident_enabled: bool = True
    incident_interval_s: float = 5.0       # ring-snapshot cadence
    incident_ring: int = 64                # snapshot-ring depth
    incident_dir: str = ""                 # "" = bundles in memory only
    # --- the capacity observatory (observability/capacity.py; CR block
    # `capacity:`); CCFD_CAPACITY=0 kills it (both endpoints 404) ---
    capacity_enabled: bool = True
    capacity_interval_s: float = 2.0       # fit-window tick
    capacity_baseline_file: str = ""       # "" = baseline in memory only
    # the sentinel's fractional departure from baseline: 1.0 fires past 2x
    capacity_regression_tolerance: float = 1.0
    capacity_min_samples: int = 50         # samples before the baseline
    # --- the model lifecycle (lifecycle/; the governed rollout of retrain
    # candidates: shadow -> canary -> gated promotion with auto-rollback) ---
    shadow_topic: str = "ccd-shadow-scores"  # paired champion/challenger scores
    lifecycle_dir: str = ""  # lineage + candidate checkpoints; "" = in memory
    lifecycle_min_labels: int = 128
    lifecycle_min_shadow_rows: int = 1024
    lifecycle_auc_margin: float = 0.01
    lifecycle_max_alert_delta: float = 0.10
    lifecycle_max_psi: float = 0.25
    lifecycle_canary_weight: float = 0.10
    lifecycle_canary_min_labels: int = 64
    lifecycle_min_submit_interval_s: float = 30.0
    # --- bulk replay and backtest (replay/; CR block `replay:`); CCFD_REPLAY
    # arms row capture, the verdict tap and the replay worker ---
    replay_enabled: bool = False
    replay_batch: int = 256  # rows a batch (one cursor commit each)
    replay_timeout_s: float = 10.0  # the verdict join's wait an attempt
    replay_retries: int = 3  # re-productions of a batch's unanswered rows
    replay_bulk_ceiling: float = 0.5  # bulk share of the admission budget
    replay_pacing_rows_s: float = 0.0  # 0 = saturate the bulk share
    replay_dir: str = ""  # the durable cursors; "" = no resume
    # --- parts of the reference not ported yet: set, they are refused ---
    graph_cr: str = ""
    host_tier_rows: int = -1  # -1 = auto, which is off in the port
    inline_rows: int = -1  # -1 = auto, which is off in the port

    @staticmethod
    def from_env(env: Mapping[str, str] | None = None) -> "Config":
        e = dict(os.environ if env is None else env)
        sizes = e.get("CCFD_BATCH_SIZES", "")
        seq_lb = e.get("CCFD_SEQ_LEN_BUCKETS", "")

        def num(key: str, field: str, conv=float):
            return conv(e.get(key, str(getattr(Config, field))))

        def opt(key: str, conv=float):
            value = e.get(key, "").strip()
            return conv(value) if value else None

        return Config(
            seldon_token=e.get("SELDON_TOKEN", Config.seldon_token),
            model_name=e.get("CCFD_MODEL", Config.model_name),
            compute_dtype=e.get("CCFD_DTYPE", Config.compute_dtype),
            batch_sizes=tuple(int(s) for s in sizes.split(",")) if sizes else Config.batch_sizes,
            # as the reference: any value but "f32" keeps the int8 wire
            q8_wire="f32" if e.get("CCFD_Q8_WIRE", "int8") == "f32" else "int8",
            batch_deadline_ms=num("CCFD_BATCH_DEADLINE_MS", "batch_deadline_ms"),
            batch_workers=num("CCFD_BATCH_WORKERS", "batch_workers", int),
            dynamic_batching=_on_unless_off(e.get("CCFD_DYNAMIC_BATCHING", "1")),
            serve_host=e.get("CCFD_SERVE_HOST", Config.serve_host),
            serve_port=num("CCFD_SERVE_PORT", "serve_port", int),
            native_front=_on_unless_off(e.get("CCFD_NATIVE_FRONT", "1")),
            dispatch_deadline_ms=opt("CCFD_DISPATCH_DEADLINE_MS"),
            broker_url=e.get("BROKER_URL", Config.broker_url),
            kafka_topic=e.get("KAFKA_TOPIC", Config.kafka_topic),
            customer_notification_topic=e.get(
                "CUSTOMER_NOTIFICATION_TOPIC", Config.customer_notification_topic),
            customer_response_topic=e.get(
                "CUSTOMER_RESPONSE_TOPIC", Config.customer_response_topic),
            producer_topic=e.get("topic", Config.producer_topic),
            labels_topic=e.get("CCFD_LABELS_TOPIC", Config.labels_topic),
            retrain_batch=num("CCFD_RETRAIN_BATCH", "retrain_batch", int),
            retrain_min_labels=num("CCFD_RETRAIN_MIN_LABELS", "retrain_min_labels", int),
            kie_server_url=e.get("KIE_SERVER_URL", Config.kie_server_url),
            seldon_url=e.get("SELDON_URL", Config.seldon_url),
            seldon_endpoint=e.get("SELDON_ENDPOINT", Config.seldon_endpoint),
            seldon_timeout_ms=num("SELDON_TIMEOUT", "seldon_timeout_ms", int),
            seldon_pool_size=num("SELDON_POOL_SIZE", "seldon_pool_size", int),
            client_retries=num("CCFD_CLIENT_RETRIES", "client_retries", int),
            fraud_threshold=num("FRAUD_THRESHOLD", "fraud_threshold"),
            rules_file=e.get("CCFD_RULES", Config.rules_file),
            confidence_threshold=num("CONFIDENCE_THRESHOLD", "confidence_threshold"),
            customer_reply_timeout_s=num("CCFD_REPLY_TIMEOUT_S", "customer_reply_timeout_s"),
            low_amount_threshold=num("CCFD_LOW_AMOUNT", "low_amount_threshold"),
            low_proba_threshold=num("CCFD_LOW_PROBA", "low_proba_threshold"),
            fused_decision=_flag(e.get("CCFD_FUSED_DECISION", "0")),
            fused_decision_strict=_flag(e.get("CCFD_FUSED_DECISION_STRICT", "0")),
            trace_sample=num("CCFD_TRACE_SAMPLE", "trace_sample"),
            trace_slow_ms=num("CCFD_TRACE_SLOW_MS", "trace_slow_ms"),
            router_workers=num("CCFD_ROUTER_WORKERS", "router_workers", int),
            router_coalesce=_on_unless_off(e.get("CCFD_ROUTER_COALESCE", "1")),
            overload_enabled=_on_unless_off(e.get("CCFD_OVERLOAD", "1")),
            overload_target_ms=num("CCFD_OVERLOAD_TARGET_MS", "overload_target_ms"),
            overload_serve_target_ms=num("CCFD_OVERLOAD_SERVE_TARGET_MS",
                                         "overload_serve_target_ms"),
            overload_min_inflight=num("CCFD_OVERLOAD_MIN_INFLIGHT",
                                      "overload_min_inflight", int),
            overload_max_inflight=num("CCFD_OVERLOAD_MAX_INFLIGHT",
                                      "overload_max_inflight", int),
            overload_codel_target_ms=num("CCFD_OVERLOAD_CODEL_TARGET_MS",
                                         "overload_codel_target_ms"),
            overload_dispatch_deadline_ms=num("CCFD_OVERLOAD_DISPATCH_DEADLINE_MS",
                                              "overload_dispatch_deadline_ms"),
            bus_log_dir=e.get("CCFD_BUS_DIR", Config.bus_log_dir),
            bus_fsync=e.get("CCFD_BUS_FSYNC", "") in ("1", "true", "yes"),
            bus_retention_records=num("CCFD_BUS_RETENTION_RECORDS",
                                      "bus_retention_records", int),
            bus_retention_overrides=e.get(
                "CCFD_BUS_RETENTION_OVERRIDES", Config.bus_retention_overrides),
            bootstrap=e.get("bootstrap", Config.bootstrap),
            audit_topic=e.get("CCFD_AUDIT_TOPIC", Config.audit_topic),
            s3_endpoint=e.get("s3endpoint", Config.s3_endpoint),
            s3_bucket=e.get("s3bucket", Config.s3_bucket),
            filename=e.get("filename", Config.filename),
            access_key_id=e.get("ACCESS_KEY_ID", Config.access_key_id),
            secret_access_key=e.get("SECRET_ACCESS_KEY", Config.secret_access_key),
            slo_enabled=_on_unless_off(e.get("CCFD_SLO", "1")),
            slo_interval_s=num("CCFD_SLO_INTERVAL_S", "slo_interval_s"),
            slo_e2e_target_ms=num("CCFD_SLO_E2E_TARGET_MS", "slo_e2e_target_ms"),
            slo_rest_target_ms=num("CCFD_SLO_REST_TARGET_MS", "slo_rest_target_ms"),
            slo_objective=num("CCFD_SLO_OBJECTIVE", "slo_objective"),
            slo_max_error_rate=num("CCFD_SLO_MAX_ERROR_RATE", "slo_max_error_rate"),
            slo_windows=e.get("CCFD_SLO_WINDOWS", Config.slo_windows),
            slo_fast_burn=num("CCFD_SLO_FAST_BURN", "slo_fast_burn"),
            slo_transport_floor_ms=num("CCFD_SLO_TRANSPORT_FLOOR_MS",
                                       "slo_transport_floor_ms"),
            device_enabled=_on_unless_off(e.get("CCFD_DEVICE", "1")),
            storage_retain=num("CCFD_STORAGE_RETAIN", "storage_retain", int),
            storage_fsync=_on_unless_off(e.get("CCFD_STORAGE_FSYNC", "1")),
            storage_sweep=_on_unless_off(e.get("CCFD_STORAGE_SWEEP", "1")),
            mesh_devices=num("CCFD_MESH_DEVICES", "mesh_devices", int),
            heal_enabled=_on_unless_off(e.get("CCFD_HEAL", "1")),
            heal_interval_s=num("CCFD_HEAL_INTERVAL_S", "heal_interval_s"),
            heal_canary_deadline_ms=num("CCFD_HEAL_CANARY_DEADLINE_MS",
                                        "heal_canary_deadline_ms"),
            heal_suspect_strikes=num("CCFD_HEAL_SUSPECT_STRIKES", "heal_suspect_strikes",
                                     int),
            heal_probation_canaries=num("CCFD_HEAL_PROBATION_CANARIES",
                                        "heal_probation_canaries", int),
            heal_parity_tol=num("CCFD_HEAL_PARITY_TOL", "heal_parity_tol"),
            heal_oom_ratio=num("CCFD_HEAL_OOM_RATIO", "heal_oom_ratio"),
            heal_compile_storm_per_s=num("CCFD_HEAL_COMPILE_STORM_PER_S",
                                         "heal_compile_storm_per_s"),
            heal_backoff_base_s=num("CCFD_HEAL_BACKOFF_BASE_S", "heal_backoff_base_s"),
            heal_backoff_cap_s=num("CCFD_HEAL_BACKOFF_CAP_S", "heal_backoff_cap_s"),
            heal_flap_window_s=num("CCFD_HEAL_FLAP_WINDOW_S", "heal_flap_window_s"),
            device_faults_spec=e.get("CCFD_DEVICE_FAULTS", Config.device_faults_spec),
            storage_faults_spec=e.get("CCFD_STORAGE_FAULTS", Config.storage_faults_spec),
            audit_enabled=_on_unless_off(e.get("CCFD_AUDIT", "1")),
            audit_dir=e.get("CCFD_AUDIT_DIR", Config.audit_dir),
            audit_ring=num("CCFD_AUDIT_RING", "audit_ring", int),
            audit_segment_bytes=num("CCFD_AUDIT_SEGMENT_BYTES", "audit_segment_bytes", int),
            audit_segments=num("CCFD_AUDIT_SEGMENTS", "audit_segments", int),
            audit_flush_interval_s=num("CCFD_AUDIT_FLUSH_INTERVAL_S",
                                       "audit_flush_interval_s"),
            incident_enabled=_on_unless_off(e.get("CCFD_INCIDENT", "1")),
            incident_interval_s=num("CCFD_INCIDENT_INTERVAL_S", "incident_interval_s"),
            incident_ring=num("CCFD_INCIDENT_RING", "incident_ring", int),
            incident_dir=e.get("CCFD_INCIDENT_DIR", Config.incident_dir),
            capacity_enabled=_on_unless_off(e.get("CCFD_CAPACITY", "1")),
            capacity_interval_s=num("CCFD_CAPACITY_INTERVAL_S", "capacity_interval_s"),
            capacity_baseline_file=e.get("CCFD_CAPACITY_BASELINE",
                                         Config.capacity_baseline_file),
            capacity_regression_tolerance=num("CCFD_CAPACITY_REGRESSION_TOL",
                                              "capacity_regression_tolerance"),
            capacity_min_samples=num("CCFD_CAPACITY_MIN_SAMPLES", "capacity_min_samples", int),
            faults_spec=e.get("CCFD_FAULTS", Config.faults_spec),
            seq_stripes=num("CCFD_SEQ_STRIPES", "seq_stripes", int),
            seq_inflight=num("CCFD_SEQ_INFLIGHT", "seq_inflight", int),
            seq_len_buckets=(tuple(int(s) for s in seq_lb.split(",") if s.strip())
                             if seq_lb else Config.seq_len_buckets),
            overload_serve_codel_target_ms=num("CCFD_OVERLOAD_SERVE_CODEL_TARGET_MS",
                                               "overload_serve_codel_target_ms"),
            overload_rest_queue_rows=num("CCFD_OVERLOAD_REST_QUEUE_ROWS",
                                         "overload_rest_queue_rows", int),
            graph_cr=e.get("CCFD_GRAPH_CR", Config.graph_cr),
            shadow_topic=e.get("CCFD_LIFECYCLE_SHADOW_TOPIC", Config.shadow_topic),
            lifecycle_dir=e.get("CCFD_LIFECYCLE_DIR", Config.lifecycle_dir),
            lifecycle_min_labels=num("CCFD_LIFECYCLE_MIN_LABELS", "lifecycle_min_labels", int),
            lifecycle_min_shadow_rows=num("CCFD_LIFECYCLE_MIN_SHADOW_ROWS",
                                          "lifecycle_min_shadow_rows", int),
            lifecycle_auc_margin=num("CCFD_LIFECYCLE_AUC_MARGIN", "lifecycle_auc_margin"),
            lifecycle_max_alert_delta=num("CCFD_LIFECYCLE_MAX_ALERT_DELTA",
                                          "lifecycle_max_alert_delta"),
            lifecycle_max_psi=num("CCFD_LIFECYCLE_MAX_PSI", "lifecycle_max_psi"),
            lifecycle_canary_weight=num("CCFD_LIFECYCLE_CANARY_WEIGHT",
                                        "lifecycle_canary_weight"),
            lifecycle_canary_min_labels=num("CCFD_LIFECYCLE_CANARY_MIN_LABELS",
                                            "lifecycle_canary_min_labels", int),
            lifecycle_min_submit_interval_s=num("CCFD_LIFECYCLE_MIN_SUBMIT_INTERVAL_S",
                                                "lifecycle_min_submit_interval_s"),
            replay_enabled=_flag(e.get("CCFD_REPLAY", "0")),
            replay_batch=num("CCFD_REPLAY_BATCH", "replay_batch", int),
            replay_timeout_s=num("CCFD_REPLAY_TIMEOUT_S", "replay_timeout_s"),
            replay_retries=num("CCFD_REPLAY_RETRIES", "replay_retries", int),
            replay_bulk_ceiling=num("CCFD_REPLAY_BULK_CEILING", "replay_bulk_ceiling"),
            replay_pacing_rows_s=num("CCFD_REPLAY_PACING", "replay_pacing_rows_s"),
            replay_dir=e.get("CCFD_REPLAY_DIR", Config.replay_dir),
            host_tier_rows=num("CCFD_HOST_TIER_ROWS", "host_tier_rows", int),
            inline_rows=int(e.get("CCFD_INLINE_ROWS", "").strip() or Config.inline_rows),
        )

    def watchdog_deadline_ms(self, on_card: bool) -> float:
        """The router's dispatch watchdog deadline: CCFD_OVERLOAD_DISPATCH_
        DEADLINE_MS when set (>= 0); else CCFD_DISPATCH_DEADLINE_MS when set
        (>= 0); else (unset or -1), as the reference's auto, SELDON_TIMEOUT
        when the router scores on the card and off on the CPU."""
        if self.overload_dispatch_deadline_ms >= 0:
            return self.overload_dispatch_deadline_ms
        if self.dispatch_deadline_ms is not None and self.dispatch_deadline_ms >= 0:
            return self.dispatch_deadline_ms
        return float(self.seldon_timeout_ms) if on_card else 0.0

    def scorer_dispatch_deadline_ms(self, on_card: bool) -> float:
        """What ``Scorer(dispatch_deadline_ms=)`` takes: 0 (off) when unset;
        auto (< 0) resolves to SELDON_TIMEOUT on the card and off on the
        CPU; else the value."""
        ms = self.dispatch_deadline_ms
        if ms is None:
            return 0.0
        if ms < 0:
            return float(self.seldon_timeout_ms) if on_card else 0.0
        return float(ms)

    def parsed_retention_overrides(self) -> dict[str, int | None]:
        """``"topic:cap,topic2:0"`` -> {topic: cap, topic2: None}, the form
        ``Broker(retention_overrides=)`` takes (0 = keep everything for
        that topic). A malformed entry raises here, at config time."""
        out: dict[str, int | None] = {}
        for item in self.bus_retention_overrides.split(","):
            item = item.strip()
            if not item:
                continue
            topic, sep, cap = item.partition(":")
            if not sep or not topic:
                raise ValueError(
                    f"CCFD_BUS_RETENTION_OVERRIDES entry {item!r}: expected topic:records")
            n = int(cap)
            out[topic] = n if n > 0 else None
        return out

    def unported(self) -> list[str]:
        """The environment variables set to select a part of the reference
        the port does not have yet (the pipeline and the roles refuse to
        start on any)."""
        out = []
        if self.host_tier_rows > 0:
            out.append("CCFD_HOST_TIER_ROWS > 0 (the Scorer's host latency tier: "
                       "requests that skip the kernel)")
        if self.inline_rows > 0:
            out.append("CCFD_INLINE_ROWS > 0 (the REST front's in-IO-thread host model: "
                       "requests that skip the kernel)")
        return out
