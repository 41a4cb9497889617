"""Configuration for the port, from the reference's environment.

Only the knobs the port reads, parsed from the same environment variables
as ccfd_tpu/config.py, with the same defaults:

    CCFD_MODEL, CCFD_DTYPE, CCFD_BATCH_SIZES            scorer
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
    KAFKA_TOPIC, CUSTOMER_NOTIFICATION_TOPIC,
    CUSTOMER_RESPONSE_TOPIC, topic (the producer's)     bus topics
    FRAUD_THRESHOLD, CCFD_RULES                         the router's rules
    CCFD_REPLY_TIMEOUT_S, CCFD_LOW_AMOUNT,
    CCFD_LOW_PROBA, CONFIDENCE_THRESHOLD                the fraud process
    CCFD_LABELS_TOPIC                                   resolved-case labels
    CCFD_FUSED_DECISION, CCFD_FUSED_DECISION_STRICT     the decision plane

Knobs that select a part of the reference this port does not have yet are
read too, so that setting one is refused by name rather than ignored
(``unported``): the durable bus log (CCFD_BUS_DIR), bus retention
(CCFD_BUS_RETENTION_RECORDS, CCFD_BUS_RETENTION_OVERRIDES), a remote bus or
Kafka (BROKER_URL, bootstrap), the engine's audit stream (CCFD_AUDIT_TOPIC)
and the object-store source of the producer (s3endpoint).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Sequence


def _flag(value: str) -> bool:
    return value.strip().lower() in ("1", "true", "yes", "on")


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
    # --- bus / topics (reference router.yaml:54-62) ---
    kafka_topic: str = "odh-demo"
    customer_notification_topic: str = "ccd-customer-outgoing"
    customer_response_topic: str = "ccd-customer-response"
    producer_topic: str = "odh-demo"
    labels_topic: str = "ccd-labels"
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
    # --- parts of the reference not ported yet: set, they are refused ---
    broker_url: str = "inproc://local"
    bus_log_dir: str = ""
    bus_retention_records: int = 0
    bus_retention_overrides: str = ""
    bootstrap: str = "odh-message-bus-kafka-brokers:9092"
    audit_topic: str = ""
    s3_endpoint: str = ""

    @staticmethod
    def from_env(env: Mapping[str, str] | None = None) -> "Config":
        e = dict(os.environ if env is None else env)
        sizes = e.get("CCFD_BATCH_SIZES", "")
        return Config(
            seldon_token=e.get("SELDON_TOKEN", Config.seldon_token),
            model_name=e.get("CCFD_MODEL", Config.model_name),
            compute_dtype=e.get("CCFD_DTYPE", Config.compute_dtype),
            batch_sizes=tuple(int(s) for s in sizes.split(",")) if sizes else Config.batch_sizes,
            # as the reference: any value but "f32" keeps the int8 wire
            q8_wire="f32" if e.get("CCFD_Q8_WIRE", "int8") == "f32" else "int8",
            batch_deadline_ms=float(
                e.get("CCFD_BATCH_DEADLINE_MS", str(Config.batch_deadline_ms))
            ),
            batch_workers=int(
                e.get("CCFD_BATCH_WORKERS", str(Config.batch_workers))
            ),
            dynamic_batching=e.get("CCFD_DYNAMIC_BATCHING", "1").strip().lower()
            not in ("0", "false", "no", "off"),
            serve_host=e.get("CCFD_SERVE_HOST", Config.serve_host),
            serve_port=int(e.get("CCFD_SERVE_PORT", str(Config.serve_port))),
            kafka_topic=e.get("KAFKA_TOPIC", Config.kafka_topic),
            customer_notification_topic=e.get(
                "CUSTOMER_NOTIFICATION_TOPIC", Config.customer_notification_topic),
            customer_response_topic=e.get(
                "CUSTOMER_RESPONSE_TOPIC", Config.customer_response_topic),
            producer_topic=e.get("topic", Config.producer_topic),
            labels_topic=e.get("CCFD_LABELS_TOPIC", Config.labels_topic),
            fraud_threshold=float(e.get("FRAUD_THRESHOLD", str(Config.fraud_threshold))),
            rules_file=e.get("CCFD_RULES", Config.rules_file),
            confidence_threshold=float(
                e.get("CONFIDENCE_THRESHOLD", str(Config.confidence_threshold))),
            customer_reply_timeout_s=float(
                e.get("CCFD_REPLY_TIMEOUT_S", str(Config.customer_reply_timeout_s))),
            low_amount_threshold=float(
                e.get("CCFD_LOW_AMOUNT", str(Config.low_amount_threshold))),
            low_proba_threshold=float(
                e.get("CCFD_LOW_PROBA", str(Config.low_proba_threshold))),
            fused_decision=_flag(e.get("CCFD_FUSED_DECISION", "0")),
            fused_decision_strict=_flag(e.get("CCFD_FUSED_DECISION_STRICT", "0")),
            broker_url=e.get("BROKER_URL", Config.broker_url),
            bus_log_dir=e.get("CCFD_BUS_DIR", Config.bus_log_dir),
            bus_retention_records=int(
                e.get("CCFD_BUS_RETENTION_RECORDS", Config.bus_retention_records)),
            bus_retention_overrides=e.get(
                "CCFD_BUS_RETENTION_OVERRIDES", Config.bus_retention_overrides),
            bootstrap=e.get("bootstrap", Config.bootstrap),
            audit_topic=e.get("CCFD_AUDIT_TOPIC", Config.audit_topic),
            s3_endpoint=e.get("s3endpoint", Config.s3_endpoint),
        )

    def unported(self) -> list[str]:
        """The environment variables set to select a part of the reference
        the port does not have yet (the pipeline refuses to start on any)."""
        out = []
        if self.bus_log_dir:
            out.append("CCFD_BUS_DIR (the durable bus log)")
        if self.bus_retention_records or self.bus_retention_overrides:
            out.append("CCFD_BUS_RETENTION_RECORDS/_OVERRIDES (bus retention)")
        if self.broker_url != Config.broker_url:
            out.append("BROKER_URL (a remote bus)")
        if self.bootstrap != Config.bootstrap:
            out.append("bootstrap (the Kafka adapter)")
        if self.audit_topic:
            out.append("CCFD_AUDIT_TOPIC (the engine's audit stream)")
        if self.s3_endpoint:
            out.append("s3endpoint (the producer's object-store source)")
        return out
