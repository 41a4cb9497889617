"""The fraud and standard business processes.

The port's copy of ccfd_tpu/process/fraud.py:

fraud process:
  start -> CustomerNotification (emit to ccd-customer-outgoing)
        -> wait: customer-response signal  vs  no-reply timer
  signal(approved=True)  -> transaction approved   [fraud_approved_amount]
  signal(approved=False) -> transaction cancelled  [fraud_rejected_amount]
  timer -> DMN decision over (amount, fraud probability):
      low amount AND low probability -> auto-approve [fraud_approved_low_amount]
      else -> investigation user task [fraud_investigation_amount]
              (the prediction service may auto-complete it)
      task outcome is_fraud=True  -> cancelled [fraud_rejected_amount]
      task outcome is_fraud=False -> approved  [fraud_approved_amount]

standard process: approve immediately.

The four amount histograms are the KIE metrics contract. A resolution with
a ground-truth label (approve: 0, cancel: 1) is published on the labels
topic, as the reference does for its online retrainer. With
CCFD_AUDIT_TOPIC set, the engine's audit stream goes onto that topic, keyed
by pid. Not ported yet: the trace headers on the notification record.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import AMOUNT_BUCKETS, Registry
from ccfd_tpu_torch.process.clock import Clock
from ccfd_tpu_torch.process.dmn import DecisionTable, Rule
from ccfd_tpu_torch.process.engine import (
    EndNode,
    Engine,
    EventNode,
    GatewayNode,
    Instance,
    ProcessDefinition,
    ServiceNode,
    UserTaskNode,
)

if TYPE_CHECKING:  # pragma: no cover
    from ccfd_tpu_torch.bus.broker import Broker

FRAUD_PROCESS = "fraud"
STANDARD_PROCESS = "standard"
CUSTOMER_RESPONSE_SIGNAL = "customer-response"


def build_engine(
    cfg: Config,
    broker: "Broker",
    registry: Registry | None = None,
    clock: Clock | None = None,
    prediction_service=None,
    task_listener=None,
) -> Engine:
    registry = registry or Registry()
    # CCFD_AUDIT_TOPIC turns the engine's audit stream onto the bus on
    audit_sink = None
    if cfg.audit_topic:
        # keyed by pid: one instance's whole history lands on one partition,
        # in state-change order; ``batch`` lets the engine flush a whole
        # micro-batch of events in one produce_batch
        def audit_sink(ev):
            broker.produce(cfg.audit_topic, ev, key=ev["pid"])

        audit_sink.batch = lambda evs: broker.produce_batch(
            cfg.audit_topic, evs, keys=[e["pid"] for e in evs])
    engine = Engine(
        clock=clock,
        registry=registry,
        prediction_service=prediction_service,
        confidence_threshold=cfg.confidence_threshold,
        task_listener=task_listener,
        audit_sink=audit_sink,
    )

    h_invest = registry.histogram(
        "fraud_investigation_amount", "amounts sent to investigation", AMOUNT_BUCKETS)
    h_low = registry.histogram(
        "fraud_approved_low_amount", "amounts auto-approved by DMN", AMOUNT_BUCKETS)
    h_approved = registry.histogram(
        "fraud_approved_amount", "amounts approved", AMOUNT_BUCKETS)
    h_rejected = registry.histogram(
        "fraud_rejected_amount", "amounts rejected/cancelled", AMOUNT_BUCKETS)

    # DMN: accept vs investigate by amount + model probability
    triage = DecisionTable(
        name="fraud-triage",
        rules=[
            Rule(
                when={
                    "amount": ("<", cfg.low_amount_threshold),
                    "proba": ("<", cfg.low_proba_threshold),
                },
                then="auto_approve_low",
            )
        ],
        default="open_investigation",
    )

    def amount_of(inst: Instance) -> float:
        return float(inst.vars.get("transaction", {}).get("Amount", 0.0))

    def notify(engine_: Engine, inst: Instance) -> None:
        # process starts run on the router's (or the engine server's) traced
        # thread: the record inherits that trace, so notify's reply leg
        # stays on it; outside any span no header is stamped
        from ccfd_tpu_torch.observability.trace import inject_headers

        broker.produce(
            cfg.customer_notification_topic,
            {
                "process_id": inst.pid,
                "customer_id": inst.vars.get(
                    "customer_id", inst.vars.get("transaction", {}).get("id")),
                "transaction": inst.vars.get("transaction", {}),
            },
            key=inst.pid,
            headers=inject_headers() or None,
        )

    def on_reply(engine_: Engine, inst: Instance) -> str:
        payload = inst.vars.get("signal_payload") or {}
        return "approve" if payload.get("approved") else "cancel"

    def dmn_choose(engine_: Engine, inst: Instance) -> str:
        return triage.evaluate(
            {"amount": amount_of(inst), "proba": float(inst.vars.get("proba", 1.0))})

    def task_outcome(engine_: Engine, inst: Instance) -> str:
        return "cancel" if inst.vars.get("task_outcome") else "approve"

    def record(hist, label: int | None = None):
        """Observe the KIE amount histogram and, when the resolution carries
        a ground-truth fraud label, publish it on the labels topic."""

        def fn(engine_: Engine, inst: Instance) -> None:
            hist.observe(amount_of(inst))
            inst.vars["resolution"] = hist.name
            if label is not None:
                broker.produce(
                    cfg.labels_topic,
                    {
                        "transaction": inst.vars.get("transaction", {}),
                        "label": label,
                        "process_id": inst.pid,
                        "source": hist.name,
                    },
                    key=inst.pid,
                )

        return fn

    fraud = ProcessDefinition(
        id=FRAUD_PROCESS,
        start="notify",
        nodes={
            "notify": ServiceNode("notify", notify, next="await_reply"),
            "await_reply": EventNode(
                "await_reply",
                signal=CUSTOMER_RESPONSE_SIGNAL,
                timeout_s=cfg.customer_reply_timeout_s,
                on_signal="reply_gateway",
                on_timeout="dmn",
            ),
            "reply_gateway": GatewayNode("reply_gateway", on_reply),
            "dmn": GatewayNode("dmn", dmn_choose),
            "auto_approve_low": ServiceNode(
                "auto_approve_low", record(h_low), next="end_approved"),
            "open_investigation": ServiceNode(
                "open_investigation", record(h_invest), next="investigate"),
            "investigate": UserTaskNode(
                "investigate", task_name="fraud-investigation", next="outcome_gateway"),
            "outcome_gateway": GatewayNode("outcome_gateway", task_outcome),
            "approve": ServiceNode(
                "approve", record(h_approved, label=0), next="end_approved"),
            "cancel": ServiceNode(
                "cancel", record(h_rejected, label=1), next="end_cancelled"),
            "end_approved": EndNode("end_approved", status="completed"),
            "end_cancelled": EndNode("end_cancelled", status="cancelled"),
        },
    )

    standard = ProcessDefinition(
        id=STANDARD_PROCESS,
        start="approve",
        nodes={
            "approve": ServiceNode(
                "approve", lambda e, i: i.vars.__setitem__("resolution", "approved"),
                next="end"),
            "end": EndNode("end"),
        },
    )

    engine.register(fraud)
    engine.register(standard)
    return engine
