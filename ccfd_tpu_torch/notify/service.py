"""Customer-notification simulator (the reference's notification service).

The port's copy of ccfd_tpu/notify/service.py. Subscribes to
``ccd-customer-outgoing``, "sends" the customer an inquiry, decides from a
seeded generator whether the customer replies and whether they approve,
and publishes replies to ``ccd-customer-response``. No reply simulates the
silent customer, which arms the engine's DMN timer path. Deterministic in
the seed. With a tracer each handled notification resumes the trace on the
record (``notify.handle``) and stamps the reply it produces.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import numpy as np

from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry


class NotificationService:
    def __init__(self, cfg: Config, broker: Broker, registry: Registry | None = None,
                 reply_prob: float = 0.8, approve_prob: float = 0.7, seed: int = 0,
                 tracer=None):
        self.cfg = cfg
        self.broker = broker
        self.tracer = tracer
        self.registry = registry or Registry()
        self.reply_prob = reply_prob
        self.approve_prob = approve_prob
        self._rng = np.random.default_rng(seed)
        self._consumer = broker.consumer(
            "notification-service", (cfg.customer_notification_topic,))
        r = self.registry
        self._c_sent = r.counter("notifications_sent_total", "inquiries sent")
        self._c_replied = r.counter("notifications_replied_total", "replies by result")
        self._c_silent = r.counter("notifications_no_reply_total", "silent customers")
        self._stop = threading.Event()

    def step(self, max_records: int = 256, poll_timeout_s: float = 0.0) -> int:
        records = self._consumer.poll(max_records, poll_timeout_s)
        for rec in records:
            msg: dict[str, Any] = rec.value or {}
            self._c_sent.inc()
            if self._rng.random() >= self.reply_prob:
                self._c_silent.inc()
                continue  # the customer never answers: the engine's timer fires
            approved = bool(self._rng.random() < self.approve_prob)
            self._c_replied.inc(
                labels={"response": "approved" if approved else "non_approved"})
            span_cm: Any = contextlib.nullcontext()
            if self.tracer is not None:
                from ccfd_tpu_torch.observability import trace as _trace

                span_cm = self.tracer.span(
                    "notify.handle",
                    parent=_trace.extract_context(getattr(rec, "headers", None)))
            with span_cm:
                headers = _trace.inject_headers() if self.tracer is not None else None
                self.broker.produce(
                    self.cfg.customer_response_topic,
                    {"process_id": msg.get("process_id"),
                     "customer_id": msg.get("customer_id"),
                     "approved": approved},
                    key=msg.get("process_id"),
                    headers=headers or None,
                )
        return len(records)

    def run(self, poll_timeout_s: float = 0.05) -> None:
        while not self._stop.is_set():
            self.step(poll_timeout_s=poll_timeout_s)

    def start(self, poll_timeout_s: float = 0.05) -> threading.Thread:
        t = threading.Thread(target=self.run, args=(poll_timeout_s,), daemon=True,
                             name="ccfd-notify")
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.stop()
        self._consumer.close()
