"""Transaction producer: dataset -> bus topic (the reference's Kafka producer).

The port's copy of ccfd_tpu/producer/producer.py. The reference streams
``creditcard.csv`` rows to topic ``odh-demo``; here the source is a
``Dataset`` (the caller's, else the CSV at CCFD_CSV or the synthetic
stream) and the sink is the bus. An optional rate limit emulates live
traffic. With a tracer each produced batch opens a root span
(``producer.batch``; ``producer.produce`` a record when paced) whose
context rides the records as a ``traceparent`` header: the head of the
trace the router, engine and notify resume. The object-store source
(``s3endpoint``) is not ported yet.
"""

from __future__ import annotations

import time

from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import Dataset, iter_transactions, load_dataset
from ccfd_tpu_torch.metrics.prom import Registry


class Producer:
    def __init__(self, cfg: Config, broker: Broker, dataset: Dataset | None = None,
                 registry: Registry | None = None, tracer=None):
        self.cfg = cfg
        self.broker = broker
        self.tracer = tracer
        if dataset is None and cfg.s3_endpoint:
            raise NotImplementedError(
                "s3endpoint is set: the producer's object-store source is not ported yet")
        self.dataset = dataset if dataset is not None else load_dataset()
        self.registry = registry or Registry()
        self._c_rows = self.registry.counter("producer_rows_total", "rows produced")

    def run(self, limit: int | None = None, rate_per_s: float | None = None,
            wire_format: str = "dict") -> int:
        """Stream rows to the producer topic; returns the number produced.

        ``rate_per_s`` paces emission; None streams as fast as the bus
        accepts, in batches of 1,000. ``wire_format="csv"`` emits raw CSV
        byte rows (the creditcard.csv line format, keyed by row index);
        ``"dict"`` emits parsed transactions keyed by their ``id``."""
        if wire_format == "csv":
            X = self.dataset.X
            payloads = ((",".join(repr(float(v)) for v in X[i]).encode(), i)
                        for i in range(X.shape[0]))
        elif wire_format == "dict":
            payloads = ((tx, tx["id"]) for tx in iter_transactions(self.dataset))
        else:
            raise ValueError(f"wire_format must be 'dict' or 'csv', not {wire_format!r}")

        produced = 0
        interval = 1.0 / rate_per_s if rate_per_s else 0.0
        if not interval:
            chunk_v: list = []
            chunk_k: list = []
            for value, key in payloads:
                if limit is not None and produced + len(chunk_v) >= limit:
                    break
                chunk_v.append(value)
                chunk_k.append(key)
                if len(chunk_v) >= 1000:
                    produced += self._produce_chunk(chunk_v, chunk_k)
                    chunk_v, chunk_k = [], []
            if chunk_v:
                produced += self._produce_chunk(chunk_v, chunk_k)
            return produced
        next_emit = time.perf_counter()
        for value, key in payloads:
            if limit is not None and produced >= limit:
                break
            now = time.perf_counter()
            if now < next_emit:
                time.sleep(next_emit - now)
            next_emit += interval
            # the producer's own `topic` variable names the sink topic
            if self.tracer is not None:
                from ccfd_tpu_torch.observability.trace import inject_headers

                with self.tracer.span("producer.produce"):
                    self.broker.produce(self.cfg.producer_topic, value, key=key,
                                        headers=inject_headers())
            else:
                self.broker.produce(self.cfg.producer_topic, value, key=key)
            self._c_rows.inc()
            produced += 1
        return produced

    def _produce_chunk(self, values: list, keys: list) -> int:
        """One batched produce; traced, one root span whose context stamps
        every record of the batch."""
        if self.tracer is None:
            n = self.broker.produce_batch(self.cfg.producer_topic, values, keys)
        else:
            from ccfd_tpu_torch.observability.trace import inject_headers

            with self.tracer.span("producer.batch", attrs={"rows": len(values)}):
                n = self.broker.produce_batch(self.cfg.producer_topic, values, keys,
                                              headers=inject_headers())
        self._c_rows.inc(len(values))
        return n
