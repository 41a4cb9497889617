"""Real-cluster adapter: the port's Broker/Consumer surface over
``kafka-python``.

The port's copy of ccfd_tpu/bus/kafka_adapter.py. The reference's transport
is a 3-broker Kafka cluster reached by a bootstrap string; every role here
is written against the Kafka-shaped API of ``bus.broker.Broker``, and
``BROKER_URL=kafka://bootstrap:9092`` swaps a real cluster in
(``bus/client.py::broker_from_url``).

Wire format: values and keys ride Kafka as UTF-8 JSON of the bus wire form
(``encode_value``: bytes payloads ride base64, so CSV lines stay
byte-exact end to end), the reference's bytes exactly, so a port role and
a reference role share one cluster.

Delivery mirrors the in-process ``Consumer``: the adapter's consumer polls
with ``enable_auto_commit=False`` and commits synchronously inside each
non-empty poll (at-most-once hand-off); ``auto_commit=False`` leaves the
commit to :meth:`KafkaConsumerAdapter.commit` (at-least-once).

``kafka-python`` is not a dependency: without it, construction raises the
reference's ``RuntimeError``. The ``kafka_module`` seam runs the whole
adapter against anything with the kafka-python surface (the reference's
test double, ``tests/fake_kafka.py``). One repair against the reference:
an explicit-offset ``commit`` builds its ``TopicPartition`` and
``OffsetAndMetadata`` from that module, where the reference's imports
``kafka.structs`` whatever module it was given.
"""

from __future__ import annotations

import importlib
import json
import time
from typing import Any, Iterable

from ccfd_tpu_torch.bus.broker import Record, StaleEpochError
from ccfd_tpu_torch.bus.server import decode_value, encode_value


def _dumps(v: Any) -> bytes | None:
    if v is None:
        return None
    return json.dumps(encode_value(v), separators=(",", ":")).encode()


def _loads(b: bytes | None) -> Any:
    if b is None:
        return None
    return decode_value(json.loads(b.decode()))


def _wire_headers(headers: dict) -> list[tuple[str, bytes]]:
    """Framework headers dict -> kafka-python record headers."""
    return [(str(k), str(v).encode()) for k, v in headers.items()]


def _unwire_headers(raw) -> dict | None:
    """kafka-python record headers -> framework dict (None when absent)."""
    if not raw:
        return None
    out = {}
    for k, v in raw:
        out[str(k)] = v.decode("utf-8", "replace") if isinstance(v, bytes) else v
    return out


class KafkaAdapter:
    """``bus.broker.Broker`` surface backed by a real Kafka cluster.

    Parameters
    ----------
    bootstrap: broker bootstrap string, e.g. ``host:9092``.
    default_partitions: partition count for topics this adapter creates
        (the reference cluster's 3).
    kafka_module: dependency seam — anything exposing the kafka-python
        surface (KafkaProducer/KafkaConsumer/TopicPartition, .admin,
        .errors). Defaults to ``import kafka``.
    """

    def __init__(
        self,
        bootstrap: str,
        default_partitions: int = 3,
        kafka_module: Any = None,
        timeout_s: float = 30.0,
        registry: Any = None,
    ):
        if kafka_module is None:
            try:
                kafka_module = importlib.import_module("kafka")
            except ImportError as e:
                raise RuntimeError(
                    "kafka-python is not installed; use the in-process Broker "
                    "(BROKER_URL=inproc://) or the networked bus server "
                    "(BROKER_URL=http://host:9092)"
                ) from e
        self._kafka = kafka_module
        self.bootstrap = bootstrap
        self._default_partitions = default_partitions
        self._timeout_s = timeout_s
        self._producer = kafka_module.KafkaProducer(
            bootstrap_servers=bootstrap,
            value_serializer=_dumps,
            key_serializer=_dumps,
        )
        self._meta_consumer = None  # lazy: only needed for end_offsets
        self._admin = None  # lazy: only needed for create_topic
        self._group_admins: dict[str, Any] = {}  # offset-admin consumers
        # adapter-side health series for the KafkaCluster board (broker
        # internals come from the JMX exporter; the adapter contributes its
        # own produce/send-failure view of cluster health)
        self._c_produced = self._c_send_errors = None
        if registry is not None:
            self._c_produced = registry.counter(
                "kafka_adapter_records_produced_total",
                "records acknowledged by the cluster",
            )
            self._c_send_errors = registry.counter(
                "kafka_adapter_send_errors_total",
                "sends that failed or timed out",
            )

    # -- admin ------------------------------------------------------------
    def create_topic(self, name: str, n_partitions: int | None = None) -> None:
        admin_mod = importlib.import_module(
            self._kafka.__name__ + ".admin"
        ) if not hasattr(self._kafka, "admin") else self._kafka.admin
        errors_mod = importlib.import_module(
            self._kafka.__name__ + ".errors"
        ) if not hasattr(self._kafka, "errors") else self._kafka.errors
        if self._admin is None:
            self._admin = admin_mod.KafkaAdminClient(bootstrap_servers=self.bootstrap)
        topic = admin_mod.NewTopic(
            name=name,
            num_partitions=n_partitions or self._default_partitions,
            replication_factor=1,
        )
        try:
            self._admin.create_topics([topic])
        except errors_mod.TopicAlreadyExistsError:
            pass

    def end_offsets(self, topic: str) -> list[int]:
        if self._meta_consumer is None:
            self._meta_consumer = self._kafka.KafkaConsumer(
                bootstrap_servers=self.bootstrap
            )
        parts = self._meta_consumer.partitions_for_topic(topic)
        if not parts:
            return []
        tps = [self._kafka.TopicPartition(topic, p) for p in sorted(parts)]
        eo = self._meta_consumer.end_offsets(tps)
        return [eo[tp] for tp in tps]

    def beginning_offsets(self, topic: str) -> list[int]:
        """Per-partition log-start (rises as the cluster's retention
        deletes segments) — Broker/RemoteBroker surface parity."""
        if self._meta_consumer is None:
            self._meta_consumer = self._kafka.KafkaConsumer(
                bootstrap_servers=self.bootstrap
            )
        parts = self._meta_consumer.partitions_for_topic(topic)
        if not parts:
            return []
        tps = [self._kafka.TopicPartition(topic, p) for p in sorted(parts)]
        bo = self._meta_consumer.beginning_offsets(tps)
        return [bo[tp] for tp in tps]

    # -- offset admin (Broker parity) --------------------------------------
    def _group_admin(self, group_id: str):
        """Cached group-scoped consumer for offset admin: paying consumer
        construction and coordinator discovery per call would make every
        describe slow."""
        c = self._group_admins.get(group_id)
        if c is None:
            c = self._kafka.KafkaConsumer(
                bootstrap_servers=self.bootstrap, group_id=group_id,
                enable_auto_commit=False,
            )
            self._group_admins[group_id] = c
        return c

    def _partition_count(self, topic: str) -> int:
        if self._meta_consumer is None:
            self._meta_consumer = self._kafka.KafkaConsumer(
                bootstrap_servers=self.bootstrap
            )
        parts = self._meta_consumer.partitions_for_topic(topic)
        return len(parts or ())

    def committed_offsets(self, group_id: str, topic: str) -> list[int]:
        """Committed offset per partition for a consumer group — the
        ``kafka-consumer-groups --describe`` analog, same surface as
        ``Broker.committed_offsets``. Never-committed partitions read as
        0."""
        c = self._group_admin(group_id)
        return [
            int(c.committed(self._kafka.TopicPartition(topic, p)) or 0)
            for p in range(self._partition_count(topic))
        ]

    def reset_offsets(self, group_id: str, topic: str,
                      offsets: list[int]) -> None:
        """Rewind (or advance) a group's commits — Kafka's
        ``kafka-consumer-groups --reset-offsets --to-offset`` analog,
        same surface as ``Broker.reset_offsets``. Kafka's own contract
        applies: the group must have no ACTIVE members (the CLI tool
        refuses too); a merely-paused consumer loop does NOT satisfy
        this, since kafka-python heartbeats keep parked consumers as live
        members. Out-of-range values clamp to the log end."""
        ends = self.end_offsets(topic)
        if len(offsets) != len(ends):
            raise ValueError(
                f"{topic!r} has {len(ends)} partitions, "
                f"got {len(offsets)} offsets"
            )
        om_cls = getattr(self._kafka, "OffsetAndMetadata", None)
        c = self._group_admin(group_id)
        commit_map = {}
        for p, off in enumerate(offsets):
            off = max(0, min(int(off), ends[p]))
            tp = self._kafka.TopicPartition(topic, p)
            if om_cls is None:
                commit_map[tp] = off
            else:
                try:
                    commit_map[tp] = om_cls(off, None)
                except TypeError:  # kafka-python >= 2.2 adds leader_epoch
                    commit_map[tp] = om_cls(off, None, -1)
        c.commit(commit_map)

    # -- produce ----------------------------------------------------------
    def produce(self, topic: str, value: Any, key: Any = None,
                partition: int | None = None,
                headers: dict | None = None) -> dict[str, Any]:
        """``partition`` overrides key routing (Kafka's explicit-partition
        mode), the same surface as ``Broker.produce``. ``headers``
        map to real Kafka record headers (list of (str, bytes)) — trace
        context survives the real-cluster transport too."""
        kw: dict[str, Any] = {}
        if partition is not None:
            kw["partition"] = partition
        if headers:
            kw["headers"] = _wire_headers(headers)
        fut = self._producer.send(topic, value=value, key=key, **kw)
        try:
            md = fut.get(timeout=self._timeout_s)
        except Exception:
            if self._c_send_errors is not None:
                self._c_send_errors.inc()
            raise
        if self._c_produced is not None:
            self._c_produced.inc()
        return {"topic": md.topic, "partition": md.partition, "offset": md.offset}

    def produce_batch(
        self, topic: str, values: Iterable[Any],
        keys: Iterable[Any] | None = None,
        headers: dict | None = None,
    ) -> int:
        """Pipelined sends + one flush (the producer's hot path). A send
        error fails the call after the flush resolves every in-flight
        future. Unlike the in-process broker's prefix-committed batches,
        per-record futures across partitions land in any order: an
        ARBITRARY SUBSET may be acknowledged before the call raises —
        only the counters are per-record."""
        values = list(values)
        key_list = list(keys) if keys is not None else [None] * len(values)
        if len(key_list) != len(values):
            raise ValueError("keys and values must have equal length")
        kw = {"headers": _wire_headers(headers)} if headers else {}
        futures = [
            self._producer.send(topic, value=v, key=k, **kw)
            for v, k in zip(values, key_list)
        ]
        self._producer.flush(timeout=self._timeout_s)
        # per-record accounting even on partial failure: futures that the
        # cluster acknowledged count as produced (their records ARE in the
        # log, visible to consumers — which records that is depends on
        # partition ordering, not input order), each failed future counts
        # one error, and the call still fails afterward
        n_ok = 0
        first_err: Exception | None = None
        for f in futures:
            try:
                f.get(timeout=self._timeout_s)
                n_ok += 1
            except Exception as e:  # noqa: BLE001 - re-raised below
                if self._c_send_errors is not None:
                    self._c_send_errors.inc()
                if first_err is None:
                    first_err = e
        if self._c_produced is not None and n_ok:
            self._c_produced.inc(n_ok)
        if first_err is not None:
            raise first_err
        return len(values)

    # -- consume ----------------------------------------------------------
    def consumer(self, group_id: str, topics: Iterable[str],
                 auto_commit: bool = True) -> "KafkaConsumerAdapter":
        """``auto_commit=False`` defers the offset commit to an explicit
        :meth:`KafkaConsumerAdapter.commit` call (at-least-once); the
        default keeps the
        historical commit-on-poll hand-off. Either way the underlying
        kafka-python consumer runs ``enable_auto_commit=False`` — the
        difference is only WHO calls commit, and when."""
        kc = self._kafka.KafkaConsumer(
            *topics,
            bootstrap_servers=self.bootstrap,
            group_id=group_id,
            enable_auto_commit=False,
            auto_offset_reset="earliest",
            value_deserializer=_loads,
            key_deserializer=_loads,
        )
        return KafkaConsumerAdapter(kc, group_id, tuple(topics), self._kafka,
                                    auto_commit=auto_commit)

    def close(self) -> None:
        self._producer.close()
        if self._meta_consumer is not None:
            self._meta_consumer.close()
        if self._admin is not None:
            self._admin.close()
        for c in self._group_admins.values():
            c.close()
        self._group_admins.clear()


class KafkaConsumerAdapter:
    """``bus.broker.Consumer`` surface over a kafka-python KafkaConsumer.

    Commit discipline mirrors the in-process Consumer (bus/broker.py:
    "auto-commit on poll", at-most-once hand-off): the batch a poll()
    delivers is committed as part of that poll, so a successor consumer in
    the group resumes AFTER it — a crash mid-handling drops that batch
    rather than redelivering it, identically on both transports.
    """

    def __init__(self, kc: Any, group_id: str, topics: tuple[str, ...],
                 kafka_module: Any, auto_commit: bool = True):
        self._kc = kc
        self._kafka = kafka_module
        self.group_id = group_id
        self.topics = topics
        self._closed = False
        self._auto_commit = auto_commit

    def poll(self, max_records: int = 500, timeout_s: float = 0.0) -> list[Record]:
        if self._closed:
            return []
        by_tp = self._kc.poll(
            timeout_ms=max(0, int(timeout_s * 1000)), max_records=max_records
        )
        out: list[Record] = []
        for tp, recs in sorted(by_tp.items(), key=lambda kv: (kv[0].topic, kv[0].partition)):
            for r in recs:
                out.append(
                    Record(
                        topic=r.topic,
                        partition=r.partition,
                        offset=r.offset,
                        key=r.key,
                        value=r.value,
                        # kafka timestamps are epoch-ms; bus records use
                        # epoch-s. A missing broker timestamp falls back
                        # to consume time, NOT 0: the router's decision-
                        # latency SLO observes time.time() - timestamp,
                        # and an epoch-0 stamp would poison the histogram
                        # with ~1.7e9 s "latencies"
                        # (kafka-python reports -1 for
                        # TIMESTAMP_NOT_AVAILABLE — also a fallback case)
                        timestamp=(r.timestamp / 1000.0
                                   if r.timestamp and r.timestamp > 0
                                   else time.time()),
                        headers=_unwire_headers(
                            getattr(r, "headers", None)),
                    )
                )
        if out and self._auto_commit:
            self._kc.commit()
        return out

    def assignment(self) -> list[tuple[str, int]]:
        """Currently owned (topic, partition) pairs."""
        return sorted((tp.topic, tp.partition)
                      for tp in (self._kc.assignment() or ()))

    def commit(self, offsets: Any = None, epoch: Any = None
               ) -> dict[tuple[str, int], int]:
        """Manual commit (``auto_commit=False`` mode). Kafka's own group
        generation is the epoch fence on this transport: a commit from a
        member fenced by a rebalance raises CommitFailedError, surfaced
        as the same :class:`~ccfd_tpu_torch.bus.broker.StaleEpochError`
        the in-process and HTTP transports raise. ``offsets`` maps
        ``{(topic, partition): next_offset}``; ``None`` commits the
        consumed positions. ``epoch`` is accepted for surface parity and
        ignored — the broker's generation check is authoritative here."""
        kw = {}
        if offsets is not None:
            kafka = self._kafka
            kw["offsets"] = {
                kafka.TopicPartition(t, int(p)): kafka.OffsetAndMetadata(int(off), None)
                for (t, p), off in offsets.items()
            }
        try:
            self._kc.commit(**kw)
        except Exception as e:  # kafka.errors.CommitFailedError et al.
            if type(e).__name__ in ("CommitFailedError",
                                    "RebalanceInProgressError",
                                    "IllegalGenerationError"):
                raise StaleEpochError(self.group_id, -1, -1, str(e)) from e
            raise
        return dict(offsets or {})

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._kc.close()

    def __enter__(self) -> "KafkaConsumerAdapter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
