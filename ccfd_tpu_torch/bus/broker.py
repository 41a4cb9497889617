"""In-process message bus with Kafka-shaped semantics.

The port's copy of the in-memory part of ccfd_tpu/bus/broker.py: the
reference's transport is a Kafka cluster with the topics ``odh-demo``,
``ccd-customer-outgoing`` and ``ccd-customer-response``; this broker keeps
the same semantics in one process:

- total order *within* a partition, none across partitions;
- crc32(key) % n_partitions routing, round-robin for keyless records;
- consumer groups: each partition is owned by exactly one live member;
  offsets are committed per (group, topic, partition) and survive consumer
  close/reopen;
- manual commit (``auto_commit=False``), fenced by the group's rebalance
  epoch (``StaleEpochError``).

Records are retained for the broker's lifetime. ``bus/server.py`` serves
this broker over HTTP (``python -m ccfd_tpu_torch bus``). The durable
segment log, retention and the Kafka adapter are not ported yet
(config.Config.unported names the knobs that would select them).
"""

from __future__ import annotations

import binascii
import itertools
import threading
import time
from typing import Any, Iterable, Mapping, NamedTuple


class Record(NamedTuple):
    # Partitions store plain tuples in this field order (exact tuples are
    # untracked by the cyclic GC); polls hand out Record views.
    topic: str
    partition: int
    offset: int
    key: Any
    value: Any
    timestamp: float
    headers: Any = None


class StaleEpochError(RuntimeError):
    """A manual commit was fenced: it carried a group epoch older than the
    group's current rebalance epoch, or named a partition the committer no
    longer owns (Kafka's ``CommitFailedError`` after a generation change)."""

    def __init__(self, group_id: str, epoch: int, current_epoch: int,
                 detail: str = ""):
        msg = (f"stale epoch {epoch} for group {group_id!r} "
               f"(current {current_epoch})")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.group_id = group_id
        self.epoch = epoch
        self.current_epoch = current_epoch


class _Topic:
    def __init__(self, name: str, n_partitions: int):
        self.name = name
        self.partitions: list[list[tuple]] = [[] for _ in range(n_partitions)]
        self._rr = itertools.count()

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def route(self, key: Any) -> int:
        if key is None:
            return next(self._rr) % self.n_partitions
        # stable across processes (str hash is salted per process)
        data = key if isinstance(key, bytes) else str(key).encode()
        return binascii.crc32(data) % self.n_partitions


class Broker:
    """Thread-safe in-process broker. One instance == one cluster."""

    def __init__(self, default_partitions: int = 3):
        self._default_partitions = default_partitions
        self._topics: dict[str, _Topic] = {}
        self._groups: dict[str, dict[tuple[str, int], int]] = {}  # group -> {(t,p): offset}
        self._members: dict[str, list["Consumer"]] = {}
        # group -> rebalance epoch (Kafka's group generation), bumped on
        # every membership change
        self._group_epochs: dict[str, int] = {}
        self.fenced_commits = 0  # lifetime count of refused stale commits
        self._lock = threading.Lock()
        self._data_ready = threading.Condition(self._lock)

    # -- admin ------------------------------------------------------------
    def create_topic(self, name: str, n_partitions: int | None = None) -> None:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = _Topic(name, n_partitions or self._default_partitions)

    def _topic(self, name: str) -> _Topic:
        t = self._topics.get(name)
        if t is None:
            self._topics[name] = t = _Topic(name, self._default_partitions)
        return t

    def end_offsets(self, topic: str) -> list[int]:
        with self._lock:
            return [len(p) for p in self._topic(topic).partitions]

    def beginning_offsets(self, topic: str) -> list[int]:
        """Per-partition log-start offset: 0, since nothing is trimmed."""
        with self._lock:
            return [0] * self._topic(topic).n_partitions

    def health_snapshot(self) -> dict:
        """One locked view for the bus server's health gauges: per-topic end
        and start offsets, and per-group committed offsets, with a group
        member's assigned but never-committed partitions at the log start."""
        with self._lock:
            topics = {name: [len(p) for p in t.partitions]
                      for name, t in self._topics.items()}
            begins = {name: [0] * len(ends) for name, ends in topics.items()}
            groups = {g: dict(tps) for g, tps in self._groups.items()}
            for g, members in self._members.items():
                tps = groups.setdefault(g, {})
                for m in members:
                    for tp in m._assignment:
                        tps.setdefault(tp, 0)
        return {"topics": topics, "begins": begins, "groups": groups}

    def close(self) -> None:
        """No-op: a memory-only broker holds no files (the bus server calls
        it on stop, as it does on the reference's durable broker)."""

    # -- produce ----------------------------------------------------------
    def produce(self, topic: str, value: Any, key: Any = None,
                partition: int | None = None,
                headers: Mapping[str, str] | None = None) -> Record:
        """Append one record; ``partition`` overrides key routing."""
        with self._lock:
            t = self._topic(topic)
            if partition is None:
                part = t.route(key)
            elif not 0 <= partition < t.n_partitions:
                raise ValueError(
                    f"partition {partition} out of range for {topic!r} "
                    f"({t.n_partitions} partitions)")
            else:
                part = partition
            records = t.partitions[part]
            item = (topic, part, len(records), key, value, time.time(), headers)
            records.append(item)
            self._data_ready.notify_all()
            return Record._make(item)

    def produce_batch(self, topic: str, values: Iterable[Any],
                      keys: Iterable[Any] | None = None,
                      headers: Mapping[str, str] | None = None) -> int:
        """Append many records under one lock acquisition (the producer's
        hot path); one ``headers`` mapping stamps the whole batch."""
        values = list(values)
        key_list = list(keys) if keys is not None else [None] * len(values)
        if len(key_list) != len(values):
            raise ValueError("keys and values must have equal length")
        if not values:
            return 0
        with self._lock:
            t = self._topic(topic)
            now = time.time()
            for v, k in zip(values, key_list):
                part = t.route(k)
                records = t.partitions[part]
                records.append((topic, part, len(records), k, v, now, headers))
            self._data_ready.notify_all()
            return len(values)

    # -- consume ----------------------------------------------------------
    def consumer(self, group_id: str, topics: Iterable[str],
                 auto_commit: bool = True) -> "Consumer":
        """``auto_commit=False`` gives manual-commit (at-least-once)
        semantics: poll advances a private per-consumer position, and only
        :meth:`Consumer.commit` moves the group's committed offset."""
        with self._lock:
            for t in topics:
                self._topic(t)
            c = Consumer(self, group_id, tuple(topics), auto_commit=auto_commit)
            self._members.setdefault(group_id, []).append(c)
            self._rebalance(group_id)
            return c

    def group_epoch(self, group_id: str) -> int:
        """Current rebalance epoch for a group (0 = never had a member)."""
        with self._lock:
            return self._group_epochs.get(group_id, 0)

    def _close(self, consumer: "Consumer") -> None:
        with self._lock:
            members = self._members.get(consumer.group_id, [])
            if consumer in members:
                members.remove(consumer)
                self._rebalance(consumer.group_id)

    def _rebalance(self, group_id: str) -> None:
        """Round-robin partition assignment over live group members. Bumps
        the epoch first (a commit stamped before it is fenced) and clears
        manual consumers' private positions, so fenced records redeliver
        from the committed offset."""
        self._group_epochs[group_id] = self._group_epochs.get(group_id, 0) + 1
        epoch = self._group_epochs[group_id]
        members = self._members.get(group_id, [])
        if not members:
            return
        all_parts: list[tuple[str, int]] = []
        for tname in sorted({t for m in members for t in m.topics}):
            t = self._topic(tname)
            all_parts.extend((tname, p) for p in range(t.n_partitions))
        for m in members:
            m._assignment = []
            m.epoch = epoch
        for i, tp in enumerate(all_parts):
            owner = members[i % len(members)]
            if tp[0] in owner.topics:
                owner._assignment.append(tp)
            else:  # partition of a topic this member didn't subscribe to
                for m in members:
                    if tp[0] in m.topics:
                        m._assignment.append(tp)
                        break
        for m in members:
            if not m._auto_commit:
                m._positions.clear()

    def committed_offsets(self, group_id: str, topic: str) -> list[int]:
        """Committed offset per partition for a consumer group."""
        with self._lock:
            t = self._topic(topic)
            return [self._committed(group_id, (topic, p)) for p in range(t.n_partitions)]

    def reset_offsets(self, group_id: str, topic: str, offsets: list[int]) -> None:
        """Rewind (or advance) a group's committed offsets, clamped to the
        partition (Kafka's ``--reset-offsets --to-offset``)."""
        with self._lock:
            t = self._topic(topic)
            if len(offsets) != t.n_partitions:
                raise ValueError(
                    f"{topic!r} has {t.n_partitions} partitions, got {len(offsets)} offsets")
            g = self._groups.setdefault(group_id, {})
            for p, off in enumerate(offsets):
                g[(topic, p)] = max(0, min(int(off), len(t.partitions[p])))
            for m in self._members.get(group_id, []):
                if not m._auto_commit:
                    for p in range(t.n_partitions):
                        m._positions.pop((topic, p), None)
            self._data_ready.notify_all()

    def _committed(self, group_id: str, tp: tuple[str, int]) -> int:
        return self._groups.setdefault(group_id, {}).get(tp, 0)

    def _commit(self, group_id: str, tp: tuple[str, int], offset: int) -> None:
        g = self._groups.setdefault(group_id, {})
        if offset > g.get(tp, 0):
            g[tp] = offset

    def _consumer_commit(self, consumer: "Consumer",
                         offsets: Mapping[tuple[str, int], int] | None = None,
                         epoch: int | None = None) -> dict[tuple[str, int], int]:
        """Epoch-fenced manual commit (``Consumer.commit``). ``epoch=None``
        fences against the epoch of the consumer's last poll."""
        with self._lock:
            cur = self._group_epochs.get(consumer.group_id, 0)
            eff = consumer._poll_epoch if epoch is None else int(epoch)
            members = self._members.get(consumer.group_id, [])
            if consumer._closed or consumer not in members:
                self.fenced_commits += 1
                raise StaleEpochError(consumer.group_id, eff, cur,
                                      "consumer fenced out of the group")
            if eff != cur:
                self.fenced_commits += 1
                raise StaleEpochError(consumer.group_id, eff, cur)
            if offsets is None:
                to_commit = dict(consumer._positions)
            else:
                assigned = set(consumer._assignment)
                to_commit = {}
                for tp, off in offsets.items():
                    tp = (tp[0], int(tp[1]))
                    if tp not in assigned:
                        self.fenced_commits += 1
                        raise StaleEpochError(
                            consumer.group_id, eff, cur,
                            f"partition {tp} not assigned to committer")
                    to_commit[tp] = int(off)
            for tp, off in to_commit.items():
                self._commit(consumer.group_id, tp, off)
            return to_commit

    def _fetch(self, consumer: "Consumer", max_records: int) -> list[Record]:
        out: list[Record] = []
        consumer._poll_epoch = self._group_epochs.get(consumer.group_id, 0)
        # rotate the scan start across polls, so a loaded partition early
        # in a fixed order cannot starve the later ones
        n = len(consumer._assignment)
        first = consumer._fetch_start % n if n else 0
        for k in range(n):
            tname, p = consumer._assignment[(first + k) % n]
            if len(out) >= max_records:
                break
            tp = (tname, p)
            if consumer._auto_commit:
                start = self._committed(consumer.group_id, tp)
            else:
                start = consumer._positions.get(tp, self._committed(consumer.group_id, tp))
            take = self._topic(tname).partitions[p][start:start + max_records - len(out)]
            if take:
                out.extend(map(Record._make, take))
                if consumer._auto_commit:
                    self._commit(consumer.group_id, tp, start + len(take))
                else:
                    consumer._positions[tp] = start + len(take)
        consumer._fetch_start = first + 1
        return out


class Consumer:
    """Poll-based consumer. With ``auto_commit=True`` (default) offsets
    commit on poll; with ``auto_commit=False`` poll advances a private
    position and :meth:`commit` moves the group offset under an epoch
    fence."""

    def __init__(self, broker: Broker, group_id: str, topics: tuple[str, ...],
                 auto_commit: bool = True):
        self._broker = broker
        self.group_id = group_id
        self.topics = topics
        self._assignment: list[tuple[str, int]] = []
        self._fetch_start = 0  # rotating fetch fairness cursor (_fetch)
        self._closed = False
        self._auto_commit = auto_commit
        self._positions: dict[tuple[str, int], int] = {}
        self.epoch = 0       # group epoch stamped at the last rebalance
        self._poll_epoch = 0  # group epoch stamped at the last poll

    def assignment(self) -> list[tuple[str, int]]:
        """Currently owned (topic, partition) pairs."""
        with self._broker._lock:
            return list(self._assignment)

    def commit(self, offsets: Mapping[tuple[str, int], int] | None = None,
               epoch: int | None = None) -> dict[tuple[str, int], int]:
        """Manual commit: ``offsets=None`` commits the fetch positions, a
        mapping ``{(topic, partition): next_offset}`` exactly those. Raises
        :class:`StaleEpochError` if the group rebalanced since ``epoch``
        (default: this consumer's last poll) or a partition is not ours."""
        return self._broker._consumer_commit(self, offsets, epoch)

    def poll(self, max_records: int = 500, timeout_s: float = 0.0) -> list[Record]:
        deadline = time.monotonic() + timeout_s
        while True:
            with self._broker._lock:
                if self._closed:
                    return []
                recs = self._broker._fetch(self, max_records)
                if recs:
                    return recs
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._broker._data_ready.wait(timeout=min(remaining, 0.05))

    def close(self) -> None:
        self._closed = True
        self._broker._close(self)
