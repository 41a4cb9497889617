"""In-process message bus with Kafka-shaped semantics.

The port's copy of ccfd_tpu/bus/broker.py: the reference's transport is a
Kafka cluster with the topics ``odh-demo``, ``ccd-customer-outgoing`` and
``ccd-customer-response``; this broker keeps the same semantics in one
process:

- total order *within* a partition, none across partitions;
- crc32(key) % n_partitions routing, round-robin for keyless records;
- consumer groups: each partition is owned by exactly one live member;
  offsets are committed per (group, topic, partition) and survive consumer
  close/reopen;
- manual commit (``auto_commit=False``), fenced by the group's rebalance
  epoch (``StaleEpochError``);
- with ``log_dir``, a durable segment log (``bus/log.py``): every record
  and committed offset also lands on disk, a broker reopened on the
  directory replays topics, records and group offsets, and
  ``crash_restart`` does that in place;
- retention (``retention_records``, per-topic ``retention_overrides``):
  delete-before-committed-offset, so a partition keeps a log-start offset
  (``beginning_offsets``) that retention raises and replay restores.

``bus/server.py`` serves this broker over HTTP (``python -m ccfd_tpu_torch
bus [--dir D]``); ``bus/kafka_adapter.py`` is the same surface over a real
Kafka cluster.
"""

from __future__ import annotations

import binascii
import itertools
import threading
import time
from typing import Any, Iterable, Mapping, NamedTuple


class Record(NamedTuple):
    # Partitions store plain tuples in this field order (exact tuples are
    # untracked by the cyclic GC); polls hand out Record views. ``headers``
    # (the trace context) live in memory only: the durable log does not
    # persist them.
    topic: str
    partition: int
    offset: int
    key: Any
    value: Any
    timestamp: float
    headers: Any = None


class _Partition:
    """One partition's in-memory tail: a record list plus the offset of
    its first element.

    ``offset == base + index``: retention trims the front of ``records``
    and advances ``base``, so offsets stay permanent — exactly Kafka's
    log-start-offset — while memory stays capped. Records remain plain
    6-tuples in Record field order (exact tuples untrack from gen-2 GC,
    see Record's GC note). A list with batched front-deletes beats a
    deque here: the fetch path slices hot (O(k) on a list, O(n) on a
    deque), while trims are amortized over thousands of appends."""

    __slots__ = ("base", "records")

    def __init__(self, base: int = 0):
        self.base = base
        self.records: list[tuple] = []

    @property
    def end(self) -> int:
        return self.base + len(self.records)

    def slice(self, start: int, max_n: int) -> tuple[int, list[tuple]]:
        """-> (effective start offset, records). A ``start`` below
        ``base`` reads from the earliest retained record — Kafka's
        auto.offset.reset=earliest on an out-of-range fetch."""
        eff = max(start, self.base)
        i = eff - self.base
        return eff, self.records[i:i + max_n]

    def trim_to(self, offset: int) -> int:
        """Drop records below ``offset``; returns how many were dropped."""
        n = min(max(offset - self.base, 0), len(self.records))
        if n:
            del self.records[:n]
            self.base += n
        return n


class StaleEpochError(RuntimeError):
    """A manual commit was fenced: it carried a group epoch older than the
    group's current rebalance epoch, or named a partition the committer no
    longer owns. The Kafka analog is a ``CommitFailedError`` after a
    generation change — a member whose partitions were re-assigned (death,
    join, fence) must NOT be able to move the group's committed offsets,
    or the new owner's position silently jumps past records it never saw
    (a drop) or behind records it already routed (a double-route)."""

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
    def __init__(self, name: str, n_partitions: int,
                 bases: list[int] | None = None):
        self.name = name
        self.partitions: list[_Partition] = [
            _Partition(bases[i] if bases else 0) for i in range(n_partitions)
        ]
        self._rr = itertools.count()

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def route(self, key: Any) -> int:
        if key is None:
            return next(self._rr) % self.n_partitions
        # stable across processes (Python's str hash is per-process salted;
        # a durable log replayed into a new process must keep key->partition
        # ordering, like Kafka's murmur2-on-key-bytes)
        data = key if isinstance(key, bytes) else str(key).encode()
        return binascii.crc32(data) % self.n_partitions


class Broker:
    """Thread-safe in-process broker. One instance == one cluster.

    With ``log_dir`` set, every record and committed offset also lands in
    an on-disk segment log (bus/log.py): reopening a Broker on the
    same directory replays topics, records, and group offsets, so consumers
    resume exactly where the crashed process left off — Kafka's recovery
    semantics.
    """

    def __init__(
        self,
        default_partitions: int = 3,
        log_dir: str | None = None,
        fsync: bool = False,
        retention_records: int | None = None,
        segment_bytes: int | None = None,
        retention_overrides: dict[str, int | None] | None = None,
    ):
        """``retention_records``: cap each partition's retained history.

        Kafka-shaped retention with one deliberate strengthening: a
        record is only eligible for deletion once it is BOTH older than
        the newest ``retention_records`` AND below every consumer
        group's committed offset for that partition (Kafka's time/size
        retention deletes regardless of consumers; the reference's crash
        recovery replays from committed cuts, so delete-before-committed-
        offset is the only retention that cannot break it).
        ``None`` (default) keeps the historical retain-everything
        behavior. ``segment_bytes`` sizes the on-disk rolling segments
        (bus/log.py); retention deletes whole rolled segments.

        ``retention_overrides`` is the per-topic config analog of Kafka's
        ``retention.bytes`` topic override: ``{topic: cap}`` with ``None``
        meaning retain-everything for that topic (an audit ledger and a
        high-volume data topic rarely want the same window). Also
        settable live via :meth:`set_topic_retention` (the
        ``kafka-configs --alter --topic`` analog)."""
        self._default_partitions = default_partitions
        self._topics: dict[str, _Topic] = {}
        self._groups: dict[str, dict[tuple[str, int], int]] = {}  # group -> {(t,p): offset}
        self._members: dict[str, list["Consumer"]] = {}
        # group -> rebalance epoch (Kafka's group generation): bumped on
        # EVERY membership change, including down to zero members, so a
        # commit from a member that was fenced out can never match
        self._group_epochs: dict[str, int] = {}
        self.fenced_commits = 0  # lifetime count of refused stale commits
        self._lock = threading.Lock()
        self._data_ready = threading.Condition(self._lock)
        self.retention_records = retention_records or None
        # normalize at intake: 0 and None both mean retain-everything
        # (matching the CCFD_BUS_RETENTION_* env forms), so no caller can
        # accidentally configure a cap-zero topic that trims to the
        # committed floor
        self._retention_overrides = {
            t: (cap or None) for t, cap in (retention_overrides or {}).items()
        }
        self.records_trimmed = 0   # lifetime count, for the exporters
        self.oor_resets = 0        # fetches clamped to log-start (Kafka's
        #                            auto.offset.reset=earliest analog)
        self._since_retention: dict[str, int] = {}  # topic -> appends
        self._log_dir = log_dir
        self._fsync = fsync
        self._segment_bytes = segment_bytes
        self.crash_restarts = 0
        self._log = None
        if log_dir is not None:
            self._open_and_replay_log()

    def _open_and_replay_log(self) -> None:
        """Open the segment log and replay it into (empty) in-memory state.
        Runs at construction and again inside ``crash_restart``."""
        from ccfd_tpu_torch.bus.log import BusLog, DEFAULT_SEGMENT_BYTES

        self._log = BusLog(
            self._log_dir, fsync=self._fsync,
            segment_bytes=self._segment_bytes or DEFAULT_SEGMENT_BYTES,
        )
        for name, n_parts in self._log.replay_topics().items():
            bases = []
            replays = []
            for p in range(n_parts):
                base, recs = self._log.replay_partition(name, p)
                bases.append(base)
                replays.append(recs)
            t = _Topic(name, n_parts, bases=bases)
            self._topics[name] = t
            for p, recs in enumerate(replays):
                part = t.partitions[p]
                for key, ts, value in recs:
                    part.records.append(
                        (name, p, part.end, key, value, ts, None))
        # Clamp replayed offsets to the replayed log: a torn-tail
        # truncation may have dropped records whose consumption was
        # already committed; an out-of-range offset would silently skip
        # every record produced at those slots after restart (Kafka
        # resets out-of-range offsets the same way). The low clamp is
        # the partition's log-start: retention may have deleted the
        # committed position's records.
        for g, tps in self._log.replay_offsets().items():
            mine = self._groups.setdefault(g, {})
            for (tname, p), off in tps.items():
                t = self._topics.get(tname)
                if t is None or p >= t.n_partitions:
                    continue  # topic/partition lost with the meta log
                part = t.partitions[p]
                mine[(tname, p)] = max(part.base, min(off, part.end))

    def crash_restart(self) -> dict:
        """Crash the durable broker and restart it from its own disk, IN
        PLACE, with consumers attached mid-stream.

        The analog of a Kafka broker pod dying and its replacement
        mounting the same persistent volume: every byte of
        in-memory state is dropped exactly as a process death would drop
        it, then the on-disk segment log replays back into THIS object,
        so attached components — who hold the broker reference the way
        Kafka clients hold a bootstrap address — resume against the
        restarted broker without being rebuilt. Durability analysis of
        why close-then-replay equals a crash from the disk's standpoint:
        every append was already an ``os.write`` (page cache) at produce
        time, and close adds no flush beyond that; the only write that
        happens on OPEN (offsets.log compaction) is atomic tmp+rename.

        Consumers survive because group offsets are replayed from the
        durable offsets log — a registered member keeps its assignment
        (a reconnecting client) and its next poll resumes from the
        committed position. Raises on a memory-only broker: with no log
        there is nothing to restart FROM (a real all-RAM bus crash is
        total data loss)."""
        with self._lock:
            if self._log is None:
                raise RuntimeError("memory-only broker cannot crash_restart")
            self._log.close()
            self._topics.clear()
            self._groups.clear()
            self._since_retention.clear()
            self._open_and_replay_log()
            # surviving members are clients reconnecting to the restarted
            # broker: re-register their topics and rebalance each group.
            # Manual fetch positions are dropped wholesale — a torn-tail
            # truncation may have shortened the log below a position, and
            # a stale position above the replayed end would silently skip
            # records produced at those slots after restart; resuming from
            # the (replay-clamped) committed offset is the safe cut.
            for g, members in self._members.items():
                for m in members:
                    m._positions.clear()
                    for tname in m.topics:
                        self._topic(tname)
                self._rebalance(g)
            self.crash_restarts += 1
            self._data_ready.notify_all()
            return {
                "topics": {n: [p.end for p in t.partitions]
                           for n, t in self._topics.items()},
                "groups": {g: dict(tps) for g, tps in self._groups.items()},
            }

    # -- admin ------------------------------------------------------------
    def create_topic(self, name: str, n_partitions: int | None = None) -> None:
        with self._lock:
            if name not in self._topics:
                n = n_partitions or self._default_partitions
                self._topics[name] = _Topic(name, n)
                if self._log is not None:
                    self._log.add_topic(name, n)

    def _topic(self, name: str) -> _Topic:
        t = self._topics.get(name)
        if t is None:
            self._topics[name] = t = _Topic(name, self._default_partitions)
            if self._log is not None:
                self._log.add_topic(name, t.n_partitions)
        return t

    def close(self) -> None:
        """Flush and close segment files (no-op for a memory-only broker)."""
        with self._lock:
            if self._log is not None:
                self._log.close()

    def end_offsets(self, topic: str) -> list[int]:
        with self._lock:
            return [p.end for p in self._topic(topic).partitions]

    def beginning_offsets(self, topic: str) -> list[int]:
        """Per-partition log-start offset (Kafka ``beginning_offsets``):
        0 until retention trims, then the earliest retained offset."""
        with self._lock:
            return [p.base for p in self._topic(topic).partitions]

    def health_snapshot(self) -> dict:
        """One consistent view for health/lag exporters: per-topic partition
        end offsets plus per-group committed offsets, with groups that
        registered but never committed (e.g. a consumer wedged since
        startup) seeded at the partition LOG-START over their assigned
        partitions — their lag reads as every deliverable record (the way
        Kafka reports lag against the log-start), not as a full log whose
        trimmed head could never be delivered. Retention's own floor keeps
        the stronger seed (0): an attached-but-never-committed member
        still protects its whole backlog from deletion."""
        with self._lock:
            topics = {
                name: [p.end for p in t.partitions]
                for name, t in self._topics.items()
            }
            # same locked view as the ends: a separate beginning_offsets
            # call could land after a produce+trim and publish a negative
            # retained-records gauge
            begins = {
                name: [p.base for p in t.partitions]
                for name, t in self._topics.items()
            }
            groups: dict[str, dict[tuple[str, int], int]] = {
                g: dict(tps) for g, tps in self._groups.items()
            }
            for g, members in self._members.items():
                tps = groups.setdefault(g, {})
                for m in members:
                    for tp in m._assignment:
                        tps.setdefault(
                            tp,
                            self._topics[tp[0]].partitions[tp[1]].base,
                        )
        return {"topics": topics, "begins": begins, "groups": groups}

    # -- produce ----------------------------------------------------------
    def produce(self, topic: str, value: Any, key: Any = None,
                partition: int | None = None,
                headers: Mapping[str, str] | None = None) -> Record:
        """Append one record. ``partition`` overrides key routing (the
        Kafka producer's explicit-partition mode) — control records that
        must reach EVERY partition produce once per partition with it.
        ``headers`` are Kafka-style record headers (trace context rides
        here); in-memory only, not persisted to the durable log."""
        with self._lock:
            t = self._topic(topic)
            if partition is None:
                part = t.route(key)
            else:
                if not 0 <= partition < t.n_partitions:
                    raise ValueError(
                        f"partition {partition} out of range for {topic!r} "
                        f"({t.n_partitions} partitions)"
                    )
                part = partition
            now = time.time()
            pobj = t.partitions[part]
            item = (topic, part, pobj.end, key, value, now, headers)
            if self._log is not None:
                # encode BEFORE any mutation: an unencodable record must
                # fail cleanly, not leave memory and disk diverged — and
                # the LOG write precedes the in-memory append (same
                # failure contract as produce_batch): memory must never
                # hold a record the log would lose across a restart
                from ccfd_tpu_torch.bus.log import encode_entry

                payload = encode_entry(key, now, value)
                self._log.append_payload(topic, part, payload)
            pobj.records.append(item)  # exact tuple: GC-untrackable
            self._maybe_retention(topic, t, 1)
            self._data_ready.notify_all()
            return Record._make(item)

    def produce_batch(
        self, topic: str, values: Iterable[Any],
        keys: Iterable[Any] | None = None,
        headers: Mapping[str, str] | None = None,
    ) -> int:
        """Append many records under ONE lock acquisition (the producer's
        hot path; same surface as RemoteBroker.produce_batch). One
        ``headers`` mapping stamps the WHOLE batch (the producer's trace
        context per transaction batch) — every record aliases it, so the
        cost is one dict per batch, not per record.

        Failure contract: encode errors fail the WHOLE batch before any
        state mutates (payloads are built up front). An I/O error from the
        durable log mid-batch commits the prefix 0..k-1 — to both disk and
        memory, consistently — and raises; that is the same
        prefix-committed outcome as k individual ``produce`` calls. The log
        write precedes the in-memory append per record, so memory never
        holds a record the log would lose across a restart."""
        values = list(values)
        key_list = list(keys) if keys is not None else [None] * len(values)
        if len(key_list) != len(values):
            raise ValueError("keys and values must have equal length")
        if not values:
            return 0
        with self._lock:
            t = self._topic(topic)
            now = time.time()
            payloads = None
            if self._log is not None:
                from ccfd_tpu_torch.bus.log import encode_entry

                payloads = [
                    encode_entry(k, now, v) for k, v in zip(key_list, values)
                ]
            appended = 0
            try:
                for i, (v, k) in enumerate(zip(values, key_list)):
                    part = t.route(k)
                    if payloads is not None:
                        self._log.append_payload(topic, part, payloads[i])
                    pobj = t.partitions[part]
                    pobj.records.append(
                        (topic, part, pobj.end, k, v, now, headers))
                    appended += 1
            finally:
                if appended:
                    self._maybe_retention(topic, t, appended)
                    self._data_ready.notify_all()
            return len(values)

    # -- consume ----------------------------------------------------------
    def consumer(self, group_id: str, topics: Iterable[str],
                 auto_commit: bool = True) -> "Consumer":
        """``auto_commit=False`` gives manual-commit (at-least-once)
        semantics: poll advances a private per-consumer position, and
        nothing moves the group's committed offset until
        :meth:`Consumer.commit` — which is epoch-fenced against
        rebalances (see :class:`StaleEpochError`)."""
        with self._lock:
            for t in topics:
                self._topic(t)
            c = Consumer(self, group_id, tuple(topics),
                         auto_commit=auto_commit)
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
        """Round-robin partition assignment over live group members.

        Bumps the group epoch FIRST — even when the group just lost its
        last member — so any in-flight manual commit stamped with the
        pre-rebalance epoch is fenced (StaleEpochError), Kafka's group
        generation. Manual consumers' private positions are cleared
        WHOLESALE: a batch polled under the old epoch can never commit
        (the fence), so its records must redeliver from the committed
        offset to whichever member now owns the partition — including
        the same member. Pruning to the kept assignment instead would
        silently DROP fenced in-flight records on retained partitions
        (position advanced past them, commit refused, never re-read)."""
        self._group_epochs[group_id] = (
            self._group_epochs.get(group_id, 0) + 1)
        epoch = self._group_epochs[group_id]
        members = self._members.get(group_id, [])
        if not members:
            return
        all_parts: list[tuple[str, int]] = []
        topics = sorted({t for m in members for t in m.topics})
        for tname in topics:
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
        """Committed offset per partition for a consumer group — the
        ``kafka-consumer-groups --describe`` analog."""
        with self._lock:
            t = self._topic(topic)
            return [
                self._committed(group_id, (topic, p))
                for p in range(t.n_partitions)
            ]

    def reset_offsets(self, group_id: str, topic: str,
                      offsets: list[int]) -> None:
        """Rewind (or advance) a group's committed offsets — Kafka's
        ``kafka-consumer-groups --reset-offsets --to-offset`` analog.

        Live consumers pick the change up on their next poll (every fetch
        reads the group offset; consumers hold no position of their own).
        Out-of-range values clamp to the partition log, like Kafka's
        auto.offset.reset. With a durable log the reset is recorded, so a
        broker crash-replay resumes from the reset position, not the old
        high-water mark (bus/log.py replays offsets last-wins)."""
        with self._lock:
            t = self._topic(topic)
            if len(offsets) != t.n_partitions:
                raise ValueError(
                    f"{topic!r} has {t.n_partitions} partitions, "
                    f"got {len(offsets)} offsets"
                )
            g = self._groups.setdefault(group_id, {})
            for p, off in enumerate(offsets):
                pobj = t.partitions[p]
                # clamp low to log-start: retention may have deleted the
                # requested position (Kafka resets to earliest the same
                # way). Counted: a rewind that aimed below the retained
                # log replays less than the caller asked for, and
                # operators should see that.
                if int(off) < pobj.base:
                    self.oor_resets += 1
                off = max(pobj.base, min(int(off), pobj.end))
                g[(topic, p)] = off
                if self._log is not None:
                    self._log.commit_offset(group_id, topic, p, off)
            # manual-mode consumers must see the rewind: drop their
            # private positions for this topic so the next fetch re-reads
            # from the (reset) committed offset
            for m in self._members.get(group_id, []):
                if not m._auto_commit:
                    for p in range(t.n_partitions):
                        m._positions.pop((topic, p), None)
            # rewound consumers may have records to re-read right now
            self._data_ready.notify_all()

    # -- retention --------------------------------------------------------
    def _topic_cap(self, topic: str) -> int | None:
        """Effective retained-record cap for a topic (override > default)."""
        if topic in self._retention_overrides:
            return self._retention_overrides[topic]
        return self.retention_records

    def set_topic_retention(self, topic: str, records: int | None) -> None:
        """Per-topic retention override, live (``kafka-configs --alter``
        analog): ``records`` caps the topic's partitions; ``None`` or
        ``0`` makes the topic retain-everything regardless of the broker
        default (the same sentinel the env forms use)."""
        records = records or None
        with self._lock:
            self._retention_overrides[topic] = records
            t = self._topics.get(topic)
            if t is not None and records is not None:
                self._enforce_retention_locked(topic, t)

    def _maybe_retention(self, topic: str, t: _Topic, appended: int) -> None:
        """Amortized retention check, called under the lock after appends:
        runs the real enforcement once per ~1/8th of the retention window
        of fresh records, so the trim's O(dropped) list-delete spreads over
        thousands of produce calls."""
        cap = self._topic_cap(topic)
        if cap is None:
            return
        n = self._since_retention.get(topic, 0) + appended
        if n < max(1024, cap // 8):
            self._since_retention[topic] = n
            return
        self._since_retention[topic] = 0
        self._enforce_retention_locked(topic, t)

    def enforce_retention(self, topic: str | None = None) -> int:
        """Run retention now (tests, shutdown); returns records trimmed."""
        with self._lock:
            before = self.records_trimmed
            names = [topic] if topic is not None else list(self._topics)
            for name in names:
                t = self._topics.get(name)
                if t is not None and self._topic_cap(name) is not None:
                    self._enforce_retention_locked(name, t)
            return self.records_trimmed - before

    def _enforce_retention_locked(self, tname: str, t: _Topic) -> None:
        cap = self._topic_cap(tname)
        if cap is None:
            return
        for p, pobj in enumerate(t.partitions):
            floor = pobj.end - cap
            if floor <= pobj.base:
                continue
            # delete-before-committed-offset: the trim stops at the
            # lowest committed position any group holds for this
            # partition. Members that attached but never committed hold
            # position 0 implicitly — their whole backlog is protected,
            # exactly Kafka's lag accounting (health_snapshot seeds the
            # same way). No group at all -> pure size retention.
            tp = (tname, p)
            mins = [tps[tp] for tps in self._groups.values() if tp in tps]
            for g, members in self._members.items():
                if tp not in self._groups.get(g, {}) and any(
                    tp in m._assignment for m in members
                ):
                    mins.append(0)
            committed_min = min(mins) if mins else pobj.end
            trim_to = min(committed_min, floor)
            dropped = pobj.trim_to(trim_to)
            if dropped:
                self.records_trimmed += dropped
                if self._log is not None:
                    self._log.trim_partition(tname, p, pobj.base)

    def _committed(self, group_id: str, tp: tuple[str, int]) -> int:
        return self._groups.setdefault(group_id, {}).get(tp, 0)

    def _commit(self, group_id: str, tp: tuple[str, int], offset: int) -> None:
        g = self._groups.setdefault(group_id, {})
        if offset > g.get(tp, 0):
            g[tp] = offset
            if self._log is not None:
                self._log.commit_offset(group_id, tp[0], tp[1], offset)

    def _consumer_commit(
        self, consumer: "Consumer",
        offsets: Mapping[tuple[str, int], int] | None = None,
        epoch: int | None = None,
    ) -> dict[tuple[str, int], int]:
        """Epoch-fenced manual commit (Consumer.commit body, under lock).

        ``epoch=None`` fences against the epoch stamped at the consumer's
        last poll — the epoch the records being committed were DELIVERED
        under. A rebalance between poll and commit (member death, join,
        fence) refuses the commit: the records redeliver to
        the partitions' new owners instead of being marked consumed by a
        member that no longer owns them."""
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

    def _fetch(
        self, consumer: "Consumer", max_records: int
    ) -> list[Record]:
        out: list[Record] = []
        consumer._poll_epoch = self._group_epochs.get(consumer.group_id, 0)
        # Rotate the scan start across polls (Kafka clients do the same):
        # a loaded partition early in a fixed order would otherwise starve
        # later ones for as long as it keeps filling max_records.
        n = len(consumer._assignment)
        first = consumer._fetch_start % n if n else 0
        for k in range(n):
            tname, p = consumer._assignment[(first + k) % n]
            if len(out) >= max_records:
                break
            t = self._topic(tname)
            tp = (tname, p)
            if consumer._auto_commit:
                start = self._committed(consumer.group_id, tp)
            else:
                # manual mode: a private fetch position rides ahead of
                # the group's committed offset; nothing below moves the
                # committed offset until Consumer.commit
                start = consumer._positions.get(
                    tp, self._committed(consumer.group_id, tp))
            eff, take = t.partitions[p].slice(start, max_records - len(out))
            if eff > start:
                # committed position fell below the log-start (possible
                # only for positions retention proved consumed or that a
                # rewind aimed below the retained log): reset-to-earliest.
                # Commit the clamped position even when the take is empty
                # (idle topic: base == end) — otherwise every subsequent
                # poll re-detects the same clamp and oor_resets inflates
                # forever on a topic that had exactly one reset.
                self.oor_resets += 1
                if not take:
                    if consumer._auto_commit:
                        self._commit(consumer.group_id, tp, eff)
                    else:
                        consumer._positions[tp] = eff
            if take:
                # stored as exact tuples (GC untracking, see Record);
                # consumers get the Record view
                out.extend(map(Record._make, take))
                if consumer._auto_commit:
                    self._commit(consumer.group_id, tp, eff + len(take))
                else:
                    consumer._positions[tp] = eff + len(take)
        consumer._fetch_start = first + 1
        return out


class Consumer:
    """Poll-based consumer. With ``auto_commit=True`` (default) offsets
    commit on poll (at-most-once hand-off inside one process; the
    in-process broker never loses the log, so replay is available by
    resetting the group offset). With ``auto_commit=False`` poll advances
    a private position and :meth:`commit` moves the group offset under an
    epoch fence (at-least-once)."""

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
        """Currently owned (topic, partition) pairs (Kafka assignment())."""
        with self._broker._lock:
            return list(self._assignment)

    def commit(
        self,
        offsets: Mapping[tuple[str, int], int] | None = None,
        epoch: int | None = None,
    ) -> dict[tuple[str, int], int]:
        """Manual commit (``auto_commit=False`` mode). ``offsets=None``
        commits the broker-held fetch positions; an explicit mapping
        ``{(topic, partition): next_offset}`` commits exactly those.
        Fenced by ``epoch`` (default: the epoch of this consumer's last
        poll) — raises :class:`StaleEpochError` if the group rebalanced
        since, or if an explicit partition is not currently assigned to
        this consumer. Returns what was committed."""
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

    def __enter__(self) -> "Consumer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def __getattr__(name: str):
    # KafkaAdapter lives in its own module; re-exported here, where callers
    # expect the real-cluster seam, as the reference does
    if name == "KafkaAdapter":
        from ccfd_tpu_torch.bus.kafka_adapter import KafkaAdapter

        return KafkaAdapter
    raise AttributeError(name)
