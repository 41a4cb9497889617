"""Durable segment logs for the bus: Kafka's recovery story, one dir per cluster.

The port's copy of ccfd_tpu/bus/log.py. Its segment files, ``meta.log`` and
``offsets.log`` are byte for byte the reference's for the same records
(the same JSON separators and float repr in ``encode_entry``, the same
framing), so either package's broker replays the other's directory.

The reference's pipeline survives restarts because Kafka persists every
topic as on-disk log segments and consumers resume from committed group
offsets (reference deploy/frauddetection_cr.yaml:73-77; SURVEY.md §5
"Checkpoint / resume": "Kafka consumer offsets ... are the de-facto resume
mechanisms"). This module gives the in-process broker the same property:

- one append-only segment file per (topic, partition):  ``t<i>_p<k>.log``
- a topic catalog (``meta.log``) mapping topic names to file ids and
  partition counts, so filenames never depend on topic-name sanitization
- a committed-offsets log (``offsets.log``), appended on every group
  commit, last-write-wins on replay; the file is COMPACTED on reopen
  (rewritten to one entry per (group, topic, partition), tmp + rename)
  once the append tail dominates, so long-running durable buses don't pay
  unbounded reopen time for commit history

Retention: each (topic, partition) is a CHAIN of segment files
``t<i>_p<k>.<base>.log`` where ``<base>`` is the offset of the segment's
first record — exactly Kafka's on-disk layout
(``00000000000000000000.log``). The active segment rolls once it passes
``segment_bytes``; ``trim_partition`` deletes whole segments strictly
below a given offset (the broker calls it with its
delete-before-committed-offset retention floor, bus/broker.py). A legacy
un-suffixed ``t<i>_p<k>.log`` replays as the base-0 segment, so pre-
rotation log dirs keep working. Offsets are permanent: a record's offset
never changes when older segments are deleted, and replay returns the
chain's base so the in-memory partition rebases correctly.

Framing is ``[u32 len][u32 crc32][payload]`` with the byte-crunching
(frame building, replay scan, torn-tail detection) in C++
(ccfd_tpu_torch/native/log.cpp, built at first use; a failed build raises,
there is no fallback). The plain Python version in ``native`` is the
tests' reference. On reopen,
a file whose tail is torn (crashed mid-write) or corrupt is truncated to
its valid prefix — exactly Kafka's log-recovery behavior.

Durability model matches Kafka's default: every append is an ``os.write``
straight to the OS page cache (survives process crash); ``fsync=True``
additionally syncs per append for host-crash durability at a latency cost.

Record payloads carry a JSON header (key, timestamp) plus a type-tagged
value (raw bytes / utf-8 / JSON), so CSV wire lines and dict transactions
round-trip byte-exactly.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

from ccfd_tpu_torch.native import frame_records, scan_records

_TAG_BYTES = 0
_TAG_STR = 1
_TAG_JSON = 2


def encode_entry(key: Any, timestamp: float, value: Any) -> bytes:
    """(key, ts, value) -> payload bytes. Bytes/str values stay byte-exact.

    Bytes keys (which partition routing supports) ride as hex under "kb";
    everything else must be JSON-able, failing here before the in-memory
    append so memory and disk never diverge.
    """
    if isinstance(key, bytes):
        header = json.dumps({"kb": key.hex(), "ts": timestamp}).encode()
    else:
        header = json.dumps({"k": key, "ts": timestamp}).encode()
    if isinstance(value, bytes):
        tag, body = _TAG_BYTES, value
    elif isinstance(value, str):
        tag, body = _TAG_STR, value.encode()
    else:
        tag, body = _TAG_JSON, json.dumps(value).encode()
    return struct.pack("<BI", tag, len(header)) + header + body


def decode_entry(payload: bytes) -> tuple[Any, float, Any]:
    tag, hlen = struct.unpack_from("<BI", payload, 0)
    header = json.loads(payload[5 : 5 + hlen])
    body = payload[5 + hlen :]
    if tag == _TAG_BYTES:
        value: Any = body
    elif tag == _TAG_STR:
        value = body.decode()
    elif tag == _TAG_JSON:
        value = json.loads(body)
    else:
        raise ValueError(f"unknown value tag {tag}")
    key = bytes.fromhex(header["kb"]) if "kb" in header else header.get("k")
    return key, float(header.get("ts", 0.0)), value


# bound the byte-wise resync scan after a mid-file corrupt frame: the
# scan is corruption-path-only, but a 64 MiB segment must not stall
# reopen for minutes hunting a resync point through garbage
_RESYNC_SCAN_BYTES = 8 * 1024 * 1024


def _count_records_past_corruption(buf: bytes, valid: int) -> int:
    """How many VALID records sit beyond a corrupt frame at ``valid``.

    Truncating at the first corrupt frame is the only offset-safe
    recovery (later records' offsets would silently shift), but doing it
    SILENTLY hides that mid-file corruption — unlike a torn tail — drops
    real, durable records. Resync by scanning forward for the next
    parseable frame chain and count what the truncation discards, so the
    loss is loud (``ccfd_storage_log_truncated_records_total``) instead
    of invisible."""
    import binascii
    import struct

    end = len(buf)
    limit = min(end - 8, valid + 1 + _RESYNC_SCAN_BYTES)
    pos = valid + 1
    while pos <= limit:
        ln, crc = struct.unpack_from("<II", buf, pos)
        if 0 < ln <= end - pos - 8 and (
                binascii.crc32(buf[pos + 8: pos + 8 + ln]) & 0xFFFFFFFF
                == crc):
            recs, _consumed, _corrupt = scan_records(buf[pos:])
            return len(recs)
        pos += 1
    return 0


class SegmentFile:
    """One append-only framed file. Replay truncates a torn/corrupt tail;
    mid-file corruption (bitrot, not a crash) truncates too — offsets
    must stay stable — but counts and loudly logs the valid records the
    truncation drops."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._fd: int | None = None

    def replay(self) -> list[bytes]:
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            buf = f.read()
        payloads, valid, corrupt = scan_records(buf)
        if valid < len(buf):  # crashed tail: recover the valid prefix
            if corrupt:
                dropped = _count_records_past_corruption(buf, valid)
                if dropped:
                    import logging

                    from ccfd_tpu_torch.runtime.durability import note

                    note("log_truncated_records", dropped)
                    logging.getLogger(__name__).error(
                        "segment %s: corrupt frame at byte %d drops %d "
                        "VALID later record(s) — truncating to the valid "
                        "prefix (offsets must stay stable); re-drive from "
                        "an earlier cut recovers them", self.path, valid,
                        dropped)
            with open(self.path, "r+b") as f:
                f.truncate(valid)
        return payloads

    def _ensure_open(self) -> int:
        if self._fd is None:
            self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        return self._fd

    def append(self, *payloads: bytes) -> None:
        fd = self._ensure_open()
        os.write(fd, frame_records(list(payloads)))
        if self.fsync:
            os.fsync(fd)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class _SegmentSeries:
    """The on-disk segment chain for one (topic, partition).

    Kafka's layout: each file is named by the offset of its first record,
    the last file is the active (append) segment, rolling at
    ``segment_bytes``, and retention deletes whole files from the front.
    Offsets are permanent — deleting old segments never renumbers
    anything; replay hands back the chain's first base so the in-memory
    partition rebases instead of assuming 0.
    """

    def __init__(self, directory: str, tid: int, part: int,
                 fsync: bool, segment_bytes: int):
        self.dir = directory
        self.prefix = f"t{tid}_p{part}"
        self.fsync = fsync
        self.segment_bytes = segment_bytes
        self.chain: list[tuple[int, str]] = []  # (base, path), ascending
        self._active: SegmentFile | None = None
        self._active_base = 0
        self._active_count = 0
        self._active_bytes = 0

    def _path(self, base: int) -> str:
        # zero-padded to 20 digits like Kafka: lexical order == offset order
        return os.path.join(self.dir, f"{self.prefix}.{base:020d}.log")

    def _discover(self) -> None:
        chain: list[tuple[int, str]] = []
        legacy = os.path.join(self.dir, self.prefix + ".log")
        if os.path.exists(legacy):  # pre-rotation dirs: the base-0 segment
            chain.append((0, legacy))
        pre = self.prefix + "."
        for name in os.listdir(self.dir):
            if name.startswith(pre) and name.endswith(".log"):
                mid = name[len(pre):-4]
                if mid.isdigit():
                    chain.append((int(mid), os.path.join(self.dir, name)))
        chain.sort()
        self.chain = chain

    def replay(self) -> tuple[int, list[bytes]]:
        """-> (base offset of the first retained record, payloads).

        Torn tails truncate to the valid prefix (Kafka log recovery). A
        truncation that is NOT in the last segment leaves every later
        segment's base pointing past a hole, so the chain keeps its
        longest offset-consistent prefix and the orphaned files are
        deleted — at-least-once replay from an earlier cut beats replaying
        records at silently wrong offsets."""
        self._discover()
        if not self.chain:
            self._active = None
            self._active_base = self._active_count = self._active_bytes = 0
            return 0, []
        base0 = self.chain[0][0]
        payloads: list[bytes] = []
        expected = base0
        kept = 0
        for i, (base, path) in enumerate(self.chain):
            if base != expected:
                for _, orphan in self.chain[i:]:
                    try:
                        os.unlink(orphan)
                    except OSError:
                        pass
                break
            seg = SegmentFile(path, self.fsync)
            recs = seg.replay()
            seg.close()
            payloads.extend(recs)
            expected = base + len(recs)
            kept = i + 1
        self.chain = self.chain[:kept]
        last_base, last_path = self.chain[-1]
        self._active = SegmentFile(last_path, self.fsync)
        self._active_base = last_base
        self._active_count = expected - last_base
        try:
            self._active_bytes = os.path.getsize(last_path)
        except OSError:
            self._active_bytes = 0
        return base0, payloads

    def append(self, *payloads: bytes) -> None:
        if self._active is None:
            self._active = SegmentFile(self._path(self._active_base),
                                       self.fsync)
            self.chain.append((self._active_base, self._active.path))
        self._active.append(*payloads)
        self._active_count += len(payloads)
        # 8 framing bytes ([u32 len][u32 crc]) per record
        self._active_bytes += sum(len(p) + 8 for p in payloads)
        if self._active_bytes >= self.segment_bytes:
            self._roll()

    def _roll(self) -> None:
        self._active.close()
        self._active_base += self._active_count
        self._active_count = 0
        self._active_bytes = 0
        self._active = SegmentFile(self._path(self._active_base), self.fsync)
        self._active._ensure_open()  # the empty active must exist on disk:
        self.chain.append((self._active_base, self._active.path))
        # a crash right after the roll otherwise replays a chain whose
        # last base has no file, and new appends would recreate it anyway

    def trim_to(self, offset: int) -> int:
        """Delete whole segments whose every record sits below ``offset``.
        The active segment is never deleted; returns segments removed."""
        n = 0
        while len(self.chain) >= 2 and self.chain[1][0] <= offset:
            _, path = self.chain.pop(0)
            try:
                os.unlink(path)
            except OSError:
                pass
            n += 1
        return n

    @property
    def start_offset(self) -> int:
        return self.chain[0][0] if self.chain else self._active_base

    def close(self) -> None:
        if self._active is not None:
            self._active.close()
            self._active = None


# 64 MiB: big enough that rotation costs nothing at demo rates, small
# enough that retention reclaims space promptly on long soaks
DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024


class BusLog:
    """Directory of segment files backing one Broker instance."""

    META = "meta.log"
    OFFSETS = "offsets.log"

    def __init__(self, directory: str, fsync: bool = False,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        self.dir = directory
        self.fsync = fsync
        self.segment_bytes = segment_bytes
        os.makedirs(directory, exist_ok=True)
        # a crash mid-compaction (or mid-write anywhere in this dir)
        # leaves orphan *.tmp debris — e.g. offsets.log's compaction tmp;
        # swept at open, counted in ccfd_storage_tmp_swept_total
        from ccfd_tpu_torch.runtime.durability import sweep_tmp

        sweep_tmp(directory)
        self._meta = SegmentFile(os.path.join(directory, self.META), fsync)
        self._offsets = SegmentFile(os.path.join(directory, self.OFFSETS), fsync)
        self._topic_ids: dict[str, int] = {}
        self._partitions: dict[str, int] = {}
        self._series: dict[tuple[str, int], _SegmentSeries] = {}

    # -- replay -------------------------------------------------------------

    def replay_topics(self) -> dict[str, int]:
        """meta.log -> {topic: n_partitions}; also primes the file-id map."""
        for payload in self._meta.replay():
            m = json.loads(payload)
            self._topic_ids[m["topic"]] = int(m["id"])
            self._partitions[m["topic"]] = int(m["partitions"])
        return dict(self._partitions)

    def replay_partition(
        self, topic: str, part: int
    ) -> tuple[int, list[tuple[Any, float, Any]]]:
        """-> (base offset of the first retained record, decoded records)."""
        base, payloads = self._segment(topic, part).replay()
        return base, [decode_entry(p) for p in payloads]

    def replay_offsets(self) -> dict[str, dict[tuple[str, int], int]]:
        groups: dict[str, dict[tuple[str, int], int]] = {}
        n_raw = 0
        for payload in self._offsets.replay():
            n_raw += 1
            o = json.loads(payload)
            g = groups.setdefault(o["g"], {})
            tp = (o["t"], int(o["p"]))
            # Last-wins, not max: every append happens under the broker
            # lock, so file order IS logical order — and an administrative
            # rewind (Broker.reset_offsets, the crash-recovery replay cut)
            # must survive a broker crash rather than be undone by an
            # earlier, higher commit on replay.
            g[tp] = int(o["o"])
        n_unique = sum(len(g) for g in groups.values())
        # offsets.log grows one entry per commit forever; once history
        # dominates (>4x the live key count), rewrite it compacted. Atomic
        # (tmp + rename) and done before any append opens the file, so a
        # crash mid-compaction leaves either the old or the new file intact.
        if n_raw > max(64, 4 * n_unique):
            tmp = self._offsets.path + ".tmp"
            # fsync=True regardless of the bus's per-append policy: this
            # is a REWRITE, not an append — a rename that survives a host
            # crash whose data did not would lose every committed offset
            # (appends merely lose their tail)
            compacted = SegmentFile(tmp, fsync=True)
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            payloads = [
                json.dumps({"g": g_name, "t": t, "p": p, "o": off}).encode()
                for g_name, tps in groups.items()
                for (t, p), off in tps.items()
            ]
            if payloads:  # one write (and one fsync) for the whole rewrite
                compacted.append(*payloads)
            compacted.close()
            os.replace(tmp, self._offsets.path)
        return groups

    # -- append -------------------------------------------------------------

    def add_topic(self, topic: str, n_partitions: int) -> None:
        if topic in self._topic_ids:
            return
        tid = len(self._topic_ids)
        self._topic_ids[topic] = tid
        self._partitions[topic] = n_partitions
        self._meta.append(
            json.dumps({"topic": topic, "id": tid, "partitions": n_partitions}).encode()
        )

    def append_record(
        self, topic: str, part: int, key: Any, timestamp: float, value: Any
    ) -> None:
        self._segment(topic, part).append(encode_entry(key, timestamp, value))

    def append_payload(self, topic: str, part: int, payload: bytes) -> None:
        """Append an already-encoded entry (producers pre-encode so encode
        errors surface before any in-memory state mutates)."""
        self._segment(topic, part).append(payload)

    def commit_offset(self, group: str, topic: str, part: int, offset: int) -> None:
        self._offsets.append(
            json.dumps({"g": group, "t": topic, "p": part, "o": offset}).encode()
        )

    def trim_partition(self, topic: str, part: int, offset: int) -> int:
        """Delete whole on-disk segments strictly below ``offset`` (the
        broker's retention floor).  Returns segments removed."""
        return self._segment(topic, part).trim_to(offset)

    def start_offset(self, topic: str, part: int) -> int:
        return self._segment(topic, part).start_offset

    def _segment(self, topic: str, part: int) -> _SegmentSeries:
        series = self._series.get((topic, part))
        if series is None:
            tid = self._topic_ids[topic]
            series = _SegmentSeries(self.dir, tid, part, self.fsync,
                                    self.segment_bytes)
            self._series[(topic, part)] = series
        return series

    def close(self) -> None:
        self._meta.close()
        self._offsets.close()
        for series in self._series.values():
            series.close()
