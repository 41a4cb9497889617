"""Decision provenance plane: one compact audit record per routed transaction.

The port's copy of ccfd_tpu/observability/audit.py. Fraud serving is
regulated: every score that routed a transaction must be reconstructable
after the fact. Because the pipeline owns every stage, provenance is
STAMPED inline at the route seam (``router/router.py``) for near-zero cost
instead of re-derived from logs.

The unit is the DecisionRecord, a plain dict built once per routed row:

==============  ==========================================================
key             meaning
==============  ==========================================================
``seq``         process-monotone stamp sequence
``tx``          transaction id (the record key / tx ``id`` field)
``uid``         bus coordinate ``"<partition>:<offset>"``, unique per
                consumed record, the dedupe key under crash-replay
``ts``          the record's PRODUCE timestamp
``decided_ts``  when the decision was stamped
``proba``       the score that routed the row
``threshold``   the FRAUD_THRESHOLD in force
``rule``        the fired rule's name
``branch``      the routed branch (the process definition started)
``pid``         the engine process-instance id
``tier``        the serving tier that produced the score:
                ``device`` | ``host`` | ``rules``
``cause``       why a degraded tier served (``quarantine`` |
                ``storage_pin`` | ``breaker_open`` | ``score_error`` |
                ``watchdog_timeout``); absent on the healthy path
``events``      batch-level events observed while scoring
                (``breaker_open``, ``watchdog_timeout``, ``score_error``)
``priority``    admission class (``bulk`` | ``normal`` | ``critical``)
``version``     champion model version id (the lifecycle's lineage,
                sampled once per batch through ``lineage_fn``)
``hash``        the champion's checkpoint hash, from the same sample
``row``         the decoded feature row, while the replay plane has
                ``capture_rows`` armed (so a window scanned off the
                segments is re-scorable)
``incident``    the open incident bundle id (the flight recorder,
                observability/incident.py, while an SLO breaches)
``trace``       trace id (joins ``/traces/<id>`` when the tail sampler
                kept it)
``worker``      router worker that routed the batch
==============  ==========================================================

Storage is two-layer and bounded:

- a **ring** (``max_records``, default 65536) keyed by ``uid`` with a
  ``tx -> uid`` index: the exporter's ``/decisions/<tx_id>`` and
  ``/decisions?since=`` answer from here;
- a **segmented append-only log** under ``dir`` (``audit-<n>.log``): each
  flush appends ONE ``durability.frame``-checksummed block of JSON lines,
  byte for byte the reference's, so either package reads the other's
  directory; segments rotate at ``segment_bytes`` and prune past
  ``retain_segments``, and recovery re-scans the segments verifying every
  frame. A torn tail (a crash mid-append, an injected ``torn_write``) is
  TRUNCATED to the valid prefix and counted
  (``ccfd_audit_dropped_total{reason="torn_tail"}``). The storage-fault
  plan (runtime/faults.py) is drawn at the append seam in the reference's
  order.

Writes are best-effort: the ring is authoritative for the live process, a
failed append counts (``ccfd_audit_dropped_total{reason="log_write"}``) and
serving never stalls. A restart rebuilds the ring from the verified log,
so a decision made before a crash reconstructs end to end
(``python -m ccfd_tpu_torch audit <tx_id>``). ``readonly=True`` is the
inspection surface: recovery scans verify but never truncate.

Metrics: ``ccfd_audit_records_total``, ``ccfd_audit_dropped_total{reason}``,
``ccfd_audit_log_bytes``, ``ccfd_audit_ring_records``,
``ccfd_audit_join_errors_total{source}``.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Mapping

from ccfd_tpu_torch.runtime import durability

log = logging.getLogger(__name__)

SEGMENT_PREFIX = "audit-"
SEGMENT_SUFFIX = ".log"

# the compact listing shape (/decisions): enough to triage without
# shipping the full record per row
SUMMARY_KEYS = ("seq", "tx", "uid", "ts", "decided_ts", "proba", "branch",
                "tier", "priority", "version", "incident")


def summarize(rec: Mapping[str, Any]) -> dict[str, Any]:
    return {k: rec[k] for k in SUMMARY_KEYS if k in rec}


class AuditLog:
    """Bounded, crash-safe decision-record plane; see the module docstring.

    Thread-safe: every ParallelRouter worker stamps into ONE shared
    instance, the supervised flusher drains it, and the exporter queries
    it concurrently. ``lineage_fn`` (-> ``(version, checkpoint_hash)``)
    and ``incident_fn`` (-> open incident id or None) are sampled once
    per :meth:`record_batch`, never per row — the operator wires them to
    the lifecycle lineage and the flight recorder. ``readonly=True`` is
    the inspection surface (the CLI): recovery scans verify but never
    truncate or mutate the live directory.
    """

    def __init__(
        self,
        dir: str | None = None,
        max_records: int = 65536,
        segment_bytes: int = 4 * 1024 * 1024,
        retain_segments: int = 8,
        registry=None,
        fsync: bool | None = None,
        readonly: bool = False,
        lineage_fn: Callable[[], tuple[Any, Any]] | None = None,
        incident_fn: Callable[[], Any] | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.dir = dir or None
        self.max_records = max(1, int(max_records))
        self.segment_bytes = max(4096, int(segment_bytes))
        self.retain_segments = max(1, int(retain_segments))
        self._fsync = fsync
        self.readonly = bool(readonly)
        # armed by the replay plane: the route seam then embeds each
        # record's decoded feature row (``row``)
        self.capture_rows = False
        self.lineage_fn = lineage_fn
        self.incident_fn = incident_fn
        self._clock = clock
        self._mu = threading.Lock()
        self._ring: "OrderedDict[str, dict]" = OrderedDict()
        self._by_tx: dict[str, str] = {}
        self._pending: list[dict] = []
        self._seq = 0
        self._seg_index = 0
        self._seg_bytes = 0
        self.recorded = 0       # records stamped by THIS process
        self.restamped = 0      # a uid stamped again (crash-replay re-drive)
        self.recovered = 0      # records rebuilt from the log at bring-up
        self.truncated_frames = 0  # torn frames dropped at recovery
        self._stop = threading.Event()
        self._c_records = self._c_dropped = self._c_join_err = None
        self._g_log_bytes = self._g_ring = None
        if registry is not None:
            self._c_join_err = registry.counter(
                "ccfd_audit_join_errors_total",
                "provenance-join probe failures by source (lineage/"
                "incident): the records still land, but WITHOUT that "
                "join — a regulator reconstruction would come back "
                "partial, so the gap must be visible while it happens",
            )
            self._c_records = registry.counter(
                "ccfd_audit_records_total",
                "decision records stamped at the route seam (one per "
                "routed transaction; conservation: equals the sum of "
                "transaction_outgoing_total)",
            )
            self._c_dropped = registry.counter(
                "ccfd_audit_dropped_total",
                "decision-plane drops by reason — UNITS DIFFER per "
                "label: ring counts RECORDS evicted from the bounded "
                "ring (the log may still hold them), log_write counts "
                "RECORDS whose durable append failed, torn_tail counts "
                "truncation EVENTS at crash recovery (the records inside "
                "a torn frame are unparseable, so they cannot be "
                "counted)",
            )
            self._g_log_bytes = registry.gauge(
                "ccfd_audit_log_bytes",
                "total bytes across retained audit log segments",
            )
            self._g_ring = registry.gauge(
                "ccfd_audit_ring_records",
                "decision records currently held in the query ring",
            )
        if self.dir and not self.readonly:
            os.makedirs(self.dir, exist_ok=True)
        if self.dir:
            self._recover()
        self._set_gauges()

    # -- segments ----------------------------------------------------------
    def _segments(self) -> list[tuple[int, str]]:
        out: list[tuple[int, str]] = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if (name.startswith(SEGMENT_PREFIX)
                    and name.endswith(SEGMENT_SUFFIX)):
                mid = name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]
                if mid.isdigit():
                    out.append((int(mid), os.path.join(self.dir, name)))
        return sorted(out)

    def _seg_path(self, index: int) -> str:
        return os.path.join(self.dir,
                            f"{SEGMENT_PREFIX}{index:08d}{SEGMENT_SUFFIX}")

    @staticmethod
    def _scan_frames(data: bytes) -> tuple[list[dict], int, bool]:
        """-> (records, valid_prefix_bytes, torn). One verified frame per
        flush; the durability seam owns the frame format
        (:func:`durability.scan_frames` — first bad frame stops the
        scan, everything after it in an append-only segment postdates
        the corruption). A frame whose payload fails to parse as JSON
        lines counts as torn from that frame on."""
        frames, valid, torn = durability.scan_frames(data)
        records: list[dict] = []
        for start, payload in frames:
            try:
                for line in payload.splitlines():
                    if line:
                        records.append(json.loads(line))
            except ValueError:
                return records, start, True
        return records, valid, torn

    def _recover(self) -> None:
        """Rebuild the ring (and the seq/segment counters) from the
        verified log. Torn tails truncate to the valid prefix (counted);
        in ``readonly`` mode the scan verifies but never mutates disk."""
        segs = self._segments()
        all_records: list[dict] = []
        poisoned: set[str] = set()
        for idx, path in segs:
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            records, valid, torn = self._scan_frames(data)
            if torn:
                self.truncated_frames += 1
                self._count_drop("torn_tail", 1)
                log.warning(
                    "audit segment %s torn at byte %d: truncated to the "
                    "valid prefix (%d records recovered)",
                    path, valid, len(records))
                if not self.readonly:
                    try:
                        with open(path, "r+b") as f:
                            f.truncate(valid)
                    except OSError:
                        # the torn bytes could not be removed (dying
                        # media): the segment must never take another
                        # append — recovery stops at the first bad
                        # frame, so anything written after the garbage
                        # would be unrecoverable
                        poisoned.add(path)
            all_records.extend(records)
        if segs:
            self._seg_index = segs[-1][0]
            newest = self._seg_path(self._seg_index)
            if newest in poisoned:
                self._seg_index += 1
                self._seg_bytes = 0
                log.error("audit segment %s kept its torn tail; rotated "
                          "to a fresh segment", newest)
            else:
                try:
                    self._seg_bytes = os.path.getsize(newest)
                except OSError:
                    self._seg_bytes = 0
        with self._mu:
            for rec in all_records[-self.max_records:]:
                self._ring_put_locked(rec, recovered=True)
            self.recovered = len(all_records)
            self._seq = max(
                (int(r.get("seq", -1)) for r in all_records), default=-1
            ) + 1

    # -- stamping (the route-seam hot path) --------------------------------
    def record_batch(
        self,
        rows: list[dict],
        *,
        tier: str = "device",
        cause: str | None = None,
        events: tuple | list = (),
        worker: int | None = None,
        trace_id: str | None = None,
        threshold: float | None = None,
    ) -> None:
        """Stamp one batch of routed rows. ``rows`` carry the per-row
        fields the router already holds (tx/uid/ts/proba/rule/branch/
        pid/priority); everything batch-granular — tier, cause, events,
        the threshold in force, the lineage sample, the open incident —
        is resolved ONCE here and shared across the batch (the
        per-batch-not-per-row contract that keeps the armed plane
        inside bench noise). The route seam owns ``threshold``: it is a
        property of the decision, not of this log."""
        if not rows:
            return
        ver = hsh = None
        if self.lineage_fn is not None:
            try:
                ver, hsh = self.lineage_fn()
            except Exception:  # noqa: BLE001 - provenance must not crash routing
                if self._c_join_err is not None:
                    self._c_join_err.inc(labels={"source": "lineage"})
        inc = None
        if self.incident_fn is not None:
            try:
                inc = self.incident_fn()
            except Exception:  # noqa: BLE001 - provenance must not crash routing
                if self._c_join_err is not None:
                    self._c_join_err.inc(labels={"source": "incident"})
        thr = threshold
        now = self._clock()
        ev = list(events) if events else None
        with self._mu:
            for r in rows:
                r["seq"] = self._seq
                self._seq += 1
                r["decided_ts"] = now
                r["tier"] = tier
                if thr is not None:
                    r["threshold"] = thr
                if cause is not None:
                    r["cause"] = cause
                if ev:
                    r["events"] = ev
                if worker is not None:
                    r["worker"] = worker
                if trace_id is not None:
                    r["trace"] = trace_id
                if ver is not None:
                    r["version"] = ver
                if hsh is not None:
                    r["hash"] = hsh
                if inc is not None:
                    r["incident"] = inc
                self._ring_put_locked(r)
                if self.dir is not None and not self.readonly:
                    self._pending.append(r)
            self.recorded += len(rows)
        if self._c_records is not None:
            self._c_records.inc(len(rows))
        self._set_ring_gauge()

    def _ring_put_locked(self, rec: dict, recovered: bool = False) -> None:
        uid = str(rec.get("uid") or f"seq-{rec.get('seq', 0)}")
        if uid in self._ring:
            # a crash-restore re-drive legitimately re-routes (and
            # re-stamps) a consumed record: latest decision wins in the
            # ring, the log keeps both stamps, and the tally makes the
            # re-drive visible to the soak's conservation gate
            del self._ring[uid]
            if not recovered:
                self.restamped += 1
        self._ring[uid] = rec
        tx = rec.get("tx")
        if tx is not None:
            self._by_tx[str(tx)] = uid
        while len(self._ring) > self.max_records:
            old_uid, old = self._ring.popitem(last=False)
            old_tx = old.get("tx")
            if old_tx is not None and self._by_tx.get(str(old_tx)) == old_uid:
                del self._by_tx[str(old_tx)]
            if not recovered:
                self._count_drop("ring", 1)

    def _count_drop(self, reason: str, n: int) -> None:
        if self._c_dropped is not None and n > 0:
            self._c_dropped.inc(n, labels={"reason": reason})

    def _set_ring_gauge(self) -> None:
        if self._g_ring is not None:
            self._g_ring.set(float(len(self._ring)))

    def _set_gauges(self) -> None:
        # the log-bytes walk stats every retained segment: flush/recovery
        # cadence only — the route-seam hot path updates just the ring
        # gauge (log bytes change only when an append lands anyway)
        self._set_ring_gauge()
        if self._g_log_bytes is not None and self.dir:
            total = 0
            for _i, path in self._segments():
                try:
                    total += os.path.getsize(path)
                except OSError:
                    pass
            self._g_log_bytes.set(float(total))

    # -- the durable append (storage faults inject here) -------------------
    def _append(self, data: bytes) -> None:
        plan = None
        try:
            from ccfd_tpu_torch.runtime import faults

            plan = faults.storage_faults()
        except Exception:  # noqa: BLE001 - fault plumbing must not block audit
            plan = None

        def draw(kind: str):
            return plan.draw(kind) if plan is not None else None

        s = draw("slow_disk")
        if s is not None:
            time.sleep(s.ms / 1e3)
        if draw("enospc") is not None:
            raise OSError(errno.ENOSPC, "injected ENOSPC", self.dir)
        path = self._seg_path(self._seg_index)
        torn = draw("torn_write")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            start = os.fstat(fd).st_size
            try:
                if torn is not None:
                    # crash mid-append: a prefix of the frame lands —
                    # exactly the torn tail recovery truncates and counts
                    os.write(fd, data[: max(0, int(len(data) * torn.frac))])
                    raise OSError(errno.EIO, "injected torn write", path)
                n = os.write(fd, data)
                if n != len(data):  # short write (full disk mid-frame)
                    raise OSError(errno.EIO, f"short write {n}", path)
                fsync = (durability._defaults["fsync"]
                         if self._fsync is None else self._fsync)
                if fsync:
                    if draw("fsync_fail") is not None:
                        raise OSError(errno.EIO, "injected fsync failure",
                                      path)
                    os.fsync(fd)
            except OSError:
                # a partial frame must NOT stay at the tail: the process
                # is still alive and will append more frames after it,
                # and recovery stops at the first bad frame — every later
                # GOOD frame would be silently truncated with it. Roll
                # the segment back to its pre-append length; if even that
                # fails (dying media), abandon the segment and rotate so
                # the next flush starts a clean one.
                try:
                    os.ftruncate(fd, start)
                except OSError:
                    self._seg_index += 1
                    self._seg_bytes = 0
                    log.error("audit segment %s unrecoverable after a "
                              "failed append; rotated to a fresh segment",
                              path)
                raise
        finally:
            os.close(fd)
        self._seg_bytes += len(data)
        if self._seg_bytes >= self.segment_bytes:
            self._seg_index += 1
            self._seg_bytes = 0
            for _i, p in self._segments()[:-self.retain_segments]:
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def flush(self) -> int:
        """Drain pending records into the current segment as ONE framed
        block; returns records landed. A failed append (full disk,
        injected fault) counts the loss loudly — the ring stays
        authoritative and serving never stalls on the audit disk."""
        with self._mu:
            if not self._pending:
                return 0
            pending, self._pending = self._pending, []
        payload = ("\n".join(
            json.dumps(r, separators=(",", ":"), default=str)
            for r in pending) + "\n").encode()
        try:
            self._append(durability.frame(payload))
        except OSError as e:
            self._count_drop("log_write", len(pending))
            durability.note("write_errors", artifact="audit")
            log.error("audit log append failed (%s): %d records kept only "
                      "in the ring", e, len(pending))
            return 0
        self._set_gauges()
        return len(pending)

    # -- queries -----------------------------------------------------------
    def get(self, tx_id: Any) -> dict | None:
        """Full record for a transaction id (or a ``uid`` / ``seq-<n>``
        key) — the ``/decisions/<tx_id>`` body. Latest decision wins when
        an id was re-routed (crash-replay)."""
        key = str(tx_id)
        with self._mu:
            uid = self._by_tx.get(key, key)
            rec = self._ring.get(uid)
            return dict(rec) if rec is not None else None

    def list(self, since: float | None = None,
             limit: int = 256, until: float | None = None) -> list[dict]:
        """Compact summaries, newest first — the ``/decisions?since=``
        body. ``since``/``until`` filter on ``decided_ts`` (unix
        seconds): records with ``since < decided_ts <= until``.

        The scan is bounded while holding the stamp mutex: ring order IS
        decide order (a re-stamp re-inserts at the tail), so iterating
        newest-first can STOP at the first record at/under ``since``
        instead of walking 64k older entries under the lock the route
        seam needs — and ``limit`` is clamped so an unbounded
        ``?limit=`` cannot turn a poll into a full-ring scan either.
        ``until`` records SKIPPED at the newest end still count against
        the same scan bound (limit + skips capped together), keeping the
        worst case at one bounded walk rather than a full ring."""
        limit = min(max(1, int(limit)), 4096)
        scan_cap = limit + 4096  # bounded even when `until` skips newest
        out: list[dict] = []
        scanned = 0
        with self._mu:
            for rec in reversed(self._ring.values()):
                scanned += 1
                if scanned > scan_cap:
                    break
                ts = rec.get("decided_ts", 0.0)
                if since is not None and ts <= since:
                    break
                if until is not None and ts > until:
                    continue
                out.append(summarize(rec))
                if len(out) >= limit:
                    break
        return out

    def scan_window(self, since_seq: int | None = None,
                    until_seq: int | None = None,
                    limit: int = 262_144) -> list[dict]:
        """Bounded windowed scan over the ON-DISK segments — the replay
        plane's window source. Returns full records with
        ``since_seq <= seq <= until_seq``, ascending by ``seq``, one per
        ``uid`` (a crash-replay re-stamp means a uid can appear twice in
        the log; the LATEST stamp is the decision of record, matching
        the ring's latest-wins rule).

        Read-only by construction (the readonly-scan rule): the
        scan opens segments for reading and NEVER truncates a torn tail
        — a frame torn by a concurrent live append simply stops that
        segment's scan at the valid prefix, and the caller sees a
        shorter window rather than a mutated log. Memory is inherently
        bounded by segment retention (``retain_segments`` x
        ``segment_bytes``); ``limit`` backstops the result set."""
        if not self.dir:
            return []
        lo = None if since_seq is None else int(since_seq)
        hi = None if until_seq is None else int(until_seq)
        limit = max(1, int(limit))
        best: dict[str, dict] = {}
        for _idx, path in self._segments():
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            records, _valid, _torn = self._scan_frames(data)
            for rec in records:
                try:
                    seq = int(rec.get("seq", -1))
                except (TypeError, ValueError):
                    continue
                if (lo is not None and seq < lo) or (
                        hi is not None and seq > hi):
                    continue
                uid = str(rec.get("uid") or f"seq-{seq}")
                prev = best.get(uid)
                if prev is None or int(prev.get("seq", -1)) <= seq:
                    best[uid] = rec
        out = sorted(best.values(), key=lambda r: int(r.get("seq", -1)))
        if len(out) > limit:
            log.warning("audit scan_window clamped %d -> %d records",
                        len(out), limit)
            out = out[:limit]
        return out

    def recent_summaries(self, n: int = 16, since: float | None = None) -> list[dict]:
        """The flight recorder's embed: the last ``n`` decisions (newest
        first), the transactions in flight when an incident bundle dumped."""
        return self.list(since=since, limit=n)

    @property
    def ring_size(self) -> int:
        with self._mu:
            return len(self._ring)

    def counts(self) -> dict[str, int]:
        with self._mu:
            return {
                "recorded": self.recorded,
                "ring": len(self._ring),
                "pending": len(self._pending),
                "restamped": self.restamped,
                "recovered": self.recovered,
                "truncated_frames": self.truncated_frames,
            }

    # -- supervised-service surface (the flusher) --------------------------
    def reset(self) -> None:
        self._stop.clear()

    def stop(self) -> None:
        self._stop.set()

    def run(self, interval_s: float = 0.25) -> None:
        try:
            while not self._stop.wait(interval_s):
                self.flush()
        finally:
            self.flush()  # orderly shutdown lands the tail
