"""Bulk replay & backtest: re-score recorded history through the live stack.

The port's copy of ccfd_tpu/replay/service.py. The decision provenance
plane (observability/audit.py) gives every routed transaction a
DecisionRecord; this plane USES that provenance at scale: regulator audits re-drive a recorded window and prove
the stack still makes the same calls, incident re-drives replay the
transactions that were in flight around a breach, and challenger
backtests ask "what would the new threshold/checkpoint have decided".

The conservation law is ``replayed verdict == recorded verdict`` —
checked per row, byte-stable on the score. Any divergence is itself a
finding, classified by cause:

==================  ======================================================
cause               meaning
==================  ======================================================
``champion_hash``   a different champion checkpoint served the replay
                    (lifecycle moved on — expected after a promote)
``tier``            the serving tier differs (device vs host vs rules:
                    a quarantine/breaker state change, not a model change)
``threshold``       the FRAUD_THRESHOLD in force changed, so the same
                    score routed differently
``nondeterminism``  none of the above explains it — the alarming one
==================  ======================================================

plus window-accounting findings: a ``drop`` (a recorded row whose replay
never produced a verdict after retries) and a ``ghost`` (a replay-marked
verdict for a uid the window never contained).

Mechanics — the SAME path, not a parallel scorer:

- The window source is :meth:`AuditLog.scan_window` over the on-disk
  segments (read-only by contract), or an incident bundle's embedded
  decision summaries read as a plain mapping (:func:`bundle_window` ->
  seq range -> the same segment scan; observability/incident.py writes
  such bundles). Windows are re-scorable because the route
  seam embeds the decoded feature row in each record while the replay
  plane is armed (``AuditLog.capture_rows``).
- Re-production goes through the live bus: each recorded row becomes a
  dict transaction (identical feature values, so the decode seam
  rebuilds the identical float32 row) produced onto the transaction
  topic with a ``priority: bulk`` header and a ``_replay`` marker. The
  live router admits it under the overload plane — the bulk
  ceiling (:meth:`OverloadControl.set_bulk_ceiling`) caps the share of
  the adaptive budget replay may occupy, which is the zero-live-SLO
  guarantee: live traffic keeps the rest, AIMD keeps both honest.
- At the route seam the replayed decision is stamped like any other,
  but the :class:`ReplayVerdictTap` (an audit-shaped tap) diverts
  replay-marked rows to the join instead of the audit plane: replays
  never pollute the provenance log they are checked against.
- Progress is a crash-resumable cursor written through the durability
  seam (runtime/durability.py) after each joined batch: kill the worker mid-window,
  restart, and the window completes with exactly-once accounting (the
  bus re-production is at-least-once; the JOIN ledger is exactly-once —
  a late duplicate verdict counts as ``dup`` and changes nothing). A
  torn cursor falls back a generation (``read_json_artifact``) and the
  batch it loses is simply re-joined.
- What-if mode skips the bus entirely: a caller-supplied score function
  (the challenger checkpoint) and/or a threshold override are diffed
  against the recorded decisions host-side — backtests never touch the
  live serving path.

Metrics: ``ccfd_replay_rows_total{outcome}``,
``ccfd_replay_divergence_total{cause}``,
``ccfd_replay_windows_total{result}``, ``ccfd_replay_cursor_seq``,
``ccfd_replay_rows_per_s``, ``ccfd_bulk_ceiling{stage}`` (overload
plane), plus the tap's ``ccfd_replay_verdicts_total{fate}``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np

from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.runtime import durability

log = logging.getLogger(__name__)

CAUSE_CHAMPION_HASH = "champion_hash"
CAUSE_TIER = "tier"
CAUSE_THRESHOLD = "threshold"
CAUSE_NONDETERMINISM = "nondeterminism"

# bounded findings ledger per window: enough to triage, never unbounded
MAX_FINDINGS = 256


def classify_divergence(recorded: Mapping[str, Any],
                        replayed: Mapping[str, Any]) -> str | None:
    """None when parity holds (score, rule and branch byte-equal under
    the same threshold); otherwise the FIRST cause in precedence order
    that explains the divergence. Precedence matters: a champion swap
    usually changes the score too — blaming ``nondeterminism`` for a
    known promote would cry wolf on the only cause that is a bug."""
    same = (
        float(recorded.get("proba", -1.0)) == float(
            replayed.get("proba", -2.0))
        and recorded.get("rule") == replayed.get("rule")
        and recorded.get("branch") == replayed.get("branch")
        and _thr(recorded) == _thr(replayed)
    )
    if same:
        return None
    rec_h, rep_h = recorded.get("hash"), replayed.get("hash")
    if rec_h is not None and rep_h is not None and rec_h != rep_h:
        return CAUSE_CHAMPION_HASH
    if recorded.get("tier", "device") != replayed.get("tier", "device"):
        return CAUSE_TIER
    if _thr(recorded) != _thr(replayed):
        return CAUSE_THRESHOLD
    return CAUSE_NONDETERMINISM


def _thr(rec: Mapping[str, Any]) -> float | None:
    t = rec.get("threshold")
    return None if t is None else float(t)


def bundle_window(bundle: Mapping[str, Any]) -> tuple[int, int] | None:
    """FlightRecorder incident bundle -> the (since_seq, until_seq) of
    the decisions in flight across the breach window (the v2
    ``decisions`` embed), or None when the bundle has no decisions.
    The full records come from the segment scan — the bundle only
    brackets the window."""
    seqs = []
    for d in bundle.get("decisions") or ():
        try:
            seqs.append(int(d["seq"]))
        except (KeyError, TypeError, ValueError):
            continue
    if not seqs:
        return None
    return min(seqs), max(seqs)


class ReplayVerdictTap:
    """Audit-shaped route-seam tap that diverts replay-marked decisions.

    Sits where the router expects its audit sink (duck-typed
    ``record_batch``): live rows forward to
    the real :class:`AuditLog` untouched; rows stamped with a ``replay``
    marker go to the armed join sink instead — replayed verdicts must
    never land in the provenance log they are being checked against
    (they would re-stamp the original uids' transactions and poison the
    very window a re-drive reads). Never raises into the route seam."""

    def __init__(self, inner=None, registry=None):
        self.inner = inner
        self._sink: Callable[..., None] | None = None
        self._c_verdicts = None
        if registry is not None:
            self._c_verdicts = registry.counter(
                "ccfd_replay_verdicts_total",
                "replay-marked decisions leaving the route seam by fate: "
                "joined = handed to the armed window join; orphaned = no "
                "window armed (a replay worker died mid-window — the "
                "verdicts are dropped here and the resumed worker "
                "re-produces them)",
            )

    @property
    def capture_rows(self) -> bool:
        # the route seam asks the audit sink whether to embed feature
        # rows; the tap answers for the wrapped log
        return bool(self.inner is not None
                    and getattr(self.inner, "capture_rows", False))

    def arm(self, sink: Callable[..., None]) -> None:
        self._sink = sink

    def disarm(self) -> None:
        self._sink = None

    def record_batch(self, rows: list, *, tier: str = "device",
                     cause: str | None = None, events: tuple | list = (),
                     worker: int | None = None, trace_id: str | None = None,
                     threshold: float | None = None) -> None:
        live = [r for r in rows if r.get("replay") is None]
        replayed = [r for r in rows if r.get("replay") is not None]
        if live and self.inner is not None:
            self.inner.record_batch(
                live, tier=tier, cause=cause, events=events, worker=worker,
                trace_id=trace_id, threshold=threshold)
        if not replayed:
            return
        sink = self._sink
        fate = "orphaned" if sink is None else "joined"
        if self._c_verdicts is not None:
            self._c_verdicts.inc(len(replayed), labels={"fate": fate})
        if sink is None:
            return
        try:
            sink(replayed, tier=tier, cause=cause, threshold=threshold)
        except Exception:  # noqa: BLE001 - the join must not crash routing
            log.exception("replay verdict sink failed (%d verdicts)",
                          len(replayed))


class ReplayKilled(BaseException):
    """Raised by test crash hooks to simulate a worker dying mid-window.
    BaseException so production ``except Exception`` seams never swallow
    the simulated kill."""


class ReplayService:
    """Windowed replay with verdict-parity accounting; module docstring
    has the plane's contract. One instance per platform; thread-safe
    between the run loop and the tap's verdict callbacks."""

    def __init__(
        self,
        cfg,
        broker,
        audit,
        tap: ReplayVerdictTap | None = None,
        registry=None,
        state_dir: str | None = None,
        overload=None,
        gate=None,
        lineage_fn: Callable[[], tuple[Any, Any]] | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.cfg = cfg
        self.broker = broker
        self.audit = audit
        self.tap = tap
        self.overload = overload
        self.gate = gate
        self.lineage_fn = lineage_fn
        self._clock = clock
        self.state_dir = state_dir or None
        self.batch = max(1, int(getattr(cfg, "replay_batch", 256)))
        self.timeout_s = float(getattr(cfg, "replay_timeout_s", 10.0))
        self.retries = max(0, int(getattr(cfg, "replay_retries", 3)))
        self.bulk_ceiling = float(getattr(cfg, "replay_bulk_ceiling", 0.5))
        # operator-settable pacing knob (rows/second; 0 = saturate the
        # bulk share) — the future capacity planner's actuator
        self.pacing_rows_s = float(getattr(cfg, "replay_pacing_rows_s", 0.0))
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._inbox: dict[str, dict[str, dict]] = {}
        self._window_uids: dict[str, set[str]] = {}
        self._joined: dict[str, set[str]] = {}
        self._dups = 0
        self._ghosts: dict[str, list[str]] = {}
        self._stop = threading.Event()
        self._requests: list[dict] = []
        self.last_report: dict | None = None
        # test seam: called at ("produced"|"joined"|"committed", batch_i);
        # a hook that raises simulates a kill at exactly that boundary
        self.crash_hook: Callable[[str, int], None] | None = None
        self._c_rows = self._c_div = self._c_windows = None
        self._g_cursor = self._g_rate = None
        if registry is not None:
            self._c_rows = registry.counter(
                "ccfd_replay_rows_total",
                "replayed window rows by outcome: match (parity held), "
                "divergence, drop (no verdict after retries), ghost "
                "(verdict for a uid outside the window), dup (late "
                "duplicate verdict, ignored by the exactly-once join), "
                "no_row (record predates feature capture — not "
                "re-scorable)",
            )
            self._c_div = registry.counter(
                "ccfd_replay_divergence_total",
                "parity divergences by classified cause (champion_hash / "
                "tier / threshold / nondeterminism) — nondeterminism "
                "must stay 0; anything else is an explained finding",
            )
            self._c_windows = registry.counter(
                "ccfd_replay_windows_total",
                "completed replay windows by result (clean = every row "
                "matched; findings = at least one divergence/drop/ghost)",
            )
            self._g_cursor = registry.gauge(
                "ccfd_replay_cursor_seq",
                "highest recorded seq the durable replay cursor covers",
            )
            self._g_rate = registry.gauge(
                "ccfd_replay_rows_per_s",
                "replay re-score throughput over the last window",
            )
        if self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)
        if self.tap is not None:
            self.tap.arm(self._on_verdicts)
        if self.audit is not None:
            # arm feature capture so windows recorded from now on are
            # self-contained and re-scorable off the segments alone
            self.audit.capture_rows = True

    # -- the verdict join (tap callback; router worker threads) -----------
    def _on_verdicts(self, rows: list, *, tier: str = "device",
                     cause: str | None = None,
                     threshold: float | None = None) -> None:
        ver = hsh = None
        if self.lineage_fn is not None:
            try:
                ver, hsh = self.lineage_fn()
            except Exception:  # noqa: BLE001 - classification survives a
                pass           # failed lineage probe (hash stays None)
        with self._cv:
            for r in rows:
                mk = r.get("replay") or {}
                wid, uid = str(mk.get("w")), str(mk.get("uid"))
                uids = self._window_uids.get(wid)
                if uids is None or uid not in uids:
                    self._ghosts.setdefault(wid, []).append(uid)
                    continue
                if uid in self._joined.setdefault(wid, set()):
                    self._dups += 1
                    continue
                self._inbox.setdefault(wid, {})[uid] = {
                    "proba": r.get("proba"),
                    "rule": r.get("rule"),
                    "branch": r.get("branch"),
                    "pid": r.get("pid"),
                    "uid": r.get("uid"),
                    "tier": tier,
                    "cause": cause,
                    "threshold": threshold,
                    "version": ver,
                    "hash": hsh,
                }
            self._cv.notify_all()

    # -- pacing / admission knobs -----------------------------------------
    def set_pacing(self, rows_per_s: float) -> None:
        self.pacing_rows_s = max(0.0, float(rows_per_s))

    def set_bulk_ceiling(self, frac: float) -> None:
        self.bulk_ceiling = min(1.0, max(0.0, float(frac)))
        for target in (self.overload, self.gate):
            if target is not None:
                target.set_bulk_ceiling(self.bulk_ceiling)

    # -- cursor (the durability seam) -------------------------------------
    def _cursor_path(self, wid: str) -> str:
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in wid)
        return os.path.join(self.state_dir, f"replay-cursor-{safe}.json")

    def _load_cursor(self, wid: str, total: int) -> dict | None:
        if not self.state_dir:
            return None
        try:
            cur = durability.read_json_artifact(
                self._cursor_path(wid), artifact="replay_cursor")
        except FileNotFoundError:
            return None
        except (ValueError, durability.CorruptArtifactError):
            # main AND every retained generation failed to verify (or an
            # unframed legacy file held non-JSON bytes): the window
            # restarts from zero — re-joining is idempotent
            log.warning("replay cursor for window %s unrecoverable; "
                        "restarting the window", wid)
            return None
        if (not isinstance(cur, dict) or cur.get("window_id") != wid
                or int(cur.get("total", -1)) != total):
            return None  # a different window under the same id: restart
        return cur

    def _commit_cursor(self, wid: str, doc: dict) -> None:
        if self.state_dir:
            durability.write_json_artifact(
                self._cursor_path(wid), doc, artifact="replay_cursor")
        if self._g_cursor is not None and doc.get("last_seq") is not None:
            self._g_cursor.set(float(doc["last_seq"]))

    # -- the window drive ---------------------------------------------------
    def run_window(
        self,
        since_seq: int | None = None,
        until_seq: int | None = None,
        *,
        window: list[Mapping[str, Any]] | None = None,
        window_id: str | None = None,
        mode: str = "replay",
        threshold: float | None = None,
        score_fn: Callable[[np.ndarray], np.ndarray] | None = None,
        resume: bool = True,
    ) -> dict:
        """Replay one recorded window; returns the parity report.

        ``window`` overrides the segment scan (an explicit record list —
        the FlightRecorder path hands the ``bundle_window`` seq range to
        the scan instead). ``mode="whatif"`` diffs host-side under a
        ``threshold`` override and/or challenger ``score_fn`` without
        touching the bus. Kill-and-restart safe when ``resume`` (the
        default): the durable cursor skips completed batches."""
        recs = (list(window) if window is not None
                else self.audit.scan_window(since_seq, until_seq))
        recs.sort(key=lambda r: int(r.get("seq", -1)))
        rows = [r for r in recs if r.get("row") is not None]
        no_row = len(recs) - len(rows)
        if no_row:
            self._count_rows("no_row", no_row)
        wid = window_id or (
            f"{recs[0].get('seq', 0)}-{recs[-1].get('seq', 0)}"
            if recs else "empty")
        if mode == "whatif":
            return self._run_whatif(wid, rows, no_row, threshold, score_fn)
        return self._run_replay(wid, rows, no_row, resume)

    def _run_replay(self, wid: str, rows: list, no_row: int,
                    resume: bool) -> dict:
        t0 = self._clock()
        start = 0
        counts = {"match": 0, "divergence": 0, "drop": 0}
        causes: dict[str, int] = {}
        findings: list[dict] = []
        cur = self._load_cursor(wid, len(rows)) if resume else None
        if cur is not None:
            start = int(cur.get("next", 0))
            counts = dict(cur.get("counts", counts))
            causes = dict(cur.get("causes", {}))
            findings = list(cur.get("findings", []))
            log.info("replay window %s resuming at row %d/%d",
                     wid, start, len(rows))
        with self._cv:
            self._window_uids[wid] = {str(r.get("uid")) for r in rows}
            self._inbox.setdefault(wid, {})
            # the joined set rebuilds from the cursor: completed batches
            # must not re-join even if the live stack re-scores them
            self._joined[wid] = {str(r.get("uid")) for r in rows[:start]}
        prev_ceilings = []
        for target in (self.overload, self.gate):
            if target is not None:
                prev_ceilings.append((target, target.bulk_ceiling))
                target.set_bulk_ceiling(self.bulk_ceiling)
        stopped = False
        try:
            i = start
            while i < len(rows) and not self._stop.is_set():
                batch = rows[i:i + self.batch]
                bi = i // self.batch
                joined = self._drive_batch(wid, batch, bi)
                if self.crash_hook is not None:
                    self.crash_hook("joined", bi)
                for rec in batch:
                    uid = str(rec.get("uid"))
                    rep = joined.get(uid)
                    if rep is None:
                        counts["drop"] += 1
                        self._count_rows("drop", 1)
                        self._finding(findings, "drop", rec, None, None)
                        continue
                    cause = classify_divergence(rec, rep)
                    if cause is None:
                        counts["match"] += 1
                        self._count_rows("match", 1)
                    else:
                        counts["divergence"] += 1
                        causes[cause] = causes.get(cause, 0) + 1
                        self._count_rows("divergence", 1)
                        if self._c_div is not None:
                            self._c_div.inc(labels={"cause": cause})
                        self._finding(findings, "divergence", rec, rep,
                                      cause)
                i += len(batch)
                self._commit_cursor(wid, {
                    "window_id": wid, "total": len(rows), "next": i,
                    "counts": counts, "causes": causes,
                    "findings": findings[:MAX_FINDINGS],
                    "last_seq": (int(batch[-1].get("seq", -1))
                                 if batch else None),
                })
                if self.crash_hook is not None:
                    self.crash_hook("committed", bi)
                self._pace(len(batch), t0, i - start)
            stopped = i < len(rows)
        finally:
            for target, prev in prev_ceilings:
                target.set_bulk_ceiling(prev)
        with self._cv:
            ghosts = self._ghosts.pop(wid, [])
            self._window_uids.pop(wid, None)
            self._inbox.pop(wid, None)
            self._joined.pop(wid, None)
        for g in ghosts:
            self._count_rows("ghost", 1)
            self._finding(findings, "ghost", {"uid": g}, None, None)
        elapsed = max(1e-9, self._clock() - t0)
        replayed = counts["match"] + counts["divergence"]
        report = {
            "window_id": wid, "mode": "replay", "total": len(rows),
            "no_row": no_row, "resumed_at": start, "stopped": stopped,
            "replayed": replayed, "match": counts["match"],
            "divergence": counts["divergence"], "drop": counts["drop"],
            "ghost": len(ghosts), "dup": self._dups, "causes": causes,
            "parity": (counts["divergence"] == 0 and counts["drop"] == 0
                       and not ghosts and not stopped),
            "elapsed_s": elapsed,
            "rows_per_s": (replayed + counts["drop"]) / elapsed,
            "findings": findings[:MAX_FINDINGS],
        }
        if self._g_rate is not None:
            self._g_rate.set(report["rows_per_s"])
        if self._c_windows is not None and not stopped:
            self._c_windows.inc(labels={
                "result": "clean" if report["parity"] else "findings"})
        self.last_report = report
        return report

    def _drive_batch(self, wid: str, batch: list, bi: int) -> dict:
        """Produce one batch through the live bus at bulk priority and
        collect its verdicts. Re-production is at-least-once (bulk rows
        may legitimately shed under live load — that IS the SLO
        guarantee working), so unanswered rows retry up to
        ``retries``; the join stays exactly-once via the joined set."""
        pending = {str(r.get("uid")): r for r in batch}
        joined: dict[str, dict] = {}
        for attempt in range(self.retries + 1):
            if not pending or self._stop.is_set():
                break
            self._produce(wid, list(pending.values()))
            if self.crash_hook is not None and attempt == 0:
                self.crash_hook("produced", bi)
            deadline = time.monotonic() + self.timeout_s
            with self._cv:
                while pending:
                    box = self._inbox.get(wid, {})
                    for uid in list(pending):
                        rep = box.pop(uid, None)
                        if rep is not None:
                            joined[uid] = rep
                            self._joined.setdefault(wid, set()).add(uid)
                            del pending[uid]
                    if not pending:
                        break
                    left = deadline - time.monotonic()
                    if left <= 0 or self._stop.is_set():
                        break
                    self._cv.wait(min(left, 0.25))
            if pending and attempt < self.retries:
                log.info("replay window %s batch %d: %d rows unanswered, "
                         "re-producing (attempt %d)", wid, bi,
                         len(pending), attempt + 2)
        return joined

    def _produce(self, wid: str, batch: list) -> None:
        values = []
        keys = []
        for rec in batch:
            tx = dict(zip(FEATURE_NAMES, (float(v) for v in rec["row"])))
            tx["id"] = rec.get("tx")
            tx["_replay"] = {"w": wid, "uid": str(rec.get("uid"))}
            values.append(tx)
            keys.append(rec.get("tx"))
        self.broker.produce_batch(
            self.cfg.kafka_topic, values, keys=keys,
            headers={"priority": "bulk"})

    def _pace(self, batch_rows: int, t0: float, done_rows: int) -> None:
        if self.pacing_rows_s <= 0 or batch_rows <= 0:
            return
        # absolute schedule (rows done vs elapsed), so a slow batch
        # earns back its debt instead of compounding the delay
        ahead_s = done_rows / self.pacing_rows_s - (self._clock() - t0)
        if ahead_s > 0:
            self._stop.wait(min(ahead_s, 5.0))

    # -- what-if (backtest; never touches the live path) -------------------
    def _run_whatif(self, wid: str, rows: list, no_row: int,
                    threshold: float | None,
                    score_fn: Callable[[np.ndarray], np.ndarray] | None
                    ) -> dict:
        t0 = self._clock()
        flips = []
        n_flips = 0
        deltas = []
        for i in range(0, len(rows), self.batch):
            batch = rows[i:i + self.batch]
            x = np.asarray([r["row"] for r in batch], np.float32)
            if score_fn is not None:
                proba = np.asarray(score_fn(x), np.float64).reshape(-1)
            else:
                proba = np.asarray([float(r.get("proba", 0.0))
                                    for r in batch], np.float64)
            for rec, p in zip(batch, proba.tolist()):
                thr_rec = _thr(rec)
                thr_new = threshold if threshold is not None else thr_rec
                was = (thr_rec is not None
                       and float(rec.get("proba", 0.0)) >= thr_rec)
                now = thr_new is not None and p >= thr_new
                deltas.append(abs(p - float(rec.get("proba", 0.0))))
                if was != now:
                    n_flips += 1
                    if len(flips) < MAX_FINDINGS:
                        flips.append({
                            "uid": rec.get("uid"), "tx": rec.get("tx"),
                            "recorded": {"proba": rec.get("proba"),
                                         "threshold": thr_rec,
                                         "fraud": was},
                            "whatif": {"proba": p, "threshold": thr_new,
                                       "fraud": now},
                        })
        elapsed = max(1e-9, self._clock() - t0)
        report = {
            "window_id": wid, "mode": "whatif", "total": len(rows),
            "no_row": no_row, "threshold": threshold,
            "challenger": score_fn is not None, "flips": n_flips,
            "flip_rate": (n_flips / len(rows)) if rows else 0.0,
            "mean_abs_delta": (sum(deltas) / len(deltas)) if deltas
            else 0.0,
            "elapsed_s": elapsed, "rows_per_s": len(rows) / elapsed,
            "findings": flips,
        }
        self.last_report = report
        return report

    # -- findings / accounting ---------------------------------------------
    def _finding(self, findings: list, kind: str, rec, rep,
                 cause: str | None) -> None:
        if len(findings) >= MAX_FINDINGS:
            return
        f: dict[str, Any] = {"kind": kind, "uid": rec.get("uid"),
                             "tx": rec.get("tx"), "seq": rec.get("seq")}
        if cause is not None:
            f["cause"] = cause
        if rep is not None:
            f["recorded"] = {k: rec.get(k) for k in
                             ("proba", "rule", "branch", "tier",
                              "threshold", "hash") if rec.get(k) is not None}
            f["replayed"] = {k: rep.get(k) for k in
                             ("proba", "rule", "branch", "tier",
                              "threshold", "hash") if rep.get(k) is not None}
        findings.append(f)

    def _count_rows(self, outcome: str, n: int) -> None:
        if self._c_rows is not None and n > 0:
            self._c_rows.inc(n, labels={"outcome": outcome})

    # -- supervised-service surface ----------------------------------------
    def submit(self, **request) -> None:
        """Queue a window for the supervised run loop (the operator's
        component thread)."""
        with self._cv:
            self._requests.append(request)
            self._cv.notify_all()

    def reset(self) -> None:
        self._stop.clear()

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()

    def run(self, interval_s: float = 0.25) -> None:
        while not self._stop.is_set():
            with self._cv:
                req = self._requests.pop(0) if self._requests else None
                if req is None:
                    self._cv.wait(interval_s)
                    continue
            try:
                self.run_window(**req)
            except Exception:  # noqa: BLE001 - one bad window must not
                log.exception("replay window failed")  # kill the plane
