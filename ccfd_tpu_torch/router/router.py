"""Stream decision router: the reference's Camel/Fuse router, batched.

The port's copy of ccfd_tpu/router/router.py. The reference's router
consumes transactions from Kafka one message at a time, POSTs each to
Seldon, applies a Drools rule against ``FRAUD_THRESHOLD`` and starts a
"fraud" or "standard" process on the KIE server; it also forwards customer
responses from the response topic as process signals.

Here **the bus poll is the micro-batch**: each ``step()`` drains up to
``max_batch`` records within a poll deadline, decodes them into one
(B, 30) matrix and makes a single scorer dispatch (on the card, one launch
of the served kernel per bucket-sized chunk); the salience-ordered rules
then run vectorized over the returned probabilities, and the batch's
process starts go to the engine one call per fired rule. With a decision
plane (``decision_fn``, serving/fused.py) one dispatch returns the
probabilities and the fired rule indices together and the host rules pass
is skipped. The engine is in-process or a KIE-shaped REST client
(process/client.py).

Business counters keep the reference's names: ``transaction_incoming_total``,
``transaction_outgoing_total{type}``, ``notifications_outgoing_total``,
``notifications_incoming_total{response}``, and the router's own
``router_*`` series.

**Degradation ladder** (``degrade``; on when a ``host_score_fn`` or a
``breaker`` is given, and in the ``router`` role): a sick scorer edge
degrades the score instead of dropping the batch: scorer -> host numpy
forward (``host_score_fn``) -> rules-only conservative score, each row
counted in ``router_degraded_total{tier}`` (and the edge failure in
``router_score_errors_total``). A circuit breaker on the scorer edge skips
it while open; a reply of the wrong shape or with non-finite values counts
as an edge failure. These tiers run only after the edge failed or while the
breaker is open. Without the ladder a scorer failure drops that batch,
counted in ``router_score_errors_total``.

**Overload** (``overload``, runtime/overload.py): the poll is prepaid
against an adaptive AIMD budget, admission sheds by priority and deadline
(``router_shed_total``), and the dispatch watchdog bounds a scorer call,
its expiry falling into the ladder. Without it a static in-flight budget
(``max_inflight``) sheds the oldest records.

**Tracing** (``tracer``, observability/trace.py): each micro-batch resumes
the producer's trace from the record headers as ``router.batch`` with
``router.decode``, ``router.score`` and ``router.route`` children.

**Stage profiler** (``profiler``, observability/profile.py): per
micro-batch the router feeds the bus queueing delay (``bus``: the poll time
minus the records' produce timestamps), the decode and route service times
(``router.decode``, ``router.route``) and the scorer round trip
(``router.score``, dispatch), batch-size-conditioned, as the reference's.

**Heal gate** (``heal_gate`` / ``set_heal_gate``): an object with
``device_allowed()`` (and optionally ``host_allowed()``), checked before
the breaker: while the device is not allowed the ladder skips the scorer
edge, and the host tier too where ``host_allowed()`` is false (the storage
pin of runtime/durability.py), down to the rules tier. Without the ladder
a closed gate sends the batch to the rules tier.

**History-aware scorers**: a ``score_fn`` with ``score_with_ids(txs, x)``
(``serving/history.py::SeqScorer``) gets the decoded records with the
feature matrix, as in the reference.

**Decision provenance** (``audit``, observability/audit.py): armed, the
route seam stamps one record per successfully started transaction (tx id,
bus coordinate, produce time, p, rule, branch, engine pid, priority) with
the tier that produced the score (``device``, ``host`` or ``rules``) and,
on a degraded tier, its cause (``quarantine``, ``storage_pin``,
``breaker_open``, ``score_error``, ``watchdog_timeout``). A failed start is
not recorded. One ``AuditLog`` is shared by every ``ParallelRouter``
worker. For the replay plane (replay/service.py) the seam also embeds the
decoded feature row while the sink's ``capture_rows`` is armed, and
carries a replayed transaction's ``_replay`` marker onto its record as
``replay``, so the ``ReplayVerdictTap`` diverts the verdict to its join;
the replayed rows' ``bulk`` priority header rides into the record's
``priority`` as any other row's.

**Commit-after-route** (``commit_after_route``, the fleet's discipline):
the tx consumer runs manual-commit, and a batch's offsets commit only once
every record has a terminal disposition (routed, shed or counted error).
The positions are taken BEFORE admission, so shed rows commit with their
batch. A member killed mid-batch leaves the batch uncommitted, and it
redelivers to the partitions' next owner; the bus's epoch fence refuses a
deposed member's commit (``router_fenced_commits_total``), and a transport
error leaves the batch to redeliver (``router_commit_errors_total``). Off by
default: the single-process platform keeps the commit-on-poll hand-off.
"""

from __future__ import annotations

import contextlib
import logging
import operator
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np

from ccfd_tpu_torch import native
from ccfd_tpu_torch.bus.broker import Broker, StaleEpochError
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.process.fraud import CUSTOMER_RESPONSE_SIGNAL
from ccfd_tpu_torch.router.rules import RuleSet, default_rules

_SCHEMA_GETTER = operator.itemgetter(*FEATURE_NAMES)
_ZERO_ROW = (0.0,) * len(FEATURE_NAMES)
_NULL_CM = contextlib.nullcontext()


def default_scorer_breaker(registry):
    """The scorer-edge breaker the ladder builds when none is given: one
    definition, so a Router and a ParallelRouter degrade alike."""
    from ccfd_tpu_torch.runtime.breaker import CircuitBreaker

    return CircuitBreaker(edge="scorer", registry=registry, min_calls=3,
                          failure_ratio=0.5, cooldown_s=1.0)


class InflightBudget:
    """Consumed-but-unrouted row budget, shareable across router workers
    (a ParallelRouter hands every worker one, so the bound is global).
    ``reserve`` grants up to ``n`` rows and the caller sheds the rest;
    ``release`` returns rows once they are routed (or dropped). With a
    ``registry`` the limit and its use export as ``ccfd_inflight_limit`` /
    ``ccfd_inflight_used`` gauges."""

    __slots__ = ("limit", "_n", "_mu", "_g_limit", "_g_used", "_stage")

    def __init__(self, limit: int, registry=None, stage: str = "router"):
        self.limit = int(limit)
        self._n = 0
        self._mu = threading.Lock()
        self._stage = {"stage": stage}
        self._g_limit = self._g_used = None
        if registry is not None:
            self._g_limit = registry.gauge(
                "ccfd_inflight_limit",
                "in-flight row budget per stage (adaptive when the overload "
                "plane is armed)")
            self._g_used = registry.gauge(
                "ccfd_inflight_used", "in-flight rows reserved per stage")
            self._set_gauges_locked()

    def _set_gauges_locked(self) -> None:
        if self._g_limit is not None:
            self._g_limit.set(self.limit, labels=self._stage)
            self._g_used.set(self._n, labels=self._stage)

    def reserve(self, n: int) -> int:
        """Take up to ``n`` rows from the budget; returns rows granted."""
        with self._mu:
            take = min(n, max(0, self.limit - self._n))
            self._n += take
            self._set_gauges_locked()
            return take

    def try_reserve(self, n: int, ceiling: float = 1.0) -> bool:
        """All-or-nothing reserve: grant only while the utilization after
        the grant stays at or under ``ceiling``. An idle stage always
        grants, so a lone request bigger than the limit still runs."""
        with self._mu:
            if self._n == 0 or self._n + n <= int(self.limit * ceiling):
                self._n += n
                self._set_gauges_locked()
                return True
            return False

    def release(self, n: int) -> None:
        with self._mu:
            self._n = max(0, self._n - n)
            self._set_gauges_locked()

    def room(self) -> int:
        """Rows the budget could grant now."""
        with self._mu:
            return max(0, self.limit - self._n)

    @property
    def inflight(self) -> int:
        return self._n


def _decode_row_lenient(tx: Any, out_row: np.ndarray) -> int:
    """Field-by-field decode for rows the fast path rejected; returns #bad."""
    if not (type(tx) is dict or isinstance(tx, Mapping)):
        return 1
    bad = 0
    for j, name in enumerate(FEATURE_NAMES):
        v = tx.get(name)
        if v is None:
            continue
        try:
            out_row[j] = float(v)
        except (TypeError, ValueError):
            bad += 1
    return bad


def decode_features(values: list[Mapping[str, Any]]) -> tuple[np.ndarray, int]:
    """Transaction dicts -> ((B, 30) float32 matrix in schema order, #bad fields).

    Well-formed transactions carry the full schema, so one ``itemgetter``
    call per row pulls all 30 fields and ONE ``np.asarray`` converts the
    batch. Malformed rows (missing fields, non-numeric values,
    non-mappings) take a field-by-field lenient decode: a bad field decodes
    to 0.0 instead of raising, so a poison pill cannot stop the loop."""
    n = len(values)
    rows: list[tuple] = []
    slow: list[int] = []
    for i, tx in enumerate(values):
        try:
            rows.append(_SCHEMA_GETTER(tx))
        except (KeyError, TypeError):
            rows.append(_ZERO_ROW)
            slow.append(i)
    try:
        out = np.asarray(rows, np.float32)
        if out.shape != (n, len(FEATURE_NAMES)):
            raise ValueError("ragged rows")
    except (TypeError, ValueError):
        # some row carried an unparseable value: redo per row, diverting
        # failures to the lenient path
        out = np.zeros((n, len(FEATURE_NAMES)), np.float32)
        fast_ok = set(range(n)) - set(slow)
        slow = list(slow)
        for i in sorted(fast_ok):
            try:
                out[i] = np.asarray(rows[i], np.float32)
            except (TypeError, ValueError):
                slow.append(i)
    bad = 0
    for i in slow:
        out[i] = 0.0
        bad += _decode_row_lenient(values[i], out[i])
    return out, bad


def decode_csv(data: bytes, n_features: int = len(FEATURE_NAMES)) -> tuple[np.ndarray, int]:
    """Newline-separated CSV float rows -> ((B, F) float32, #bad rows), by
    the native decoder (``native.decode_csv``, the reference's C++ one). A
    row with the wrong field count or a field that is not a number decodes
    to zeros and counts as bad."""
    return native.decode_csv(data, n_features)


def decode_records(records) -> tuple[np.ndarray, list[Mapping[str, Any]], int]:
    """Bus records -> ((B, 30) matrix, per-row tx dicts, #malformed fields).

    Two wire formats share a batch: dict transactions and raw CSV lines
    (one record, one row; an embedded newline keeps the first line and
    counts the rest as bad). Rows keep their arrival order; a poison pill
    decodes to an all-zero row rather than crashing the loop."""
    n = len(records)
    x = np.zeros((n, len(FEATURE_NAMES)), np.float32)
    txs: list[Mapping[str, Any]] = [{}] * n
    bad = 0
    dict_rows: list[int] = []
    dict_vals: list[Mapping[str, Any]] = []
    csv_rows: list[int] = []
    csv_lines: list[bytes] = []
    for i, rec in enumerate(records):
        v = rec.value
        tv = type(v)
        if tv is dict:
            dict_rows.append(i)
            dict_vals.append(v)
        elif tv is bytes or tv is str or isinstance(v, (bytes, str)):
            raw = v.encode() if isinstance(v, str) else v
            if raw.find(b"\n") >= 0:
                lines = raw.splitlines() or [b""]
                bad += len(lines) - 1
                raw = lines[0]
            csv_rows.append(i)
            csv_lines.append(raw)
        elif isinstance(v, Mapping):  # non-dict mappings: same dict path
            dict_rows.append(i)
            dict_vals.append(v)
        else:  # poison pill: score as all-zeros rather than crash the loop
            bad += 1
    if dict_vals:
        xd, bad_fields = decode_features(dict_vals)
        bad += bad_fields
        if len(dict_vals) == n:  # homogeneous batch: no row scatter needed
            x = xd
            txs = dict_vals
        else:
            x[dict_rows] = xd
            for j, i in enumerate(dict_rows):
                txs[i] = dict_vals[j]
    if csv_lines:
        xc, bad_csv = decode_csv(b"\n".join(csv_lines) + b"\n", len(FEATURE_NAMES))
        bad += bad_csv
        amount_col = FEATURE_NAMES.index("Amount")
        if xc.shape[0] == n and len(csv_lines) == n:
            x = np.ascontiguousarray(xc, np.float32)
        else:
            for j, i in enumerate(csv_rows):
                if j < xc.shape[0]:
                    x[i] = xc[j]
        amounts = (x[:, amount_col][csv_rows].tolist() if len(csv_rows) != n
                   else x[:, amount_col].tolist())
        for i, amt in zip(csv_rows, amounts):
            txs[i] = {"id": records[i].key, "Amount": amt}
    return x, txs, bad


class Router:
    def __init__(
        self,
        cfg: Config,
        broker: Broker,
        score_fn: Callable[[np.ndarray], np.ndarray],
        engine: Any,
        registry: Registry | None = None,
        max_batch: int = 4096,
        rules: RuleSet | None = None,
        host_score_fn: Callable[[np.ndarray], np.ndarray] | None = None,
        breaker: Any = None,
        degrade: bool | None = None,
        max_inflight: int | None = None,
        tracer: Any = None,
        inflight_budget: InflightBudget | None = None,
        worker_id: int | None = None,
        overload: Any = None,
        decision_fn: Any = None,
        profiler: Any = None,
        heal_gate: Any = None,
        audit: Any = None,
        commit_after_route: bool = False,
    ):
        self.cfg = cfg
        self._profiler = profiler
        self._heal_gate = heal_gate
        # the decision provenance plane (observability/audit.py AuditLog):
        # armed, the route seam stamps one record per routed transaction;
        # the tier that produced the score rides a per-batch meta dict, so
        # the pipelined loop's concurrent score and route stages never
        # cross batches. None costs one attribute read per batch.
        self._audit = audit
        self._rec_pri = self._pri_names = None
        if audit is not None:
            # lazy: runtime/overload.py imports this module
            from ccfd_tpu_torch.runtime.overload import PRIORITY_NAMES, record_priority

            self._pri_names = PRIORITY_NAMES
            self._rec_pri = record_priority
        self.broker = broker
        self.score = score_fn
        self.tracer = tracer
        # history-aware scorers (serving/history.py SeqScorer) score each
        # transaction against its customer's history: they expose
        # score_with_ids(txs, x), and the router feeds them the decoded
        # records alongside the feature matrix; plain scorers get (x,)
        score_with_ids = getattr(score_fn, "score_with_ids", None)
        if callable(score_with_ids):
            self._score2 = lambda x, txs: (np.asarray(score_with_ids(txs, x)), None)
        else:
            self._score2 = lambda x, txs: (np.asarray(self.score(x)), None)
        self.engine = engine
        self.registry = registry or Registry()
        self.max_batch = max_batch
        # precedence: explicit arg > CCFD_RULES file > the threshold rule
        if rules is None:
            rules = (RuleSet.from_file(cfg.rules_file) if cfg.rules_file
                     else default_rules(cfg.fraud_threshold))
        self.rules = rules
        # the decision plane replaces the score seam: (proba, fired). Its
        # plan must have been compiled from THIS router's rule base, or the
        # fired indices would index a different rule table
        if decision_fn is not None:
            if decision_fn.rules is not self.rules:
                logging.getLogger("ccfd_tpu_torch.router").warning(
                    "decision_fn was compiled against a different RuleSet "
                    "than this router serves; fused decisions disarmed — "
                    "pass the same RuleSet instance to both")
                decision_fn = None
            else:
                dec = decision_fn.decide
                self._score2 = lambda x, txs: dec(x)
        self._decision_fn = decision_fn
        self._check_rule_targets(engine)
        self._commit_after_route = bool(commit_after_route)
        # the poll epoch of the batch whose rows the audit seam is recording
        # (read by the fleet ledger tap during record_batch)
        self.batch_epoch: int | None = None
        # manual=True marks the consumer built auto_commit=False when
        # commit-after-route is armed (here and in recycle_consumers)
        self._consumer_specs = (
            ("_tx_consumer", "router", (cfg.kafka_topic,), True),
            ("_resp_consumer", "router-responses", (cfg.customer_response_topic,), False),
            ("_notif_watcher", "router-notifications",
             (cfg.customer_notification_topic,), False),
        )
        for attr, group, topics, manual in self._consumer_specs:
            setattr(self, attr, self._build_consumer(group, topics, manual))

        r = self.registry
        self._c_in = r.counter("transaction_incoming_total", "transactions consumed")
        self._c_out = r.counter("transaction_outgoing_total", "process starts by type")
        self._c_notif_out = r.counter(
            "notifications_outgoing_total", "customer notifications observed")
        self._c_notif_in = r.counter(
            "notifications_incoming_total", "customer responses by result")
        self._h_batch = r.histogram("router_batch_size", "scoring batch sizes",
                                    buckets=(1, 8, 64, 256, 1024, 4096, 16384))
        self._c_decode_err = r.counter(
            "transaction_decode_errors_total", "malformed transaction fields")
        self._h_score_s = r.histogram("router_score_seconds", "scorer dispatch latency")
        # wall time from a record's PRODUCE timestamp to its process-start
        # decision: queueing + micro-batching + scoring + rules + engine
        self._h_decision_s = r.histogram(
            "router_decision_seconds", "producer->process-start decision latency")
        self._c_rule = r.counter("router_rule_fired_total", "rule activations")
        self._c_start_err = r.counter(
            "router_process_start_errors_total", "failed process starts")
        self._c_signal_err = r.counter(
            "router_signal_errors_total", "failed signal forwards")
        self._c_score_err = r.counter(
            "router_score_errors_total",
            "scorer-edge failures: transactions dropped, or absorbed by degraded "
            "tiers when the ladder is on")
        self._c_host_err = r.counter(
            "router_host_score_errors_total",
            "host-tier forward failures while the ladder was already degraded "
            "(the fall continues to the rules tier)")
        self._c_degraded = r.counter(
            "router_degraded_total",
            "transactions scored by a degraded tier (host numpy forward or rules-only)")
        self._c_shed = r.counter(
            "router_shed_total",
            "transactions dropped by bounded-in-flight load shedding (oldest first)")
        self._c_worker_batch = r.counter(
            "router_worker_batches_total",
            "scoring batches per router worker loop (worker 0 == a single router)")
        self._c_fenced = r.counter(
            "router_fenced_commits_total",
            "post-route offset commits refused by the bus epoch fence (group "
            "rebalanced mid-batch): the batch redelivers to the partitions' new "
            "owners — an at-least-once duplicate, never a drop")
        self._c_commit_err = r.counter(
            "router_commit_errors_total",
            "post-route offset commits lost to bus transport errors (not fences): "
            "the batch stays uncommitted and redelivers")
        # -- degradation ladder --------------------------------------------
        self._host_score = host_score_fn
        self._degrade = (degrade if degrade is not None
                         else (host_score_fn is not None or breaker is not None))
        self._breaker = breaker
        if self._degrade and breaker is None:
            self._breaker = default_scorer_breaker(r)
        self.max_inflight = (int(max_inflight) if max_inflight is not None
                             else 2 * max_batch)
        # the in-flight budget: private by default; a ParallelRouter (or the
        # overload plane) hands every worker the same one
        self._overload = overload
        if inflight_budget is not None:
            self._budget = inflight_budget
        elif overload is not None:
            self._budget = overload.budget
        else:
            self._budget = InflightBudget(self.max_inflight, registry=r)
        self.worker_id = worker_id
        self._worker_labels = {"worker": str(worker_id or 0)}
        self._amount_idx = FEATURE_NAMES.index("Amount")
        self._stop = threading.Event()
        # the batch-boundary barrier: pause() parks the loop with every
        # consumed record routed; holds nest (reference-counted)
        self._pause_req = threading.Event()
        self._pause_ack = threading.Event()
        self._pause_mu = threading.Lock()
        self._pause_holders = 0

    # -- commit-after-route ------------------------------------------------
    def _build_consumer(self, group: str, topics: tuple, manual: bool):
        """One bus consumer; the tx consumer (``manual``) is built
        ``auto_commit=False`` when commit-after-route is armed."""
        if manual and self._commit_after_route:
            return self.broker.consumer(group, topics, auto_commit=False)
        return self.broker.consumer(group, topics)

    def _tx_offsets(self, records: list) -> dict[tuple[str, int], int] | None:
        """Commit positions of one poll's records (max offset + 1 per topic
        partition), taken before admission: shed records are disposed and
        commit with their batch. None when commit-after-route is off (the
        hot loop pays nothing for it)."""
        if not records or not self._commit_after_route:
            return None
        offs: dict[tuple[str, int], int] = {}
        for r in records:
            tp = (r.topic, r.partition)
            nxt = r.offset + 1
            if nxt > offs.get(tp, 0):
                offs[tp] = nxt
        return offs

    def _commit_routed(self, offs: dict | None) -> None:
        """Commit a fully disposed batch (manual mode only). A fence is
        counted and absorbed: the records redeliver to the partitions'
        current owners. A transport error leaves the batch uncommitted."""
        if not self._commit_after_route or offs is None:
            return
        try:
            self._tx_consumer.commit(offs)
        except StaleEpochError:
            self._c_fenced.inc()
        except Exception:  # noqa: BLE001 - bus edge down: counted, the batch redelivers
            self._c_commit_err.inc()

    def _check_rule_targets(self, engine: Any) -> None:
        """Fail fast on a rule naming a process the engine lacks (a REST
        engine lists no definitions; the start errors count instead)."""
        list_defs = getattr(engine, "definitions", None)
        if callable(list_defs):
            known = set(list_defs())
            missing = {r.process for r in self.rules.rules} - known
            if missing:
                raise ValueError(
                    f"rules reference unregistered processes {sorted(missing)}; "
                    f"engine has {sorted(known)}")

    # -- loop stages (composed by step() and the pipelined run loop) -------
    def _drain_signals(self) -> None:
        """Notification-counter drain + customer-response signal forwarding."""
        for _rec in self._notif_watcher.poll(self.max_batch, 0.0):
            self._c_notif_out.inc()
        for rec in self._resp_consumer.poll(self.max_batch, 0.0):
            payload = rec.value or {}
            approved = bool(payload.get("approved"))
            self._c_notif_in.inc(
                labels={"response": "approved" if approved else "non_approved"})
            pid = payload.get("process_id")
            if pid is not None:
                try:
                    self.engine.signal(int(pid), CUSTOMER_RESPONSE_SIGNAL, payload)
                except Exception:  # noqa: BLE001 - the rest must still forward
                    self._c_signal_err.inc()

    def _poll_batch(self, poll_timeout_s: float) -> list:
        """Size x deadline micro-batching: after the first records arrive,
        keep accumulating until the batch fills or ``batch_deadline_ms``
        elapses. With the overload plane the poll is prepaid: the loop
        reserves budget before consuming and polls at most the grant, so
        with no room the backlog stays on the bus."""
        cap = self.max_batch
        granted = -1
        if self._overload is not None:
            granted = self._budget.reserve(self.max_batch)
            if granted <= 0:
                if poll_timeout_s > 0:
                    time.sleep(min(poll_timeout_s, 0.02))
                return []
            cap = granted
        records = self._tx_consumer.poll(cap, poll_timeout_s)
        if records:
            deadline_s = self.cfg.batch_deadline_ms / 1e3
            if deadline_s > 0 and len(records) < cap:
                deadline = time.perf_counter() + deadline_s
                while len(records) < cap:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    more = self._tx_consumer.poll(cap - len(records), remaining)
                    if not more:
                        break
                    records.extend(more)
        if granted >= 0 and granted > len(records):
            self._budget.release(granted - len(records))
        return records

    # -- tracing -------------------------------------------------------------
    def _begin_batch_span(self, records: list):
        """The micro-batch span, parented on the trace context the producer
        stamped on the records (the first stamped record wins); None when
        tracing is off."""
        if self.tracer is None:
            return None
        from ccfd_tpu_torch.observability.trace import extract_context

        parent = None
        for rec in records[:16]:
            h = getattr(rec, "headers", None)
            if h:
                parent = extract_context(h)
                if parent is not None:
                    break
        attrs: dict = {"records": len(records)}
        if self.worker_id is not None:
            attrs["worker"] = self.worker_id
        return self.tracer.start("router.batch", parent=parent, attrs=attrs)

    def _decode_batch(self, records: list, batch_span=None) -> tuple[np.ndarray, list, np.ndarray]:
        n = len(records)
        self._c_in.inc(n)
        self._h_batch.observe(n)
        self._c_worker_batch.inc(labels=self._worker_labels)
        span_cm = (self.tracer.span("router.decode", parent=batch_span.context)
                   if batch_span is not None else _NULL_CM)
        t0 = time.perf_counter()
        with span_cm:
            x, txs, bad = decode_records(records)
        if bad:
            self._c_decode_err.inc(bad)
        # produce timestamps ride along for the decision latency
        ts = np.fromiter((r.timestamp for r in records), np.float64, n)
        if self._profiler is not None or batch_span is not None:
            # bus queueing delay: mean wait of the batch's rows on the topic
            # ccfd-lint: disable=monotonic-durations -- record timestamps are wall-clock by contract (cross-process); max(0,...) clamps an NTP step
            queue_s = max(0.0, time.time() - float(ts.mean()))
            if batch_span is not None:
                batch_span.attrs["queue_s"] = queue_s
            if self._profiler is not None:
                self._profiler.observe("bus", queue_s=queue_s, rows=n)
                self._profiler.observe("router.decode", service_s=time.perf_counter() - t0,
                                       batch=n, rows=n)
        return x, txs, ts

    # -- decision provenance -------------------------------------------------
    def _audit_meta(self, records: list) -> dict | None:
        """Per-batch audit context, built while the bus records (the only
        carriers of partition/offset and priority headers) are in scope; it
        rides WITH the batch through score and route."""
        if self._audit is None:
            return None
        names, pri = self._pri_names, self._rec_pri
        return {
            "uids": [f"{r.partition}:{r.offset}" for r in records],
            "pris": [names[pri(r)] for r in records],
            "events": [],
            "tier": "device",
            "cause": None,
            # the group epoch this batch was polled under (the fleet ledger's
            # stamp); a pipelined loop may poll, and adopt a newer epoch,
            # before this batch routes
            "epoch": getattr(self._tx_consumer, "epoch", None),
        }

    # -- admission -----------------------------------------------------------
    def _shed_oldest(self, records: list) -> list:
        """Bounded in-flight: drop the OLDEST consumed records when a poll
        would push consumed-but-unrouted work past the budget. Shed records
        still count as incoming; ``router_shed_total`` counts the drops. The
        survivors' rows stay reserved until they are routed."""
        granted = self._budget.reserve(len(records))
        if granted == len(records):
            return records
        shed = len(records) - granted
        self._c_in.inc(shed)
        self._c_shed.inc(shed)
        return records[shed:] if granted else []

    def _admit(self, records: list) -> list:
        """Admission for one poll: deadline- and priority-aware with the
        overload plane, else the oldest-first shed. The budget ends up
        reserved for exactly the survivors."""
        if self._overload is None:
            return self._shed_oldest(records)
        keep, shed = self._overload.admit(records, prepaid=True)
        if shed:
            self._c_in.inc(shed)
            self._c_shed.inc(shed)
        return keep

    # -- degradation ladder --------------------------------------------------
    def _rules_proba(self, x: np.ndarray) -> np.ndarray:
        """Rules-only tier, no model: a transaction at or above
        CCFD_LOW_AMOUNT takes p exactly at FRAUD_THRESHOLD (so the fraud
        rule fires: investigate, the conservative failure), the rest 0."""
        thr = np.float32(self.cfg.fraud_threshold)
        risky = x[:, self._amount_idx] >= self.cfg.low_amount_threshold
        return np.where(risky, thr, np.float32(0.0)).astype(np.float32)

    def _score_tiered(self, x: np.ndarray, txs: list, span=None, meta=None) -> tuple:
        """scorer -> host numpy forward -> rules-only. Never raises. Returns
        ``(proba, fired)``; the lower tiers return fired=None, so the host
        rule base decides their rows. A closed heal gate skips the scorer
        edge (before the breaker, so not even a half-open probe reaches the
        device), and the host tier too where its ``host_allowed`` is false.
        ``meta`` (the audit plane armed) records the tier that produced the
        batch's scores and why the ladder fell."""
        br = self._breaker
        gate = self._heal_gate
        host_blocked = False
        if gate is not None and not gate.device_allowed():
            if span is not None:
                span.attrs["quarantined"] = True
            host_ok = getattr(gate, "host_allowed", None)
            host_blocked = callable(host_ok) and not host_ok()
            if meta is not None:
                meta["cause"] = "storage_pin" if host_blocked else "quarantine"
        elif br is None or br.allow():
            t0 = time.perf_counter()
            try:
                ov = self._overload
                if ov is not None and ov.dispatch_deadline_s > 0:
                    # the dispatch watchdog: a hung dispatch raises here
                    proba, fired = ov.bounded_dispatch(lambda: self._score2(x, txs))
                else:
                    proba, fired = self._score2(x, txs)
                lat = time.perf_counter() - t0
                # a reply of the wrong shape or with non-finite values is an
                # edge failure, not a decision
                if proba.shape != (len(txs),) or not np.isfinite(proba).all():
                    raise ValueError("invalid scorer response")
                if fired is not None and (
                        getattr(fired, "shape", None) != (len(txs),)
                        or int(fired.min()) < 0
                        or int(fired.max()) >= len(self.rules.rules)):
                    raise ValueError("invalid scorer response")
                if br is not None:
                    br.record_success(lat)
                return proba, fired
            except Exception as e:  # noqa: BLE001 - counted; falls down the ladder
                if br is not None:
                    br.record_failure(time.perf_counter() - t0)
                self._c_score_err.inc(len(txs))
                if meta is not None:
                    # a watchdog kill is its own event class: the record says
                    # the decision fell because the dispatch was killed
                    ev = ("watchdog_timeout" if type(e).__name__ == "ScorerTimeout"
                          else "score_error")
                    meta["events"].append(ev)
                    meta["cause"] = meta["cause"] or ev
        else:
            if span is not None:
                span.attrs["breaker_open"] = True
            if meta is not None:
                meta["events"].append("breaker_open")
                meta["cause"] = meta["cause"] or "breaker_open"
        if self._host_score is not None and not host_blocked:
            try:
                proba = np.asarray(self._host_score(x), np.float32)
                if proba.shape == (len(txs),) and np.isfinite(proba).all():
                    self._c_degraded.inc(len(txs), labels={"tier": "host"})
                    if span is not None:
                        span.attrs["degraded"] = "host"
                    if meta is not None:
                        meta["tier"] = "host"
                    return proba, None
            except Exception:  # noqa: BLE001 - counted; falls to the rules tier
                self._c_host_err.inc(len(txs))
        self._c_degraded.inc(len(txs), labels={"tier": "rules"})
        if span is not None:
            span.attrs["degraded"] = "rules"
        if meta is not None:
            meta["tier"] = "rules"
        return self._rules_proba(x), None

    def _score_direct(self, x: np.ndarray, txs: list, span=None, meta=None) -> tuple:
        """The non-ladder path; a closed heal gate still binds: the rules
        tier decides the batch, counted."""
        gate = self._heal_gate
        if gate is not None and not gate.device_allowed():
            if span is not None:
                span.attrs["quarantined"] = True
                span.attrs["degraded"] = "rules"
            if meta is not None:
                meta["tier"] = "rules"
                meta["cause"] = "quarantine"
            self._c_degraded.inc(len(txs), labels={"tier": "rules"})
            return self._rules_proba(x), None
        return self._score2(x, txs)

    def _score_batch(self, x: np.ndarray, txs: list, batch_span=None, meta=None) -> tuple:
        if batch_span is not None:
            with self.tracer.span("router.score", parent=batch_span.context) as sp:
                if self._degrade:
                    return self._score_tiered(x, txs, span=sp, meta=meta)
                return self._score_direct(x, txs, span=sp, meta=meta)
        if self._degrade:
            return self._score_tiered(x, txs, meta=meta)
        return self._score_direct(x, txs, meta=meta)

    def _timed_score(self, x: np.ndarray, txs: list, batch_span=None, meta=None) -> tuple:
        """Score one batch and record the stage latency (histogram, with the
        trace id as exemplar, and the AIMD feedback)."""
        t0 = time.perf_counter()
        proba, fired = self._score_batch(x, txs, batch_span, meta)
        score_s = time.perf_counter() - t0
        self._h_score_s.observe(
            score_s,
            exemplar={"trace_id": batch_span.trace_id} if batch_span is not None else None)
        if self._overload is not None:
            self._overload.observe_stage(score_s)
        if self._profiler is not None:
            self._profiler.observe("router.score", dispatch_s=score_s,
                                   batch=len(txs), rows=len(txs))
        return proba, fired

    # -- one synchronous cycle (used by tests and the run loop) ------------
    def step(self, poll_timeout_s: float = 0.0) -> int:
        """Route one poll's worth of work; returns #transactions scored.
        Without the ladder a scorer failure raises here (``run`` drops and
        counts the batch)."""
        self._drain_signals()
        records = self._poll_batch(poll_timeout_s)
        if not records:
            return 0
        offs = self._tx_offsets(records)
        records = self._admit(records)
        if not records:
            self._commit_routed(offs)  # fully shed: every record disposed
            return 0
        batch_sp = None
        meta = self._audit_meta(records)
        try:
            batch_sp = self._begin_batch_span(records)
            x, txs, ts = self._decode_batch(records, batch_sp)
            proba, fired = self._timed_score(x, txs, batch_sp, meta)
            n = self._route(x, txs, proba, ts, batch_sp, fired, meta)
            # only after every record has a terminal disposition: a crash
            # above leaves the batch uncommitted, so it redelivers
            self._commit_routed(offs)
            return n
        except BaseException:
            if batch_sp is not None:  # a crashed batch: keep its trace
                batch_sp.status = "error"
            raise
        finally:
            self._budget.release(len(records))
            if batch_sp is not None:
                self.tracer.finish(batch_sp)

    def _route(self, x: np.ndarray, txs: list, proba: np.ndarray,
               ts: np.ndarray | None, batch_span=None,
               fired: np.ndarray | None = None, meta=None) -> int:
        t0 = time.perf_counter()
        try:
            if batch_span is None:
                return self._route_inner(x, txs, proba, ts, fired, None, meta)
            route_sp = self.tracer.start("router.route", parent=batch_span.context)
            try:
                # activated on this thread: the engine's notification produce
                # (process/fraud.py) reads the current context to join the trace
                with self.tracer.activate(route_sp.context):
                    return self._route_inner(x, txs, proba, ts, fired, route_sp, meta,
                                             batch_span.trace_id)
            finally:
                self.tracer.finish(route_sp)
        finally:
            if self._profiler is not None:
                self._profiler.observe("router.route", service_s=time.perf_counter() - t0,
                                       batch=len(txs), rows=len(txs))

    def _route_inner(self, x: np.ndarray, txs: list, proba: np.ndarray,
                     ts: np.ndarray | None, fired: np.ndarray | None = None,
                     route_sp=None, meta=None, trace_id: str | None = None) -> int:
        if fired is None:
            fired = self.rules.evaluate(x, proba)
        # group the micro-batch by fired rule: one batched process start per
        # (rule, process) instead of one engine call per transaction
        groups: dict[int, list[dict]] = {}
        rules = self.rules.rules
        plist = proba.tolist()
        # the audit plane armed: each group's original row indices, so a
        # successful start stamps THAT row's tx, uid, priority and
        # timestamp; only successful starts are recorded (routed ==
        # recorded; a failed start counts in router_process_start_errors_total)
        gidx: dict[int, list[int]] | None = (
            {} if (self._audit is not None and meta is not None) else None)
        audit_rows: list[dict] = []
        ts_list = ts.tolist() if gidx is not None and ts is not None else None
        # the replay plane armed: embed the DECODED feature row per record
        # (one tolist outside the loop; off, nothing)
        x_list = (x.tolist() if gidx is not None
                  and getattr(self._audit, "capture_rows", False) else None)
        for i, (tx, p, ridx) in enumerate(zip(txs, plist, fired.tolist())):
            variables = {"transaction": tx, "proba": p, "customer_id": tx.get("id")}
            set_vars = rules[ridx].set_vars
            if set_vars:
                variables.update(set_vars)
            g = groups.get(ridx)
            if g is None:
                groups[ridx] = [variables]
            else:
                g.append(variables)
            if gidx is not None:
                gi = gidx.get(ridx)
                if gi is None:
                    gidx[ridx] = [i]
                else:
                    gi.append(i)
        for ridx, vars_list in groups.items():
            rule = rules[ridx]
            try:
                # a fresh dict per transaction: an in-process engine adopts
                # it uncopied
                pids = self.engine.start_process_batch(rule.process, vars_list,
                                                       copy_vars=False)
            except Exception:  # noqa: BLE001 - the other groups must still start
                self._c_start_err.inc(len(vars_list), labels={"type": rule.process})
                continue
            n_err = sum(1 for p in pids if p is None)
            if n_err:
                self._c_start_err.inc(n_err, labels={"type": rule.process})
            n_ok = len(pids) - n_err
            if n_ok:
                self._c_out.inc(n_ok, labels={"type": rule.process})
                self._c_rule.inc(n_ok, labels={"rule": rule.name})
                if route_sp is not None and "fraud" in rule.process:
                    route_sp.attrs["fraud"] = True  # always tail-sampled keep
                if gidx is not None:
                    idx_list = gidx[ridx]
                    for j, pid in enumerate(pids):
                        if pid is None:
                            continue
                        i = idx_list[j]
                        row = {
                            "tx": txs[i].get("id"),
                            "uid": meta["uids"][i],
                            "ts": ts_list[i] if ts_list is not None else None,
                            "proba": plist[i],
                            "rule": rule.name,
                            "branch": rule.process,
                            "pid": pid,
                            "priority": meta["pris"][i],
                        }
                        # a replayed transaction's origin marker, so the
                        # verdict tap diverts it to the parity join
                        mk = txs[i].get("_replay")
                        if mk is not None:
                            row["replay"] = mk
                        if x_list is not None:
                            row["row"] = x_list[i]
                        audit_rows.append(row)
        if audit_rows:
            self.batch_epoch = meta.get("epoch")
            self._audit.record_batch(
                audit_rows,
                tier=meta.get("tier", "device"),
                cause=meta.get("cause"),
                events=tuple(meta.get("events", ())),
                worker=self.worker_id,
                trace_id=trace_id,
                threshold=self.cfg.fraud_threshold,
            )
        if ts is not None and len(ts):
            # produce stamps are wall-clock record timestamps
            # ccfd-lint: disable=monotonic-durations -- produce stamps are wall-clock record timestamps (cross-process decision latency)
            self._h_decision_s.observe_many(time.time() - ts)
        return len(txs)

    # -- checkpoint barrier (ParallelRouter's group-wide pause) ------------
    def pause(self, timeout_s: float = 10.0) -> bool:
        """Request a batch-boundary hold and wait for the loop's ack; on
        True every consumed record is routed until :meth:`resume`. Holds
        nest."""
        self.request_pause()
        return self.await_pause(timeout_s)

    def request_pause(self) -> None:
        """Take a hold and signal the loop without waiting for the ack."""
        with self._pause_mu:
            self._pause_holders += 1
            self._pause_req.set()

    def await_pause(self, timeout_s: float) -> bool:
        return self._pause_ack.wait(timeout=timeout_s)

    def resume(self) -> None:
        with self._pause_mu:
            if self._pause_holders > 0:
                self._pause_holders -= 1
            if self._pause_holders == 0:
                self._pause_req.clear()

    def _pause_point(self) -> None:
        """Called by the run loop at a batch boundary."""
        self._pause_ack.set()
        while self._pause_req.is_set() and not self._stop.is_set():
            time.sleep(0.005)
        self._pause_ack.clear()

    def recycle_consumers(self) -> None:
        """Close and recreate the bus consumers (loop parked or stopped);
        they resume at the committed offsets, like any group member."""
        for attr, group, topics, manual in self._consumer_specs:
            try:
                getattr(self, attr).close()
            except Exception:  # noqa: BLE001 - a dead consumer is fine here
                logging.getLogger("ccfd_tpu_torch.router").debug(
                    "stale consumer %s failed to close during recycle", attr,
                    exc_info=True)
            setattr(self, attr, self._build_consumer(group, topics, manual))

    def set_heal_gate(self, gate: Any) -> None:
        """Arm (or, with None, disarm) the heal gate after construction; the
        next batch sees it."""
        self._heal_gate = gate

    def swap_engine(self, engine: Any) -> None:
        """Point the router at a replacement engine (router paused or
        stopped); re-validates the rule targets."""
        self._check_rule_targets(engine)
        self.engine = engine

    # -- daemon loop -------------------------------------------------------
    def reset(self) -> None:
        """Re-arm after stop() so the next run() loops."""
        self._stop.clear()

    def run(self, poll_timeout_s: float = 0.05) -> None:
        """Overlap the device dispatch with everything else: batch k scores
        on a dedicated thread while the loop routes batch k-1's results
        into the engine and polls batch k+1. Without the ladder a scorer
        failure drops that batch (``router_score_errors_total``), not the
        loop."""
        from concurrent.futures import ThreadPoolExecutor

        def finish(pending: tuple) -> None:
            pfut, px, ptxs, pts, psp, pmeta, poffs = pending
            try:
                try:
                    proba, fired = pfut.result()
                except Exception:  # noqa: BLE001 - counted: the batch is dropped
                    self._c_score_err.inc(len(ptxs))
                    if psp is not None:
                        psp.status = "error"
                    # the counted drop is a terminal disposition: commit,
                    # or the redelivery would count the error twice
                    self._commit_routed(poffs)
                    return
                self._route(px, ptxs, proba, pts, psp, fired, pmeta)
                self._commit_routed(poffs)
            except BaseException:
                if psp is not None:
                    psp.status = "error"
                raise
            finally:
                self._budget.release(len(ptxs))
                if psp is not None:
                    self.tracer.finish(psp)

        ex = ThreadPoolExecutor(1, thread_name_prefix="ccfd-router-score")
        pending: tuple | None = None  # (future, x, txs, ts, span, audit meta, offsets)
        try:
            while not self._stop.is_set():
                if self._pause_req.is_set():
                    # finish the in-flight batch before acking (swap first:
                    # a raising finish must not leave it pending)
                    if pending is not None:
                        done, pending = pending, None
                        finish(done)
                    self._pause_point()
                    continue
                self._drain_signals()
                # with a batch in flight, do not sleep on an empty topic
                records = self._poll_batch(0.0 if pending is not None else poll_timeout_s)
                offs = self._tx_offsets(records)
                if records:
                    records = self._admit(records)
                    if not records:
                        self._commit_routed(offs)  # fully shed: disposed
                fut = None
                if records:
                    batch_sp = None
                    meta = self._audit_meta(records)
                    try:
                        batch_sp = self._begin_batch_span(records)
                        x, txs, ts = self._decode_batch(records, batch_sp)
                        fut = ex.submit(self._timed_score, x, txs, batch_sp, meta)
                    except BaseException:
                        self._budget.release(len(records))
                        if batch_sp is not None:
                            batch_sp.status = "error"
                            self.tracer.finish(batch_sp)
                        raise
                done, pending = pending, (
                    (fut, x, txs, ts, batch_sp, meta, offs) if fut is not None else None)
                if done is not None:
                    try:
                        finish(done)
                    except BaseException:
                        # the loop is going down: the batch just submitted
                        # can never be routed; release and count it
                        if pending is not None:
                            ptxs, psp = pending[2], pending[4]
                            pending = None
                            self._budget.release(len(ptxs))
                            self._c_score_err.inc(len(ptxs))
                            if psp is not None:
                                psp.status = "error"
                                self.tracer.finish(psp)
                        raise
        finally:
            try:
                if pending is not None:
                    finish(pending)
            finally:
                ex.shutdown()

    def start(self, poll_timeout_s: float = 0.05) -> threading.Thread:
        self.reset()
        t = threading.Thread(target=self.run, args=(poll_timeout_s,),
                             daemon=True, name="ccfd-router")
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.stop()
        self._tx_consumer.close()
        self._resp_consumer.close()
        self._notif_watcher.close()
