"""Business-process engine: the jBPM/KIE-server capability.

The port's copy of ccfd_tpu/process/engine.py. The reference runs the
fraud and standard processes on a KIE execution server: a
customer-notification node, a no-reply timer racing a customer-response
signal, a DMN decision over amount + probability, a user task for human
investigators, and a prediction service that auto-completes user tasks at
high confidence. This engine keeps those semantics as an explicit state
machine:

- A ``ProcessDefinition`` is a named graph of nodes: ``ServiceNode`` (run a
  function, move on), ``EventNode`` (wait for a signal OR a timer,
  whichever fires first wins, atomically), ``GatewayNode`` (XOR),
  ``UserTaskNode`` (open a human task, consult the prediction service) and
  ``EndNode``.
- The signal-vs-timer race is resolved under one engine lock with a
  per-wait generation counter: the first of {matching signal, timer with
  matching generation} consumes the wait; the loser is a no-op.
- The prediction service hook: confidence >= ``confidence_threshold``
  auto-completes the task with the predicted outcome; below it the
  prediction is only pre-filled as ``task.suggested_outcome``.
- Completed instances are evicted FIFO past ``completed_retention``, and,
  with an audit sink, as soon as their ``process_completed`` event reached
  it; a bounded post-mortem ring keeps their summaries
  (``completed_info``, ``recent_completions``).
- The audit stream (jBPM's AuditService analog): lifecycle events reach
  ``audit_sink`` in state-change order, delivered outside the state lock.
- Persistence: ``snapshot``/``restore`` (timers as remaining seconds,
  re-armed on the restoring engine's clock) and ``save``/``load`` through
  the checksummed artifact of ``runtime/durability.py``, with the
  reference's generation naming, so either package loads the other's
  snapshot. ``shutdown`` silences a decommissioned engine.
- ``task_listener`` (the user-task model's training hook) is called once
  per human ``complete_task``, after the audit flush; never for an
  auto-completion.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Protocol, Sequence

from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.process.clock import Clock, RealClock, TimerHandle

# process-wide engine-object sequence for audit-event provenance
_ENGINE_SEQ = itertools.count(1)

def _copy_containers(v: Any) -> Any:
    """Recursive copy of JSON containers (dict/list), leaves shared.

    Snapshots detach from live engine state with this instead of a full
    ``json.dumps`` under the lock: copying containers is cheap (no string
    building), and since dicts/lists are the only mutable JSON values, a
    ServiceNode that mutates NESTED vars (``inst.vars["x"]["y"] = ...``)
    still can't tear the snapshot serialized after the lock is released.
    """
    if isinstance(v, dict):
        return {k: _copy_containers(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_containers(x) for x in v]
    return v


# ---------------------------------------------------------------------------
# Nodes


@dataclass(frozen=True)
class ServiceNode:
    name: str
    fn: Callable[["Engine", "Instance"], None]
    next: str


@dataclass(frozen=True)
class EventNode:
    """Wait for ``signal`` or a timer of ``timeout_s`` — first one wins."""

    name: str
    signal: str
    timeout_s: float | Callable[["Instance"], float]
    on_signal: str
    on_timeout: str


@dataclass(frozen=True)
class UserTaskNode:
    name: str
    task_name: str
    next: str  # node run after completion; outcome in vars["task_outcome"]


@dataclass(frozen=True)
class GatewayNode:
    """Exclusive (XOR) gateway: choose() names the next node."""

    name: str
    choose: Callable[["Engine", "Instance"], str]


@dataclass(frozen=True)
class EndNode:
    name: str
    status: str = "completed"


Node = ServiceNode | EventNode | GatewayNode | UserTaskNode | EndNode


@dataclass(frozen=True)
class ProcessDefinition:
    id: str
    start: str
    nodes: Mapping[str, Node]

    def __post_init__(self) -> None:
        for n in self.nodes.values():
            targets = [
                t
                for t in (
                    getattr(n, "next", None),
                    getattr(n, "on_signal", None),
                    getattr(n, "on_timeout", None),
                )
                if t is not None
            ]
            for t in targets:
                if t not in self.nodes:
                    raise ValueError(f"{self.id}:{n.name} -> unknown node {t!r}")
        if self.start not in self.nodes:
            raise ValueError(f"{self.id}: unknown start node {self.start!r}")


# ---------------------------------------------------------------------------
# Runtime state


@dataclass(slots=True)
class Instance:
    pid: int
    definition: ProcessDefinition
    vars: dict[str, Any]
    status: str = "active"  # active | completed | aborted
    node: str = ""
    wait_signal: str | None = None
    wait_gen: int = 0
    timer: TimerHandle | None = None
    timer_deadline: float | None = None  # clock.now()-relative; for snapshots
    history: list[str] = field(default_factory=list)


@dataclass(slots=True)
class Task:
    task_id: int
    pid: int
    name: str
    vars: dict[str, Any]
    status: str = "open"  # open | completed
    suggested_outcome: Any = None
    prediction_confidence: float | None = None
    outcome: Any = None


class PredictionService(Protocol):
    """jBPM prediction-service shape: predict a user-task outcome."""

    def predict(self, task: Task) -> tuple[Any, float]: ...


# ---------------------------------------------------------------------------
# Engine


class Engine:
    def __init__(
        self,
        clock: Clock | None = None,
        registry: Registry | None = None,
        prediction_service: PredictionService | None = None,
        confidence_threshold: float = 1.0,
        task_listener: Callable[[Task], None] | None = None,
        completed_retention: int = 10_000,
        audit_sink: Callable[[dict[str, Any]], None] | None = None,
        audit_evict: bool = True,
        postmortem_retention: int = 2048,
    ):
        self.clock: Clock = clock or RealClock()
        self.registry = registry or Registry()
        self.prediction_service = prediction_service
        self.confidence_threshold = confidence_threshold
        # fired once per HUMAN complete_task (never for prediction-service
        # auto-completions): the user-task model trains on investigator
        # decisions only
        self.task_listener = task_listener
        # Audit stream (jBPM's AuditService analog): lifecycle events —
        # process_started/process_completed, task_created/task_completed,
        # signal, timer_fired — reach this sink in state-change order.
        # Events BUFFER under the state lock and deliver after it releases
        # (public entry points flush), so a slow sink (a remote bus hop)
        # never stalls the engine's lock; the flush lock serializes
        # deliveries so per-pid order still matches state-change order.
        # A sink exposing a ``batch`` attribute gets each flush in ONE
        # call. None (default) costs nothing on the hot path. The runtime
        # store evicts completed instances (retention cap below); the
        # audit stream is where full history durably lives.
        self._audit = audit_sink
        self._audit_buffer: list[dict[str, Any]] = []
        self._audit_flush_lock = threading.Lock()
        self._definitions: dict[str, ProcessDefinition] = {}
        self._instances: dict[int, Instance] = {}
        self._tasks: dict[int, Task] = {}
        self._pid = itertools.count(1)
        self._tid = itertools.count(1)
        self._lock = threading.RLock()
        # Completed instances are evicted FIFO past this cap (jBPM likewise
        # drops finished instances from the runtime store, keeping history in
        # the audit log — here, in metrics): a pipeline starting a process
        # per scored transaction would otherwise grow ``_instances`` without
        # bound at tens of thousands of entries per second.
        self._completed_retention = completed_retention
        self._completed_order: deque[int] = deque()
        # Audit-coupled eviction: with an audit
        # sink wired, a completed instance's full state leaves the runtime
        # store as soon as its ``process_completed`` event has actually
        # been DELIVERED to the sink (for the bus sink that means the
        # durable log already holds it — bus/broker.py writes the log
        # before the in-memory append). The 10k ``completed_retention``
        # FIFO then only backstops sink failures. Without a sink the
        # historical cap is the only eviction, as before.
        self._audit_evict = bool(audit_evict)
        # bounded post-mortem ring: evicted instances stay queryable as
        # lightweight summaries (pid/definition/status/ts) — what the
        # tail-completion reconciliation and operators' "what happened to
        # pid X" need, at ~100 B instead of a full Instance + tasks
        self._postmortem_retention = int(postmortem_retention)
        # pid -> (definition_id, status, ts) — tuples, not dicts (hot
        # path); completed_info/recent_completions rebuild dicts on query
        self._postmortem: dict[int, tuple[str, str, float]] = {}
        self._tasks_by_pid: dict[int, list[int]] = {}
        # def_id -> (service_nodes, end_node, history) for straight-through
        # definitions (ServiceNode chain into an EndNode, no waits/gateways/
        # tasks): the hot batch path runs these without per-node dispatch
        self._static_chains: dict[str, tuple[list[ServiceNode], EndNode, list[str]]] = {}
        # set by shutdown(): a decommissioned engine object must go silent
        self._dead = False
        # stamped into every audit event: across crash-recovery swaps
        # multiple engine objects write one stream,
        # and epoch forensics need to know which object emitted what
        self._engine_tag = f"e{next(_ENGINE_SEQ)}"
        self._started = self.registry.counter(
            "process_instances_started_total", "process starts by definition"
        )
        self._completed = self.registry.counter(
            "process_instances_completed_total", "process completions by status"
        )

    def _emit(self, event: str, pid: int, process: str, **extra: Any) -> None:
        """Buffer one audit event; caller holds the state lock and has
        checked ``self._audit is not None`` (so the off case builds no
        dicts). Delivery happens in ``_flush_audit`` after lock release."""
        self._audit_buffer.append({
            "event": event, "pid": pid, "process": process,
            "ts": self.clock.now(), "engine": self._engine_tag, **extra,
        })

    def _flush_audit(self) -> None:
        """Deliver buffered audit events OUTSIDE the state lock.

        The flush lock serializes concurrent flushers, and the buffer swap
        happens under the state lock inside it — so delivery order equals
        state-change order even when two API calls race to flush. A sink
        exposing a ``batch`` attribute gets the whole flush in one call
        (the bus sink maps it to produce_batch); otherwise events deliver
        one at a time with per-event failure isolation."""
        if self._audit is None:
            return
        # Reentrancy guard: a ServiceNode/GatewayNode may call back into a
        # public engine API (fn(engine, inst)), whose exit would flush
        # WHILE the outer frame still owns the state RLock — acquiring the
        # flush lock there inverts the flush->state lock order (AB-BA
        # deadlock against a concurrent flusher) and would deliver to the
        # sink under the state lock. The outermost frame flushes instead.
        # (_is_owned is RLock private API, stable across CPython.)
        if self._lock._is_owned():
            return
        with self._audit_flush_lock:
            with self._lock:
                events = self._audit_buffer
                self._audit_buffer = []
            if not events:
                return
            batch_fn = getattr(self._audit, "batch", None)
            if callable(batch_fn):
                try:
                    batch_fn(events)
                except Exception:  # noqa: BLE001 - never break the flow
                    import logging

                    logging.getLogger(__name__).exception("audit sink failed")
                    return  # undelivered: retention cap remains the evictor
                self._evict_flushed(events)
                return
            delivered: list[dict[str, Any]] = []
            for ev in events:
                try:
                    self._audit(ev)
                    delivered.append(ev)
                except Exception:  # noqa: BLE001 - drop THIS event only
                    import logging

                    logging.getLogger(__name__).exception("audit sink failed")
            self._evict_flushed(delivered)

    def _evict_flushed(self, events: list[dict[str, Any]]) -> None:
        """Evict instances whose terminal audit event just reached the sink
        (audit-coupled eviction — see __init__). Caller holds the flush
        lock, NOT the state lock; lock order matches shutdown()."""
        if not self._audit_evict:
            return
        pids = [ev["pid"] for ev in events
                if ev.get("event") == "process_completed"]
        if not pids:
            return
        with self._lock:
            for pid in pids:
                inst = self._instances.get(pid)
                if inst is None or inst.status == "active":
                    continue  # re-driven/rolled-back pid live again: keep
                self._instances.pop(pid, None)
                for tid in self._tasks_by_pid.pop(pid, ()):
                    self._tasks.pop(tid, None)
                # the pid stays in _completed_order; the FIFO backstop's
                # pop(None) tolerates already-evicted entries

    @property
    def state_lock(self) -> threading.RLock:
        """The lock guarding instance/task state. External viewers (the REST
        server) hold it while serializing ``vars`` dicts — the engine mutates
        them in place, and iterating a live dict during a signal races."""
        return self._lock

    # -- definitions ------------------------------------------------------
    def definitions(self) -> tuple[str, ...]:
        """Registered process-definition ids (the router validates its rule
        base against these at wiring time)."""
        with self._lock:
            return tuple(self._definitions)

    def register(self, definition: ProcessDefinition) -> None:
        self._definitions[definition.id] = definition
        chain = self._straight_through_chain(definition)
        if chain is not None:
            self._static_chains[definition.id] = chain
        else:
            self._static_chains.pop(definition.id, None)

    @staticmethod
    def _straight_through_chain(
        definition: ProcessDefinition,
    ) -> tuple[list[ServiceNode], EndNode, list[str]] | None:
        """ServiceNode* -> EndNode with no branches? Then the node walk is
        static and the batch start path can skip per-node dispatch."""
        services: list[ServiceNode] = []
        history: list[str] = []
        name = definition.start
        for _ in range(len(definition.nodes) + 1):
            node = definition.nodes[name]
            history.append(name)
            if isinstance(node, ServiceNode):
                services.append(node)
                name = node.next
            elif isinstance(node, EndNode):
                return services, node, history
            else:
                return None
        return None  # cycle of service nodes: not straight-through

    def _check_alive(self) -> None:
        """Caller holds the lock. A decommissioned engine must refuse
        mutation: after a crash-recovery swap, a
        caller that raced the swap — e.g. a router scoring batch that was
        in flight past the pause timeout — would otherwise write starts
        and arm timers on the abandoned object. Refusing converts that
        into the router's normal engine-unreachable error path, and the
        rewound bus re-delivers the records to the live engine."""
        if self._dead:
            raise RuntimeError("engine is shut down (crash-recovery swap)")

    # -- public API (KIE-server-shaped: start / signal / tasks) -----------
    def start_process(self, def_id: str, variables: Mapping[str, Any]) -> int:
        try:
            with self._lock:
                self._check_alive()
                d = self._definitions[def_id]
                inst = Instance(
                    pid=next(self._pid), definition=d, vars=dict(variables)
                )
                self._instances[inst.pid] = inst
                self._started.inc(labels={"process": def_id})
                if self._audit is not None:
                    self._emit("process_started", inst.pid, def_id)
                self._run_from(inst, d.start)
                return inst.pid
        finally:
            # finally, not fallthrough: a raising service node documented
            # to propagate must still get its buffered events delivered
            self._flush_audit()

    # capability flag the router reads through any method proxy (fault
    # injector / breaker guard): this engine's start_process_batch accepts
    # ``copy_vars=False``. Remote clients (EngineRestClient) lack it.
    start_batch_nocopy = True

    def start_process_batch(
        self, def_id: str, variables_list: Sequence[Mapping[str, Any]],
        copy_vars: bool = True,
    ) -> list[int | None]:
        """Start many instances of one definition under a single lock
        acquisition — the router's hot path (one start per scored
        transaction) would otherwise pay a lock
        round-trip and per-label counter bump per transaction.

        Straight-through definitions (a ServiceNode chain into an EndNode —
        the "standard" process) additionally skip per-node dispatch: the
        node walk is precomputed at ``register`` time and the metrics
        counters advance once per batch instead of once per instance.

        ``copy_vars=False`` adopts each (plain-dict) variables mapping as
        the instance's vars WITHOUT the defensive copy — for callers that
        hand over freshly built, never-reused dicts (the router's route
        stage builds one per transaction and drops it). The copy was one
        of the larger constants in the GIL-bound hand-off, which bounds
        the parallel router fan-out's scaling. Non-dict mappings are
        still copied (and non-mappings still poison only their slot).

        Error semantics (unlike single ``start_process``, which propagates):
        an exception from a service/gateway aborts THAT instance only — its
        slot in the returned list is ``None``, the instance is left
        ``aborted``, and the rest of the batch still starts. One poisoned
        transaction must not drop a whole micro-batch of process starts.
        """
        try:
            return self._start_process_batch_locked(
                def_id, variables_list, copy_vars)
        finally:
            self._flush_audit()

    def _start_process_batch_locked(
        self, def_id: str, variables_list: Sequence[Mapping[str, Any]],
        copy_vars: bool = True,
    ) -> list[int | None]:
        with self._lock:
            self._check_alive()
            d = self._definitions[def_id]
            chain = self._static_chains.get(def_id)
            pids: list[int | None] = []
            audit_on = self._audit is not None
            if chain is None:
                for variables in variables_list:
                    try:
                        # a non-mapping element must poison only its slot:
                        # dict() belongs inside the isolation boundary too
                        inst = Instance(
                            pid=next(self._pid), definition=d,
                            vars=(variables
                                  if not copy_vars and type(variables) is dict
                                  else dict(variables)),
                        )
                    except (TypeError, ValueError):
                        pids.append(None)
                        continue
                    self._instances[inst.pid] = inst
                    self._started.inc(labels={"process": def_id})
                    if audit_on:
                        self._emit("process_started", inst.pid, def_id)
                    try:
                        self._run_from(inst, d.start)
                    except Exception:
                        inst.status = "aborted"
                        if audit_on:
                            self._emit("process_completed", inst.pid, def_id,
                                       status="aborted")
                        self._note_completed(inst.pid)
                        pids.append(None)
                        continue
                    pids.append(inst.pid)
            else:
                # straight-through fast lane. This loop is the engine's
                # per-transaction floor under the parallel router fan-out
                # (GIL-bound, one iteration per scored transaction at wire
                # rate): locals are hoisted, the clock is read once per
                # batch, and per-instance counter bumps are batched below.
                services, end, history = chain
                n_ok = 0
                n_started = 0
                now = self.clock.now()
                instances = self._instances
                next_pid = self._pid.__next__
                end_name = end.name
                end_status = end.status
                append_pid = pids.append
                for variables in variables_list:
                    try:
                        inst = Instance(
                            pid=next_pid(), definition=d,
                            vars=(variables
                                  if not copy_vars and type(variables) is dict
                                  else dict(variables)),
                        )
                    except (TypeError, ValueError):
                        append_pid(None)
                        continue
                    instances[inst.pid] = inst
                    n_started += 1
                    if audit_on:
                        self._emit("process_started", inst.pid, def_id)
                    try:
                        for si, svc in enumerate(services):
                            inst.node = svc.name
                            svc.fn(self, inst)
                    except Exception:
                        inst.history = list(history[: si + 1])
                        inst.status = "aborted"
                        if audit_on:
                            self._emit("process_completed", inst.pid, def_id,
                                       status="aborted")
                        self._note_completed(inst.pid, now)
                        append_pid(None)
                        continue
                    inst.node = end_name
                    inst.history = list(history)
                    inst.status = end_status
                    if audit_on:
                        self._emit("process_completed", inst.pid, def_id,
                                   status=end_status)
                    append_pid(inst.pid)
                    self._note_completed(inst.pid, now)
                    n_ok += 1
                if n_started:
                    self._started.inc(n_started, labels={"process": def_id})
                if n_ok:
                    self._completed.inc(
                        n_ok, labels={"process": def_id, "status": end.status}
                    )
        return pids

    def signal(self, pid: int, name: str, payload: Any = None) -> bool:
        """Deliver a signal; returns True iff it was consumed by a wait."""
        try:
            with self._lock:
                self._check_alive()
                inst = self._instances.get(pid)
                if (
                    inst is None
                    or inst.status != "active"
                    or inst.wait_signal != name
                ):
                    return False
                node = inst.definition.nodes[inst.node]
                assert isinstance(node, EventNode)
                self._consume_wait(inst)
                inst.vars["signal_payload"] = payload
                if self._audit is not None:
                    self._emit("signal", pid, inst.definition.id, name=name)
                self._run_from(inst, node.on_signal)
                return True
        finally:
            self._flush_audit()

    def instance(self, pid: int) -> Instance:
        with self._lock:
            return self._instances[pid]

    def completed_info(self, pid: int) -> dict[str, Any] | None:
        """Post-mortem summary for an evicted (or still-resident) completed
        instance, from the bounded ring; None if it aged out."""
        with self._lock:
            row = self._postmortem.get(pid)
        if row is None:
            return None
        return {"pid": pid, "process": row[0], "status": row[1],
                "ts": row[2]}

    def recent_completions(self, n: int = 100) -> list[dict[str, Any]]:
        with self._lock:
            tail = list(self._postmortem.items())[-n:]
        return [{"pid": pid, "process": row[0], "status": row[1],
                 "ts": row[2]} for pid, row in tail]

    def object_counts(self) -> dict[str, int]:
        """Live container sizes — the per-component object gauges the
        memory-drift hunt reads (metrics/exporter.py /memory)."""
        with self._lock:
            return {
                "instances": len(self._instances),
                "tasks": len(self._tasks),
                "completed_order": len(self._completed_order),
                "postmortem": len(self._postmortem),
                "audit_buffer": len(self._audit_buffer),
            }

    def instances(self, status: str | None = None) -> list[Instance]:
        with self._lock:
            return [
                i
                for i in self._instances.values()
                if status is None or i.status == status
            ]

    def tasks(self, status: str = "open") -> list[Task]:
        with self._lock:
            return [t for t in self._tasks.values() if t.status == status]

    def task(self, task_id: int) -> Task:
        with self._lock:
            return self._tasks[task_id]

    def complete_task(self, task_id: int, outcome: Any) -> None:
        try:
            with self._lock:
                self._check_alive()
                t = self._tasks[task_id]
                if t.status != "open":
                    raise ValueError(f"task {task_id} already {t.status}")
                t.status = "completed"
                t.outcome = outcome
                inst = self._instances[t.pid]
                node = inst.definition.nodes[inst.node]
                assert isinstance(node, UserTaskNode)
                inst.vars["task_outcome"] = outcome
                if self._audit is not None:
                    self._emit("task_completed", t.pid, inst.definition.id,
                               task_id=t.task_id, by="human", outcome=outcome)
                self._run_from(inst, node.next)
        finally:
            self._flush_audit()
        if self.task_listener is not None:
            try:
                self.task_listener(t)
            except Exception:  # noqa: BLE001
                # the task is completed and the process advanced; a broken
                # observer must not fail the investigator's complete_task
                import logging

                logging.getLogger(__name__).exception(
                    "task listener failed for task %d", t.task_id)

    # -- persistence (jBPM keeps process state in its engine store;
    #    here in snapshots and the checksummed state file) ---------------
    def snapshot(self, include_completed: bool = False,
                 validate: bool = True) -> dict[str, Any]:
        """Serializable engine state: instances, tasks, id counters.

        ``validate=False`` skips the JSON round-trip at the end — for the
        checkpoint coordinator, which holds the router's pause barrier
        across this call and validates AFTER releasing it (at 50k live
        instances the round-trip is ~70% of the 600 ms snapshot, all of
        it needlessly inside the barrier). Every mutable container is
        still detached under the lock either way.

        Timer waits serialize as *remaining* seconds (clock epochs differ
        across processes). Process vars must be JSON-able — the same
        contract jBPM puts on persisted process variables.

        By default only ACTIVE instances and their open tasks are captured
        (jBPM likewise drops completed instances from the runtime store,
        keeping history in the audit log — here, in metrics): a long-running
        pipeline starts a process per flagged transaction, and snapshotting
        every completed instance forever would grow the state file and the
        save/restore cost without bound.
        """
        with self._lock:
            now = self.clock.now()
            live = {
                pid
                for pid, i in self._instances.items()
                if include_completed or i.status == "active"
            }
            instances = []
            for i in self._instances.values():
                if i.pid not in live:
                    continue
                instances.append(
                    {
                        "pid": i.pid,
                        "def": i.definition.id,
                        "vars": _copy_containers(i.vars),
                        "status": i.status,
                        "node": i.node,
                        "wait_signal": i.wait_signal,
                        "wait_gen": i.wait_gen,
                        "timer_remaining_s": (
                            None
                            if i.timer_deadline is None
                            else max(0.0, i.timer_deadline - now)
                        ),
                        "history": list(i.history),
                    }
                )
            tasks = [
                {
                    "task_id": t.task_id,
                    "pid": t.pid,
                    "name": t.name,
                    "vars": _copy_containers(t.vars),
                    "status": t.status,
                    "suggested_outcome": t.suggested_outcome,
                    "prediction_confidence": t.prediction_confidence,
                    "outcome": t.outcome,
                }
                for t in self._tasks.values()
                if t.pid in live and (include_completed or t.status == "open")
            ]
            snap = {
                "version": 1,
                "next_pid": next(self._pid),
                "next_tid": next(self._tid),
                "instances": instances,
                "tasks": tasks,
            }
            # the counters advanced to produce the snapshot; keep going from
            # the recorded values so live allocation stays consistent
            self._pid = itertools.count(snap["next_pid"])
            self._tid = itertools.count(snap["next_tid"])
        # JSON round-trip OUTSIDE the lock: a periodic checkpoint
        # calls snapshot() every few seconds, and serializing every live
        # instance while holding the lock would periodically stall
        # start_process/signal/complete_task for time proportional to the
        # active-instance count. ``_copy_containers`` above already detached
        # every mutable JSON container under the lock (so even ServiceNodes
        # that mutate nested vars can't tear this), and the round-trip here
        # validates serializability now, not at restore time months later.
        if not validate:
            return snap
        return json.loads(json.dumps(snap))

    def restore(self, snap: Mapping[str, Any]) -> None:
        """Load a snapshot into an empty engine and re-arm pending timers.

        Definitions are code, not data (like jBPM KJARs): every definition
        referenced by the snapshot must already be ``register``-ed. Waits
        whose timers expired while the engine was down are re-armed with
        zero delay — the timeout path fires promptly after restore, which
        is jBPM's overdue-timer recovery behavior.
        """
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version {snap.get('version')!r}")
        with self._lock:
            if self._instances or self._tasks:
                raise ValueError("restore requires an empty engine")
            missing = {i["def"] for i in snap["instances"]} - set(self._definitions)
            if missing:
                raise ValueError(f"snapshot needs unregistered definitions {sorted(missing)}")
            # definitions are code and may have drifted since the snapshot:
            # an instance parked on a renamed node would pass restore and
            # then KeyError at signal/timer time, wedging it permanently —
            # fail here, with names
            for s in snap["instances"]:
                d = self._definitions[s["def"]]
                if s["status"] == "active" and s["node"] not in d.nodes:
                    raise ValueError(
                        f"instance {s['pid']}: node {s['node']!r} no longer in "
                        f"definition {d.id!r} (has {sorted(d.nodes)})"
                    )
                if s["status"] == "active" and s["wait_signal"] is not None:
                    node = d.nodes[s["node"]]
                    if not isinstance(node, EventNode) or node.signal != s["wait_signal"]:
                        raise ValueError(
                            f"instance {s['pid']}: waiting on signal "
                            f"{s['wait_signal']!r} but node {s['node']!r} is not "
                            f"an EventNode for it"
                        )
            for s in snap["instances"]:
                inst = Instance(
                    pid=int(s["pid"]),
                    definition=self._definitions[s["def"]],
                    vars=dict(s["vars"]),
                    status=s["status"],
                    node=s["node"],
                    wait_signal=s["wait_signal"],
                    wait_gen=int(s["wait_gen"]),
                    history=list(s["history"]),
                )
                self._instances[inst.pid] = inst
                if inst.status != "active":
                    self._completed_order.append(inst.pid)
            for s in snap["tasks"]:
                t = Task(
                    task_id=int(s["task_id"]),
                    pid=int(s["pid"]),
                    name=s["name"],
                    vars=dict(s["vars"]),
                    status=s["status"],
                    suggested_outcome=s["suggested_outcome"],
                    prediction_confidence=s["prediction_confidence"],
                    outcome=s["outcome"],
                )
                self._tasks[t.task_id] = t
                self._tasks_by_pid.setdefault(t.pid, []).append(t.task_id)
            self._pid = itertools.count(int(snap["next_pid"]))
            self._tid = itertools.count(int(snap["next_tid"]))
            # re-arm after all state is in place: a zero-delay timer may
            # fire (RealClock scheduler thread) as soon as we release _lock
            for s in snap["instances"]:
                remaining = s["timer_remaining_s"]
                if s["status"] == "active" and remaining is not None:
                    inst = self._instances[int(s["pid"])]
                    inst.timer_deadline = self.clock.now() + remaining
                    inst.timer = self.clock.call_later(
                        remaining,
                        lambda pid=inst.pid, g=inst.wait_gen: self._timer_fired(pid, g),
                    )

    def shutdown(self) -> None:
        """Decommission this engine object after a crash-recovery swap.

        A recovery coordinator abandons the live
        engine and replaces it with a snapshot-restored one; without this,
        the abandoned object's already-scheduled timer callbacks would
        keep firing — mutating dead state and, worse, emitting post-epoch
        audit events through the SHARED bus sink, corrupting the stream's
        epoch accounting.  Cancels every pending timer, drops buffered
        audit events, and silences the sink.  Lock order matches
        ``_flush_audit`` (flush lock, then state lock), so an in-flight
        flush completes its delivery before the shutdown lands — after
        return, nothing more reaches the sink."""
        with self._audit_flush_lock:
            with self._lock:
                self._dead = True
                for inst in self._instances.values():
                    if inst.timer is not None:
                        inst.timer.cancel()
                        inst.timer = None
                self._audit_buffer.clear()
                self._audit = None

    def save(self, path: str) -> None:
        """Checksummed atomic snapshot-to-file (tmp + fsync + rename with
        generation retention, runtime/durability.py)."""
        from ccfd_tpu_torch.runtime.durability import write_json_artifact

        write_json_artifact(path, self.snapshot(),
                            artifact="engine_snapshot")

    def load(self, path: str) -> None:
        """Verified restore: a corrupt snapshot quarantines and the
        last-good retained generation loads instead."""
        from ccfd_tpu_torch.runtime.durability import read_json_artifact

        self.restore(read_json_artifact(path, artifact="engine_snapshot"))

    # -- internals --------------------------------------------------------
    def _note_completed(self, pid: int, now: float | None = None) -> None:
        """Record a terminal instance and evict past the retention cap.
        Caller holds the lock (``now`` lets batch callers amortize the
        clock read). Evicted instances (and their tasks) leave the
        runtime store; history lives on in the audit stream and metrics,
        like jBPM's audit log vs runtime separation. With an audit sink the
        real eviction happens in ``_evict_flushed`` (as soon as the
        terminal event is delivered); the FIFO here is the no-sink path
        and the backstop for sink failures."""
        inst = self._instances.get(pid)
        if inst is not None and self._audit is not None:
            # bounded post-mortem ring: a tuple summary outlives the
            # audit-coupled eviction (tuples, not dicts: this runs once
            # per completed transaction at wire rate; completed_info
            # rebuilds the dict on query). Without an audit sink there is
            # no prompt eviction — the completed-retention FIFO keeps the
            # full instance queryable — so the ring would be pure hot-path
            # overhead and is skipped.
            pm = self._postmortem
            pm[pid] = (inst.definition.id, inst.status,
                       self.clock.now() if now is None else now)
            if len(pm) > self._postmortem_retention:
                del pm[next(iter(pm))]
        self._completed_order.append(pid)
        while len(self._completed_order) > self._completed_retention:
            old = self._completed_order.popleft()
            self._instances.pop(old, None)
            for tid in self._tasks_by_pid.pop(old, ()):
                self._tasks.pop(tid, None)

    def _consume_wait(self, inst: Instance) -> None:
        inst.wait_signal = None
        inst.wait_gen += 1
        inst.timer_deadline = None
        if inst.timer is not None:
            inst.timer.cancel()
            inst.timer = None

    def _timer_fired(self, pid: int, gen: int) -> None:
        try:
            with self._lock:
                inst = self._instances.get(pid)
                if (
                    self._dead
                    or inst is None
                    or inst.status != "active"
                    or inst.wait_signal is None
                    or inst.wait_gen != gen
                ):
                    return  # a signal won the race; timer is a no-op
                node = inst.definition.nodes[inst.node]
                assert isinstance(node, EventNode)
                self._consume_wait(inst)
                if self._audit is not None:
                    self._emit("timer_fired", pid, inst.definition.id,
                               node=inst.node)
                self._run_from(inst, node.on_timeout)
        finally:
            self._flush_audit()

    def _run_from(self, inst: Instance, node_name: str) -> None:
        """Advance the instance until it blocks (event/user task) or ends."""
        while True:
            node = inst.definition.nodes[node_name]
            inst.node = node_name
            inst.history.append(node_name)
            if isinstance(node, ServiceNode):
                node.fn(self, inst)
                node_name = node.next
            elif isinstance(node, GatewayNode):
                node_name = node.choose(self, inst)
                if node_name not in inst.definition.nodes:
                    raise ValueError(
                        f"{inst.definition.id}:{node.name} chose unknown node "
                        f"{node_name!r}"
                    )
            elif isinstance(node, EventNode):
                timeout = (
                    node.timeout_s(inst) if callable(node.timeout_s) else node.timeout_s
                )
                inst.wait_signal = node.signal
                gen = inst.wait_gen
                inst.timer_deadline = self.clock.now() + timeout
                inst.timer = self.clock.call_later(
                    timeout, lambda pid=inst.pid, g=gen: self._timer_fired(pid, g)
                )
                return
            elif isinstance(node, UserTaskNode):
                task = Task(
                    task_id=next(self._tid),
                    pid=inst.pid,
                    name=node.task_name,
                    vars=dict(inst.vars),
                )
                self._tasks[task.task_id] = task
                self._tasks_by_pid.setdefault(inst.pid, []).append(task.task_id)
                if self._audit is not None:
                    self._emit("task_created", inst.pid, inst.definition.id,
                               task_id=task.task_id, name=node.task_name)
                if self.prediction_service is not None:
                    outcome, confidence = self.prediction_service.predict(task)
                    task.prediction_confidence = confidence
                    if confidence >= self.confidence_threshold:
                        # jBPM semantics: auto-close the task
                        task.status = "completed"
                        task.outcome = outcome
                        inst.vars["task_outcome"] = outcome
                        inst.vars["task_auto_completed"] = True
                        if self._audit is not None:
                            self._emit(
                                "task_completed", inst.pid,
                                inst.definition.id, task_id=task.task_id,
                                by="prediction_service", outcome=outcome,
                            )
                        node_name = node.next
                        continue
                    task.suggested_outcome = outcome  # pre-fill only
                return
            elif isinstance(node, EndNode):
                inst.status = node.status
                self._completed.inc(
                    labels={"process": inst.definition.id, "status": node.status}
                )
                if self._audit is not None:
                    self._emit("process_completed", inst.pid,
                               inst.definition.id, status=node.status)
                self._note_completed(inst.pid)
                return
            else:  # pragma: no cover
                raise TypeError(f"unknown node type {type(node)}")
