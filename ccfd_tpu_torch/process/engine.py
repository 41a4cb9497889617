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
- Completed instances are evicted FIFO past ``completed_retention``.

Not ported yet: the audit stream (jBPM's AuditService analog), snapshots,
save/load to artifacts and the crash-recovery shutdown.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Protocol, Sequence

from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.process.clock import Clock, RealClock, TimerHandle

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
            for t in (getattr(n, "next", None), getattr(n, "on_signal", None),
                      getattr(n, "on_timeout", None)):
                if t is not None and t not in self.nodes:
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
    status: str = "active"  # active | completed | cancelled | aborted
    node: str = ""
    wait_signal: str | None = None
    wait_gen: int = 0
    timer: TimerHandle | None = None
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
        completed_retention: int = 10_000,
    ):
        self.clock: Clock = clock or RealClock()
        self.registry = registry or Registry()
        self.prediction_service = prediction_service
        self.confidence_threshold = confidence_threshold
        self._definitions: dict[str, ProcessDefinition] = {}
        self._instances: dict[int, Instance] = {}
        self._tasks: dict[int, Task] = {}
        self._pid = itertools.count(1)
        self._tid = itertools.count(1)
        self._lock = threading.RLock()
        self._completed_retention = completed_retention
        self._completed_order: deque[int] = deque()
        self._tasks_by_pid: dict[int, list[int]] = {}
        # def_id -> (service_nodes, end_node, history) for straight-through
        # definitions (a ServiceNode chain into an EndNode): the batch start
        # path runs these without per-node dispatch
        self._static_chains: dict[str, tuple[list[ServiceNode], EndNode, list[str]]] = {}
        self._started = self.registry.counter(
            "process_instances_started_total", "process starts by definition")
        self._completed = self.registry.counter(
            "process_instances_completed_total", "process completions by status")

    @property
    def state_lock(self) -> threading.RLock:
        """The lock over instance and task state; the REST server holds it
        while it serializes ``vars`` dicts the engine mutates in place."""
        return self._lock

    # -- definitions ------------------------------------------------------
    def definitions(self) -> tuple[str, ...]:
        """Registered process-definition ids (the router validates its rule
        base against these)."""
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

    # -- public API (KIE-server-shaped: start / signal / tasks) -----------
    def start_process(self, def_id: str, variables: Mapping[str, Any]) -> int:
        with self._lock:
            d = self._definitions[def_id]
            inst = Instance(pid=next(self._pid), definition=d, vars=dict(variables))
            self._instances[inst.pid] = inst
            self._started.inc(labels={"process": def_id})
            self._run_from(inst, d.start)
            return inst.pid

    def start_process_batch(
        self, def_id: str, variables_list: Sequence[Mapping[str, Any]],
        copy_vars: bool = True,
    ) -> list[int | None]:
        """Start many instances of one definition under a single lock
        acquisition (the router's hot path). Straight-through definitions
        (the "standard" process) skip per-node dispatch and advance the
        counters once per batch.

        ``copy_vars=False`` adopts each plain-dict variables mapping as the
        instance's vars without a defensive copy (the router builds a fresh
        dict per transaction).

        Unlike ``start_process``, an exception from a service or gateway
        aborts THAT instance only: its slot is ``None``, the instance is
        left ``aborted``, and the rest of the batch still starts."""
        with self._lock:
            d = self._definitions[def_id]
            chain = self._static_chains.get(def_id)
            pids: list[int | None] = []
            if chain is None:
                for variables in variables_list:
                    try:
                        inst = Instance(
                            pid=next(self._pid), definition=d,
                            vars=(variables if not copy_vars and type(variables) is dict
                                  else dict(variables)))
                    except (TypeError, ValueError):
                        pids.append(None)
                        continue
                    self._instances[inst.pid] = inst
                    self._started.inc(labels={"process": def_id})
                    try:
                        self._run_from(inst, d.start)
                    except Exception:
                        inst.status = "aborted"
                        self._note_completed(inst.pid)
                        pids.append(None)
                        continue
                    pids.append(inst.pid)
                return pids
            services, end, history = chain
            n_ok = n_started = 0
            for variables in variables_list:
                try:
                    inst = Instance(
                        pid=next(self._pid), definition=d,
                        vars=(variables if not copy_vars and type(variables) is dict
                              else dict(variables)))
                except (TypeError, ValueError):
                    pids.append(None)
                    continue
                self._instances[inst.pid] = inst
                n_started += 1
                try:
                    for si, svc in enumerate(services):
                        inst.node = svc.name
                        svc.fn(self, inst)
                except Exception:
                    inst.history = list(history[: si + 1])
                    inst.status = "aborted"
                    self._note_completed(inst.pid)
                    pids.append(None)
                    continue
                inst.node = end.name
                inst.history = list(history)
                inst.status = end.status
                pids.append(inst.pid)
                self._note_completed(inst.pid)
                n_ok += 1
            if n_started:
                self._started.inc(n_started, labels={"process": def_id})
            if n_ok:
                self._completed.inc(n_ok, labels={"process": def_id, "status": end.status})
            return pids

    def signal(self, pid: int, name: str, payload: Any = None) -> bool:
        """Deliver a signal; returns True iff it was consumed by a wait."""
        with self._lock:
            inst = self._instances.get(pid)
            if inst is None or inst.status != "active" or inst.wait_signal != name:
                return False
            node = inst.definition.nodes[inst.node]
            assert isinstance(node, EventNode)
            self._consume_wait(inst)
            inst.vars["signal_payload"] = payload
            self._run_from(inst, node.on_signal)
            return True

    def instance(self, pid: int) -> Instance:
        with self._lock:
            return self._instances[pid]

    def instances(self, status: str | None = None) -> list[Instance]:
        with self._lock:
            return [i for i in self._instances.values()
                    if status is None or i.status == status]

    def tasks(self, status: str = "open") -> list[Task]:
        with self._lock:
            return [t for t in self._tasks.values() if t.status == status]

    def complete_task(self, task_id: int, outcome: Any) -> None:
        with self._lock:
            t = self._tasks[task_id]
            if t.status != "open":
                raise ValueError(f"task {task_id} already {t.status}")
            t.status = "completed"
            t.outcome = outcome
            inst = self._instances[t.pid]
            node = inst.definition.nodes[inst.node]
            assert isinstance(node, UserTaskNode)
            inst.vars["task_outcome"] = outcome
            self._run_from(inst, node.next)

    # -- internals --------------------------------------------------------
    def _note_completed(self, pid: int) -> None:
        """Record a terminal instance and evict past the retention cap
        (caller holds the lock)."""
        self._completed_order.append(pid)
        while len(self._completed_order) > self._completed_retention:
            old = self._completed_order.popleft()
            self._instances.pop(old, None)
            for tid in self._tasks_by_pid.pop(old, ()):
                self._tasks.pop(tid, None)

    def _consume_wait(self, inst: Instance) -> None:
        inst.wait_signal = None
        inst.wait_gen += 1
        if inst.timer is not None:
            inst.timer.cancel()
            inst.timer = None

    def _timer_fired(self, pid: int, gen: int) -> None:
        with self._lock:
            inst = self._instances.get(pid)
            if (inst is None or inst.status != "active" or inst.wait_signal is None
                    or inst.wait_gen != gen):
                return  # a signal won the race; the timer is a no-op
            node = inst.definition.nodes[inst.node]
            assert isinstance(node, EventNode)
            self._consume_wait(inst)
            self._run_from(inst, node.on_timeout)

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
                        f"{inst.definition.id}:{node.name} chose unknown node {node_name!r}")
            elif isinstance(node, EventNode):
                timeout = node.timeout_s(inst) if callable(node.timeout_s) else node.timeout_s
                inst.wait_signal = node.signal
                gen = inst.wait_gen
                inst.timer = self.clock.call_later(
                    timeout, lambda pid=inst.pid, g=gen: self._timer_fired(pid, g))
                return
            elif isinstance(node, UserTaskNode):
                task = Task(task_id=next(self._tid), pid=inst.pid,
                            name=node.task_name, vars=dict(inst.vars))
                self._tasks[task.task_id] = task
                self._tasks_by_pid.setdefault(inst.pid, []).append(task.task_id)
                if self.prediction_service is not None:
                    outcome, confidence = self.prediction_service.predict(task)
                    task.prediction_confidence = confidence
                    if confidence >= self.confidence_threshold:
                        # jBPM semantics: auto-close the task
                        task.status = "completed"
                        task.outcome = outcome
                        inst.vars["task_outcome"] = outcome
                        inst.vars["task_auto_completed"] = True
                        node_name = node.next
                        continue
                    task.suggested_outcome = outcome  # pre-fill only
                return
            elif isinstance(node, EndNode):
                inst.status = node.status
                self._completed.inc(
                    labels={"process": inst.definition.id, "status": node.status})
                self._note_completed(inst.pid)
                return
            else:  # pragma: no cover
                raise TypeError(f"unknown node type {type(node)}")
