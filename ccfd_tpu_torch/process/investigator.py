"""Investigator simulation: the humans working the KIE console queue.

The port's copy of ccfd_tpu/process/investigator.py (numpy only; the same
seeded draws, so one seed gives the same verdicts in both packages).

The reference demo's loop closes through people — investigators open the
Business Central task list, see the prediction service's pre-filled
recommendation, and approve or cancel the transaction (reference
README.md:547-581). Without that actor, flagged transactions park as open
tasks forever, and the online user-task model (process/usertask_model.py)
— which trains on INVESTIGATOR decisions — never sees a label.

This service is that actor, seeded and rate-limited like the customer
simulation in notify/service.py:

- polls the engine's open-task queue (in-process ``Engine`` or the
  KIE-shaped REST client — both task surfaces are accepted),
- when the console pre-fill is confident enough
  (``prediction_confidence >= trust_threshold``), follows the suggestion
  (the measured behavior auto-close is modeled on: humans rubber-stamp
  high-confidence recommendations),
- otherwise decides independently: fraud with probability
  ``base_fraud_rate`` (seeded), the shape of a queue whose flags are
  mostly false positives,
- at most ``rate_per_s`` completions per second — a queue fed faster
  than the investigators drain it grows, visible on the KIE board's
  open-task stats, exactly like the real console backlog.

Metrics: ``investigator_tasks_completed_total`` (by outcome) and
``investigator_queue_depth``. Run under the supervisor (operator
component ``investigator``) or standalone via ``python -m ccfd_tpu_torch investigate``.
"""
from __future__ import annotations

import threading
from typing import Any

import numpy as np

from ccfd_tpu_torch.metrics.prom import Registry


def _field(task: Any, name: str, default: Any = None) -> Any:
    """Task field access across both surfaces: Engine yields Task objects,
    the REST client yields plain dicts."""
    if isinstance(task, dict):
        return task.get(name, default)
    return getattr(task, name, default)


class InvestigatorService:
    def __init__(
        self,
        engine: Any,
        registry: Registry | None = None,
        rate_per_s: float = 50.0,
        trust_threshold: float = 0.9,
        base_fraud_rate: float = 0.05,
        seed: int = 0,
        batch: int = 100,
    ):
        self.engine = engine
        self.registry = registry or Registry()
        self.rate_per_s = float(rate_per_s)
        self.trust_threshold = float(trust_threshold)
        self.base_fraud_rate = float(base_fraud_rate)
        self.batch = int(batch)
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._c_done = self.registry.counter(
            "investigator_tasks_completed_total",
            "investigator task completions by outcome",
        )
        self._g_queue = self.registry.gauge(
            "investigator_queue_depth", "open tasks awaiting investigation"
        )
        self.completed = 0

    # -- one decision ------------------------------------------------------
    def decide(self, task: Any) -> bool:
        """The verdict (is_fraud) for one task."""
        conf = _field(task, "prediction_confidence") or 0.0
        suggested = _field(task, "suggested_outcome")
        if suggested is not None and conf >= self.trust_threshold:
            return bool(suggested)
        return bool(self._rng.random() < self.base_fraud_rate)

    def work_once(self) -> int:
        """One pass over the queue (bounded by ``batch``); returns the
        number of tasks completed. Engine swaps (crash recovery) and
        already-completed tasks surface as exceptions on individual
        completions — those are skipped, the rest of the pass continues."""
        try:
            tasks = self.engine.tasks("open")
        except Exception:  # noqa: BLE001 - engine mid-restart: next pass
            return 0
        self._g_queue.set(float(len(tasks)))
        done = 0
        for task in tasks[: self.batch]:
            if self._stop.is_set():
                break
            verdict = self.decide(task)
            try:
                self.engine.complete_task(_field(task, "task_id"), verdict)
            except Exception:  # noqa: BLE001 - task gone / engine swapped
                continue
            self._c_done.inc(labels={
                "outcome": "cancelled" if verdict else "approved"
            })
            self.completed += 1
            done += 1
            if self.rate_per_s > 0:
                # interruptible pacing: a slow configured rate must not
                # stall stop()/platform.down() for up to 1/rate seconds
                if self._stop.wait(1.0 / self.rate_per_s):
                    break
        return done

    # -- service lifecycle -------------------------------------------------
    def run(self, poll_timeout_s: float = 0.2) -> None:
        while not self._stop.is_set():
            if self.work_once() == 0:
                self._stop.wait(poll_timeout_s)

    def stop(self) -> None:
        self._stop.set()

    def reset(self) -> None:
        """Supervisor respawn hook (must not run on the service thread)."""
        self._stop.clear()
