"""Partition-parallel router fan-out with shared coalesced dispatch.

The port's copy of ccfd_tpu/router/parallel.py. ``ParallelRouter`` runs N
worker loops (``CCFD_ROUTER_WORKERS``; 0 = one per partition of the
transaction topic). Each worker is a full ``Router`` on its own thread,
owning a disjoint partition subset by consumer-group assignment, so a
partition's order is kept: it has one consuming worker, which routes its
batches in poll order.

The workers share the control plane:

- **one scorer behind a coalescing batcher** (serving/batcher.py
  ``DynamicBatcher``): concurrent workers' batches merge into one dispatch
  (on the card, one launch per bucket-sized chunk);
  ``router_coalesced_dispatches_total`` / ``router_coalesced_rows_total``
  against ``router_worker_batches_total{worker}`` show the fan-in. The
  decision plane bypasses the batcher (its decide is the dispatch);
- **one in-flight budget** (or the overload plane's adaptive one): N
  workers cannot hold N times the bound;
- **one circuit breaker** on the scorer edge, with the ladder on;
- **one engine** (its own lock serializes the starts);
- **a group-wide pause barrier**: every worker's hold is requested first,
  then all acks are awaited;
- **one stage profiler and one heal gate** (``profiler``, ``heal_gate`` /
  ``set_heal_gate``), handed to every worker; the coalescing batcher also
  feeds the profiler's ``router.coalesce.batcher`` (queue) and
  ``router.coalesce.dispatch`` stages, which the reference's leaves
  unprofiled.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import numpy as np

from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.router.router import InflightBudget, Router, default_scorer_breaker
from ccfd_tpu_torch.router.rules import RuleSet


class ParallelRouter:
    def __init__(
        self,
        cfg: Config,
        broker: Broker,
        score_fn: Callable[[np.ndarray], np.ndarray],
        engine: Any,
        registry: Registry | None = None,
        workers: int = 0,
        max_batch: int = 4096,
        rules: RuleSet | None = None,
        host_score_fn: Callable[[np.ndarray], np.ndarray] | None = None,
        breaker: Any = None,
        degrade: bool | None = None,
        max_inflight: int | None = None,
        tracer: Any = None,
        coalesce: bool = True,
        overload: Any = None,
        decision_fn: Any = None,
        profiler: Any = None,
        heal_gate: Any = None,
    ):
        self.cfg = cfg
        self.broker = broker
        self.registry = registry or Registry()
        self.max_batch = max_batch
        if workers <= 0:
            workers = max(1, len(broker.end_offsets(cfg.kafka_topic)))
        self.n_workers = workers
        # the shared budget: an explicit max_inflight is a global bound;
        # the default scales with the pool (2 x max_batch a worker), so
        # healthy operation never sheds; the overload plane's adaptive
        # budget replaces it when armed
        self._overload = overload
        if overload is not None:
            self._budget = overload.budget
            self.max_inflight = self._budget.limit
        else:
            self.max_inflight = (int(max_inflight) if max_inflight is not None
                                 else 2 * max_batch * workers)
            self._budget = InflightBudget(self.max_inflight, registry=self.registry)
        self._degrade = (degrade if degrade is not None
                         else (host_score_fn is not None or breaker is not None))
        if self._degrade and breaker is None:
            breaker = default_scorer_breaker(self.registry)
        self._breaker = breaker

        self.batcher = None
        worker_score: Any = score_fn
        if coalesce and workers > 1 and decision_fn is None:
            from ccfd_tpu_torch.serving.batcher import DynamicBatcher

            c_disp = self.registry.counter(
                "router_coalesced_dispatches_total",
                "scorer dispatches made for the worker pool; fewer than "
                "router_worker_batches_total means workers' batches coalesced")
            c_rows = self.registry.counter(
                "router_coalesced_rows_total",
                "transaction rows scored through the coalescing batcher")

            def on_dispatch(n_rows: int) -> None:
                c_disp.inc()
                c_rows.inc(n_rows)

            # one dispatch can take every worker's full poll (the scorer
            # pads it to a bucket); two batcher workers overlap dispatches
            self.batcher = DynamicBatcher(score_fn, max_batch=max_batch * workers,
                                          deadline_ms=cfg.batch_deadline_ms,
                                          on_dispatch=on_dispatch, workers=2,
                                          profiler=profiler,
                                          profile_stage="router.coalesce")
            worker_score = self.batcher.score

        self.workers = [
            Router(cfg, broker, worker_score, engine, self.registry, max_batch=max_batch,
                   rules=rules, host_score_fn=host_score_fn, breaker=self._breaker,
                   degrade=degrade, max_inflight=self.max_inflight, tracer=tracer,
                   inflight_budget=self._budget, worker_id=i, overload=overload,
                   decision_fn=decision_fn, profiler=profiler, heal_gate=heal_gate)
            for i in range(workers)
        ]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- facade ------------------------------------------------------------
    @property
    def engine(self) -> Any:
        return self.workers[0].engine

    def step(self, poll_timeout_s: float = 0.0) -> int:
        """One synchronous cycle across every worker, sequentially on the
        calling thread (a lone submit to the batcher dispatches at once)."""
        return sum(w.step(poll_timeout_s) for w in self.workers)

    def pause(self, timeout_s: float = 10.0) -> bool:
        """Group-wide batch-boundary hold: every worker's hold requested up
        front, then the acks awaited against one deadline."""
        deadline = time.monotonic() + timeout_s
        for w in self.workers:
            w.request_pause()
        ok = True
        for w in self.workers:
            ok = w.await_pause(max(0.0, deadline - time.monotonic())) and ok
        return ok

    def resume(self) -> None:
        for w in self.workers:
            w.resume()

    def recycle_consumers(self) -> None:
        for w in self.workers:
            w.recycle_consumers()

    def swap_engine(self, engine: Any) -> None:
        for w in self.workers:
            w.swap_engine(engine)

    def set_heal_gate(self, gate: Any) -> None:
        for w in self.workers:
            w.set_heal_gate(gate)

    # -- daemon loop -------------------------------------------------------
    def reset(self) -> None:
        self._stop.clear()
        for w in self.workers:
            w.reset()

    def run(self, poll_timeout_s: float = 0.05) -> None:
        """One loop thread per worker; blocks until stop(). A worker's
        crash stops the whole pool and re-raises here, so its partitions are
        never stranded behind a healthy-looking run()."""
        crashes: list[BaseException] = []

        def worker_main(w: Router) -> None:
            try:
                while not self._stop.is_set():
                    w.reset()
                    w.run(poll_timeout_s)
            except BaseException as e:  # noqa: BLE001 - re-raised from run()
                crashes.append(e)
                self.stop()

        # a loop thread still alive from a previous run (wedged in a score)
        # carries on: a second one would race its consumers
        threads: list[threading.Thread] = []
        for i, w in enumerate(self.workers):
            old = self._threads[i] if i < len(self._threads) else None
            if old is not None and old.is_alive():
                threads.append(old)
                continue
            t = threading.Thread(target=worker_main, args=(w,), daemon=True,
                                 name=f"ccfd-router-w{i}")
            threads.append(t)
            t.start()
        self._threads = threads
        self._stop.wait()
        for w in self.workers:
            w.stop()
        for t in threads:
            t.join(timeout=30)
        if crashes:
            raise crashes[0]

    def start(self, poll_timeout_s: float = 0.05) -> threading.Thread:
        self.reset()
        t = threading.Thread(target=self.run, args=(poll_timeout_s,), daemon=True,
                             name="ccfd-router")
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
        for w in self.workers:
            w.stop()

    def close(self) -> None:
        self.stop()
        for w in self.workers:
            w.close()
        if self.batcher is not None:
            self.batcher.stop()
