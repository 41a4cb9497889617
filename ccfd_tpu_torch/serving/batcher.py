"""Dynamic request batching: concurrent predicts coalesce into one dispatch.

The port's copy of ccfd_tpu/serving/batcher.py without the overload policy
(CoDel shedding and the bounded priority queue come with the overload
slice). Policy (adaptive, not a fixed delay):

- The worker blocks until at least one request is queued, then drains
  whatever else is ALREADY waiting — a lone sequential client therefore
  pays zero added latency.
- If the non-blocking drain found company (a concurrency signal), the
  worker keeps collecting up to ``deadline_ms`` or ``max_batch`` — under
  load, dispatches grow toward the efficient bucket sizes instead of
  degenerating into per-request launches.
- One ``scorer.score`` call serves the whole batch; rows route back to
  their requests' futures. A scorer failure fails exactly the requests in
  that batch, never the worker.
- ``workers`` > 1 OVERLAPS dispatches: while one batch is on the wire to
  the device, another worker is already collecting and launching the next.

This composes with the Scorer's shape bucketing: the batcher decides WHEN
to dispatch, the scorer pads the result to a bucket.

With a ``profiler`` (observability/profile.py) each coalesced dispatch
feeds ``<profile_stage>.batcher`` (the row-weighted queue sojourn) and
``<profile_stage>.dispatch`` (the score call), as the reference's does.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np


class DynamicBatcher:
    def __init__(
        self,
        score_fn: Callable[[np.ndarray], np.ndarray],
        max_batch: int = 16384,
        deadline_ms: float = 2.0,
        on_dispatch: Callable[[int], None] | None = None,
        workers: int = 1,
        profiler: "object | None" = None,
        profile_stage: str = "rest",
    ):
        self._score = score_fn
        self._profiler = profiler
        self._stage_queue = f"{profile_stage}.batcher"
        self._stage_dispatch = f"{profile_stage}.dispatch"
        self.max_batch = max_batch
        self.deadline_s = max(0.0, deadline_ms) / 1e3
        self._on_dispatch = on_dispatch
        # entries: (x, future, enqueue_ts)
        self._queue: list[tuple[np.ndarray, Future, float]] = []
        self._cv = threading.Condition()
        self._stop = False
        self._threads = [
            threading.Thread(target=self._run, daemon=True, name=f"ccfd-batcher-{i}")
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    # -- client side -------------------------------------------------------
    def submit(self, x: np.ndarray) -> "Future[np.ndarray]":
        """Enqueue a (n, F) request; the future resolves to its (n,) slice."""
        x = np.ascontiguousarray(x, np.float32)
        f: "Future[np.ndarray]" = Future()
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher is stopped")
            self._queue.append((x, f, time.perf_counter()))
            self._cv.notify()
        return f

    def score(self, x: np.ndarray) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        return self.submit(x).result()

    # -- worker ------------------------------------------------------------
    def _take_first(self) -> list:
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait()
            batch = self._queue
            self._queue = []
            return batch

    def _drain_locked(self, room: int) -> list:
        """Caller holds self._cv. Pops queued requests that fit in ``room``;
        a request bigger than the remaining room stays queued for its own
        dispatch (merging it would make the whole batch wait for a
        multi-bucket score)."""
        take: list = []
        while self._queue and room > 0:
            x = self._queue[0][0]
            if x.shape[0] > room:
                break
            take.append(self._queue.pop(0))
            room -= x.shape[0]
        return take

    def _run(self) -> None:
        while True:
            batch = self._take_first()
            if self._stop and not batch:
                return
            size = sum(x.shape[0] for x, _f, _e in batch)
            # company in the queue at grab time = concurrency: keep
            # collecting toward the deadline. Lone request: dispatch now.
            if len(batch) > 1 and self.deadline_s > 0:
                deadline = time.perf_counter() + self.deadline_s
                # grace: how long to wait for the NEXT arrival before
                # giving up, so merged requests are not parked for the
                # whole deadline once arrivals dry up
                grace = self.deadline_s / 8.0
                with self._cv:
                    while size < self.max_batch and not self._stop:
                        more = self._drain_locked(self.max_batch - size)
                        if more:
                            batch.extend(more)
                            size += sum(x.shape[0] for x, _f, _e in more)
                            continue
                        if self._queue:
                            break  # head doesn't fit: give it its own dispatch
                        remaining = deadline - time.perf_counter()
                        # wait wakes on submit's notify, else the grace
                        # lapses and the batch goes — no busy polling
                        if remaining <= 0 or not self._cv.wait(
                            timeout=min(grace, remaining)
                        ):
                            break
            if batch:
                self._dispatch(batch)

    def _dispatch(self, batch: list) -> None:
        xs = [x for x, _f, _e in batch]
        n_rows = int(sum(x.shape[0] for x in xs))
        t0 = time.perf_counter()
        if self._profiler is not None:
            # queue sojourn up to dispatch assembly, row-weighted mean
            wait = sum((t0 - e) * x.shape[0] for x, _f, e in batch) / max(1, n_rows)
            self._profiler.observe(self._stage_queue, queue_s=wait, rows=n_rows)
        try:
            proba = self._score(np.concatenate(xs) if len(xs) > 1 else xs[0])
        except Exception as e:  # noqa: BLE001 - fail the batch, not the worker
            for _x, f, _e2 in batch:
                if not f.cancelled():
                    f.set_exception(e)
            return
        if self._profiler is not None:
            self._profiler.observe(self._stage_dispatch,
                                   dispatch_s=time.perf_counter() - t0,
                                   batch=n_rows, rows=n_rows)
        if self._on_dispatch is not None:
            self._on_dispatch(n_rows)
        off = 0
        for x, f, _e in batch:
            n = x.shape[0]
            if not f.cancelled():
                f.set_result(np.asarray(proba[off : off + n]))
            off += n

    def qsize(self) -> int:
        """Requests currently queued (the operator's memory probe)."""
        with self._cv:
            return len(self._queue)

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        # fail anything still queued so no caller blocks forever
        with self._cv:
            leftovers = self._queue
            self._queue = []
        for _x, f, _e in leftovers:
            if not f.done():
                f.set_exception(RuntimeError("batcher stopped"))
