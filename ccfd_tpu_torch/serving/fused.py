"""FusedDecisionScorer: the decision plane over the row ``Scorer``.

The port of ccfd_tpu/serving/fused.py. Each bucket-padded chunk of rows
goes to the card once and comes back as routed verdicts: the model's
probability, the FRAUD_THRESHOLD comparison and the first-matching rule
index, evaluated on the device (ops/fused_decision.py) and copied back as
ONE packed (B, 2) float32 transfer, two chunks in flight. The router
consumes the fired indices without re-deriving anything
(router/router.py ``decision_fn``).

The forward is the one the base Scorer dispatches, on the same padded
bucket, so the probabilities equal ``Scorer.score``'s bit for bit:

- ``mlp`` in bf16: kernel B1, the rows cast from float32 to bf16 on the
  device (round to nearest even, the bits of the Scorer's host cast);
- ``mlp_q8`` on ``CCFD_Q8_WIRE=f32``: kernel B2 on the float32 rows;
- ``mlp_q8`` on the int8 wire: the host prequantizes the padded chunk as
  the Scorer does and kernel B3 scores it; the float32 rows ride along
  only when the plan reads feature columns (``plan.needs_features``);
- a Scorer without a kernel: its plain graph.

Contracts:

- **Rules that cannot compile refuse the plane loudly.** A rule base
  holding a ``when_fn`` gives one warning at construction, ``enabled``
  stays False and the whole set serves staged (``decide`` then returns
  ``(proba, None)`` and counts ``staged_fallbacks``), or it raises under
  ``strict``.
- **A decide that fails raises**, as the port's Scorer does; the router
  drops and counts the batch. The reference's runtime drop to the staged
  path is not carried over: it would let a batch skip the plane without a
  trace.
- **Swaps run the grid before publishing**: ``prepublish`` (a Scorer
  prepublish hook) runs every bucket against the staged params before the
  flip, and raises, failing the swap, if one does not run.

With a ``profiler`` (observability/profile.py) each ``decide`` feeds the
``fused.decide`` stage's dispatch time, as the reference's does; the
staging copies are timed on the base Scorer's ``telemetry``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from ccfd_tpu_torch.observability.device import settle_copies, timed_copy
from ccfd_tpu_torch.observability.profile import compile_stage
from ccfd_tpu_torch.ops import fused_mlp, fused_mlp_q8
from ccfd_tpu_torch.ops.fused_decision import (
    UnvectorizableRuleSet,
    build_decision_fn,
    compile_rules,
    eval_plan,
)
from ccfd_tpu_torch.router.rules import RuleSet

log = logging.getLogger(__name__)


class FusedDecisionScorer:
    """``decide(x) -> (proba, fired)``: float32 probabilities bit-identical
    to the staged path and int64 fired-rule indices into ``rules.rules``,
    or ``(proba, None)`` from the staged path when the plane was refused
    (the router then evaluates the rules on the host)."""

    def __init__(self, scorer: Any, rules: RuleSet, *, registry: Any = None,
                 strict: bool = False, profiler: Any = None):
        self._base = scorer
        self._profiler = profiler  # observability/profile.StageProfiler
        self.rules = rules
        self._lock = threading.Lock()
        self._dispatch_counts: dict[int, int] = {}
        self._warmed: set[int] = set()
        self.enabled = False
        self.host_syncs = 0  # device->host copies of packed verdicts
        self.staged_fallbacks = 0
        self.warm_dispatches = 0  # grid runs of warmup and prepublish, one per bucket
        self._plan = None
        c = registry.counter if registry is not None else None
        self._c_decide = c and c("fused_decision_dispatches_total",
                                 "rows decided by the fused decision plane")
        self._c_fallback = c and c(
            "fused_decision_fallbacks_total",
            "decide() rows served by the staged path because the plane was refused")
        try:
            self._plan = compile_rules(rules)
        except UnvectorizableRuleSet as e:
            # ONE loud compile-time decision for the whole rule set
            if strict:
                raise RuntimeError(f"fused decision refused: {e}") from e
            log.warning("fused decision disabled; serving the STAGED path: %s", e)
            return
        self._tensors = self._plan.tensors(scorer.device)
        self._decide_rows = build_decision_fn(self._forward, self._plan)
        self.enabled = True

    # -- the forwards ------------------------------------------------------
    @property
    def forward_kind(self) -> str:
        base = self._base
        if base.int8_wire:
            return "fused_kernel_int8_wire"
        return "fused_kernel" if base._kmod is not None else "graph"

    def _forward(self, live: tuple, xd: torch.Tensor) -> torch.Tensor:
        """Float32 rows on the device -> proba, as the staged path computes it."""
        params, kp, _host_norm = live
        base = self._base
        if base._q8:
            return fused_mlp_q8.fused_mlp_q8_score(kp, xd)
        if kp is not None:
            # the staged wire's bf16 cast, on the device: the same bits
            return fused_mlp.fused_mlp_score(kp, xd.to(fused_mlp.INPUT_DTYPE))
        return base.spec.apply(params, xd, base.compute_dtype)

    def _decide_preq(self, kp: dict, qd: torch.Tensor, sd: torch.Tensor,
                     xd: torch.Tensor) -> torch.Tensor:
        """The int8 wire: B3 on the host-prequantized rows, then the rules
        over ``xd`` (the float32 rows, or zeros when no rule reads them)."""
        proba = fused_mlp_q8.fused_mlp_q8_score_preq(kp, qd, sd).float()
        fired = eval_plan(self._plan, xd, proba, self._tensors)
        return torch.stack([proba, fired.float()], dim=1)

    def _launch(self, live: tuple, chunk: np.ndarray, b: int) -> tuple:
        """Stage one chunk padded to bucket ``b`` (as ``Scorer._launch``
        does), run the decision program, and queue the one copy back."""
        base = self._base
        _params, kp, host_norm = live
        dev = base.device
        pin = dev.type == "cuda"
        take, n_feat = chunk.shape
        if base.int8_wire:
            padded = np.zeros((b, n_feat), np.float32)
            padded[:take] = chunk
            q, s = fused_mlp_q8.prequantize_rows_numpy(host_norm, padded)
            host = [torch.from_numpy(a) for a in (q, s)]
            if self._plan.needs_features:
                host.append(torch.from_numpy(padded))
            staging = tuple(h.pin_memory() if pin else h for h in host)
            moved = [timed_copy(base.telemetry, h, dev) for h in staging]
            copies = tuple(tok for _d, tok in moved)
            qd, sd, *rest = (d for d, _tok in moved)
            xd = rest[0] if rest else torch.zeros((b, n_feat), dtype=torch.float32,
                                                  device=dev)
            out = self._decide_preq(kp, qd, sd, xd)
        else:
            xh = torch.empty((b, n_feat), dtype=torch.float32, pin_memory=pin)
            xh[:take].copy_(torch.from_numpy(chunk))
            xh[take:].zero_()
            staging = (xh,)
            xd, tok = timed_copy(base.telemetry, xh, dev)
            copies = (tok,)
            out = self._decide_rows(live, xd)
        oh = torch.empty((b, 2), dtype=torch.float32, pin_memory=pin)
        oh.copy_(out, non_blocking=True)
        done = None
        if pin:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        return staging, oh, take, done, copies

    def _collect(self, pending: tuple) -> np.ndarray:
        _staging, oh, take, done, copies = pending
        if done is not None:
            done.synchronize()
        settle_copies(self._base.telemetry, copies)
        with self._lock:
            self.host_syncs += 1
        return oh[:take].numpy().copy()

    # -- serving -------------------------------------------------------------
    def decide(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
        """(n, F) rows -> (proba, fired) through the bucket grid, two chunks
        in flight; ``(proba, None)`` from the staged path when the plane
        was refused."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        n = x.shape[0]
        if n == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        if not self.enabled:
            return self._staged(x)
        base = self._base
        with base._lock:  # one snapshot for every chunk of the call
            live = base._live
        t0 = time.perf_counter()
        largest = base.batch_sizes[-1]
        pending: deque = deque()
        chunks: list[np.ndarray] = []
        start = 0
        while start < n:
            take = min(n - start, largest)
            b = base.bucket(take)
            with self._lock:
                self._dispatch_counts[b] = self._dispatch_counts.get(b, 0) + 1
            pending.append(self._launch(live, x[start:start + take], b))
            if len(pending) >= 2:
                chunks.append(self._collect(pending.popleft()))
            start += take
        while pending:
            chunks.append(self._collect(pending.popleft()))
        if self._c_decide:
            self._c_decide.inc(n)
        if self._profiler is not None:
            self._profiler.observe("fused.decide", dispatch_s=time.perf_counter() - t0,
                                   batch=n, rows=n)
        packed = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        proba = np.ascontiguousarray(packed[:, 0], np.float32)
        fired = packed[:, 1].astype(np.int64)  # small ints: exact in float32
        return proba, fired

    def _staged(self, x: np.ndarray) -> tuple[np.ndarray, None]:
        """The refused plane's path: the base scorer, and the router's host
        rules on ``fired=None``; counted."""
        with self._lock:
            self.staged_fallbacks += 1
        if self._c_fallback:
            self._c_fallback.inc(len(x))
        return np.asarray(self._base.score(x), np.float32), None

    # -- warmup / swap ---------------------------------------------------------
    def warmup(self) -> None:
        """Run every bucket of the grid once on the live params (builds the
        kernel at first use; raises if a bucket does not run)."""
        if self.enabled:
            with self._base._lock:
                live = self._base._live
            with compile_stage("fused.warm"):
                self._run_grid(live)
            with self._lock:
                self._warmed.update(self._base.batch_sizes)

    def prepublish(self, staged: tuple) -> None:
        """Scorer prepublish hook: every bucket against the staged params,
        before ``swap_params`` flips them in."""
        if self.enabled:
            self._run_grid(staged)

    def _run_grid(self, live: tuple) -> None:
        base = self._base
        for b in base.batch_sizes:
            with self._lock:
                self.warm_dispatches += 1
            _staging, _oh, _take, done, copies = self._launch(
                live, np.zeros((b, base.num_features), np.float32), b)
            if done is not None:
                done.synchronize()
            settle_copies(base.telemetry, copies)

    # -- observability -------------------------------------------------------
    def dispatch_total(self) -> int:
        with self._lock:
            return sum(self._dispatch_counts.values())

    def executable_grid(self) -> dict:
        """The plane's bucket grid with per-bucket dispatch counts and its
        health: what is serving verdicts."""
        with self._lock:
            counts = dict(self._dispatch_counts)
            warmed = sorted(self._warmed)
        return {
            "model": self._base.spec.name,
            "kernel": self._base.kernel_name,
            "batch_sizes": list(self._base.batch_sizes),
            "warmed": warmed,
            "forward": self.forward_kind,
            "rules": self._plan.n_rules if self._plan is not None else 0,
            "needs_features": bool(self._plan is not None and self._plan.needs_features),
            "enabled": self.enabled,
            "staged_fallbacks": int(self.staged_fallbacks),
            "host_syncs": int(self.host_syncs),
            "warm_dispatches": int(self.warm_dispatches),
            "dispatches": {str(b): int(c) for b, c in sorted(counts.items())},
        }


__all__ = ["FusedDecisionScorer"]
