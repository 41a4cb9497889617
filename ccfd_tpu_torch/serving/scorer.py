"""Row scorer on the card: bucketed dispatch of any registered model
(kernels B1, B2 and B3 for the MLP family) and hot-swappable params. The
port of ccfd_tpu/serving/scorer.py's ``Scorer``.

- **Fixed batch shapes.** Every request batch pads up to a configured
  bucket (CCFD_BATCH_SIZES), as in the reference, so each launch has one of
  a handful of shapes (the per-bucket dispatch counts read off that grid).
- **The kernel paths.** The model picks the kernel module; on the card a
  wrapper launches its CUDA kernel, on the CPU (``device="cpu"``, the
  tests) it runs the kernel's plain PyTorch version.
  - ``mlp`` in bf16: ``ops.fused_mlp`` (B1). Rows are cast to the bf16
    wire on the host with torch (round to nearest even, the same bits as
    the reference's ml_dtypes cast).
  - ``mlp_q8``: ``ops.fused_mlp_q8``, always. On the default int8 wire
    (``q8_wire="int8"``, CCFD_Q8_WIRE) each chunk is zero-padded to its
    bucket, normalized and quantized on the host
    (``prequantize_rows_numpy``, the model's own first requantization) and
    ships as int8 rows plus one f32 scale per row, 34 B/row, through B3.
    With ``q8_wire="f32"`` f32 rows go through B2.
  - any other model (``mlp`` in another dtype, ``logreg``/``modelfull``,
    ``gbt``, ``gbt_mxu``, an inference graph): its torch ``apply`` on f32
    rows, as the reference runs it under XLA. Its params may be any tree
    (``params.py``), a graph's ``{node: params}`` included; ``fused`` and
    ``int8_wire`` are off.
  Staged rows go into pinned buffers taken per call, are copied to the
  card with ``non_blocking=True``, scored, and copied back into a pinned
  buffer. Per-call buffers come from PyTorch's caching host allocator,
  which keeps a block out of reuse until the copies that read it have
  finished, so the batcher's concurrent workers never share one. With a
  ``telemetry`` plane (observability/device.py) every staging copy is
  bracketed by CUDA events and its bytes and time recorded once the
  dispatch has synchronized (two copies on the int8 wire, q and scale, as
  the reference's two puts).
- **Every request dispatches to the device.** The reference's host latency
  tier (small requests scored in numpy on accelerator backends), its host
  fallback while the device is wedged, and its drop to the XLA graph on a
  kernel error or on params the kernel does not take are not carried over:
  each of them would let a request skip the kernel. A kernel that fails to
  build or launch fails ``warmup`` and the request; params a kernel does
  not take fail the constructor or ``swap_params``.
- **The dispatch deadline** (``dispatch_deadline_ms`` > 0; off unless the
  environment sets it, config.py): ``score`` runs its device round trip on
  a ``DeviceDispatcher`` thread and waits at most the deadline (times the
  request's chunks). A timeout (``dispatch_timeouts``) marks the device
  wedged (``WedgeMonitor``, which probes for recovery) and raises
  ``ScorerTimeout``, as does every ``score`` while the device is wedged, so
  no new work queues behind the hang. The REST server answers it with 503
  and the router's degradation ladder counts the batch on its own tiers.
  ``warmup`` and ``score_pipelined`` are not bounded.
- **Double-buffered params.** ``swap_params`` stages fresh device tensors
  (and refolds the kernel weights) before flipping the references under
  the lock; an in-flight call keeps the tensors it snapshotted. Params
  that do not fold raise before the flip, and the old ones keep serving.
  Prepublish hooks (``add_prepublish_hook``: the decision plane,
  serving/fused.py) run every bucket against the staged params between
  the staging and the flip; a hook that raises fails the swap before the
  flip, as params that do not fold do.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Sequence

import numpy as np
import torch

from ccfd_tpu_torch.data.ccfd import NUM_FEATURES
from ccfd_tpu_torch.device import resolve
from ccfd_tpu_torch.models.registry import ModelSpec, get_model
from ccfd_tpu_torch.observability.device import settle_copies, timed_copy
from ccfd_tpu_torch.observability.profile import compile_stage
from ccfd_tpu_torch.ops import fused_mlp, fused_mlp_q8
from ccfd_tpu_torch.params import tensor_leaf, to_numpy, tree_map
from ccfd_tpu_torch.serving.dispatch import DeviceDispatcher, ScorerTimeout, WedgeMonitor

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
_Q8_WIRES = ("int8", "f32")


class Scorer:
    def __init__(
        self,
        model_name: str = "mlp",
        params: Any = None,
        batch_sizes: Sequence[int] = (16, 128, 1024, 4096, 16384),
        compute_dtype: str = "bfloat16",
        num_features: int = NUM_FEATURES,
        seed: int = 0,
        device: "str | torch.device | None" = None,
        q8_wire: str = "int8",
        dispatch_deadline_ms: float = 0.0,
        telemetry: Any = None,
    ):
        self.device = resolve(device)
        self.telemetry = telemetry  # observability/device.DeviceTelemetry
        self.spec: ModelSpec = get_model(model_name)
        self.num_features = num_features
        self.batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
        self.compute_dtype = _DTYPES.get(compute_dtype, torch.float32)
        if q8_wire not in _Q8_WIRES:
            raise ValueError(f"q8_wire must be one of {_Q8_WIRES}, not {q8_wire!r}")
        # the kernel module, on every device (on the CPU a wrapper runs
        # its plain version): B2/B3 for mlp_q8 always, B1 for the MLP in
        # bf16; None serves the model's plain torch graph
        self._q8 = self.spec.name == "mlp_q8"
        self._kmod = fused_mlp_q8 if self._q8 else (
            fused_mlp if self.spec.name == "mlp"
            and self.compute_dtype == torch.bfloat16 else None)
        self.int8_wire = self._q8 and q8_wire == "int8"
        if params is None:
            params = self.spec.init(torch.Generator().manual_seed(seed))
        self._lock = threading.Lock()
        # per-bucket dispatch tally and warmed buckets for the executable
        # inventory
        self._dispatch_counts: dict[int, int] = {}
        self._warmed: set[int] = set()
        self._prepublish_hooks: list[Any] = []
        self._live = self._stage(params)
        # the host copy the router's host tier forwards through
        # (``host_score``); refreshed by every swap
        self._host_params = to_numpy(params)
        # -- the dispatch deadline (module docstring) --
        self.dispatch_deadline_s = max(0.0, float(dispatch_deadline_ms)) / 1e3
        self.dispatch_timeouts = 0
        self._dispatcher = self._wedge = None
        if self.dispatch_deadline_s > 0:
            self._dispatcher = DeviceDispatcher()
            probe_x = np.zeros((self.batch_sizes[0], num_features), np.float32)
            self._wedge = WedgeMonitor(
                self._dispatcher, lambda: self.score_pipelined(probe_x, depth=1),
                deadline_s=self.dispatch_deadline_s)

    # -- params ------------------------------------------------------------
    def _stage(self, params: Any) -> tuple[dict, dict | None, dict | None]:
        """Fresh device copies of ``params`` and, on a kernel path, the
        folded kernel weights and (int8 wire) the host normalizer the rows
        are quantized with; committed before return. ``params`` may hold
        tensors or numpy arrays, in any tree. Raises ``ValueError`` for
        params the kernel does not take."""
        staged = tree_map(lambda a: tensor_leaf(a, self.device, copy=True), params)
        kp = host_norm = None
        if self._kmod is not None:
            folded = self._kmod.fold_for_kernel(staged)
            kp = self._kmod.pack_for_kernel(folded, self.device)
            if self.int8_wire:
                # the SAME normalizer the kernel weights were folded with
                host_norm = {k: folded[k].numpy() for k in ("mu", "sigma")}
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return staged, kp, host_norm

    @property
    def params(self) -> dict:
        return self._live[0]

    def swap_params(self, new_params: Any) -> None:
        """Publish new params without pausing serving: stage everything, run
        the prepublish hooks on the staged params, then flip the references
        under the lock. Params that do not fold, or a hook that raises,
        raise here, before the flip."""
        live = self._stage(new_params)
        host = to_numpy(new_params)
        with self._lock:
            hooks = list(self._prepublish_hooks)
        for hook in hooks:
            hook(live)
        with self._lock:
            self._live = live
            self._host_params = host

    def add_prepublish_hook(self, fn: Any) -> None:
        """``fn(staged)`` runs inside every ``swap_params`` after staging and
        before the flip; ``staged`` is the (params, kernel params, host
        normalizer) tuple the flip will install."""
        with self._lock:
            self._prepublish_hooks.append(fn)

    # -- inventory -----------------------------------------------------------
    def bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    @property
    def fused(self) -> bool:
        return self._live[1] is not None

    @property
    def kernel_name(self) -> str | None:
        """The hand kernel this scorer launches (the launch counter's name:
        B1 ``fused_mlp_bf16``, B2 ``fused_mlp_q8``, B3
        ``fused_mlp_q8_preq``), None on a plain torch graph."""
        if self._q8:
            return "fused_mlp_q8_preq" if self.int8_wire else "fused_mlp_q8"
        return "fused_mlp_bf16" if self._kmod is not None else None

    def dispatch_total(self) -> int:
        with self._lock:
            return sum(self._dispatch_counts.values())

    def executable_grid(self) -> dict:
        """The bucket grid this scorer serves from, with dispatches per
        bucket."""
        with self._lock:
            counts = dict(self._dispatch_counts)
            warmed = sorted(self._warmed)
        return {
            "model": self.spec.name,
            "kernel": self.kernel_name,
            "batch_sizes": list(self.batch_sizes),
            "warmed": warmed,
            "fused": self.fused,
            "int8_wire": self.int8_wire,
            "device": str(self.device),
            "dispatch_deadline_ms": self.dispatch_deadline_s * 1e3,
            "dispatches": {str(b): int(n) for b, n in sorted(counts.items())},
        }

    # -- dispatch ------------------------------------------------------------
    def _launch(self, live: tuple, chunk: np.ndarray, b: int) -> tuple:
        """Stage one chunk padded to bucket ``b``, score it, and queue the
        copy back; returns what ``_collect`` needs."""
        params, kp, host_norm = live
        take = chunk.shape[0]
        pin = self.device.type == "cuda"
        if self.int8_wire:
            # the rows are padded BEFORE the host quantizes them, as the
            # reference does; padded rows quantize to zeros
            padded = np.zeros((b, self.num_features), np.float32)
            padded[:take] = chunk
            q, s = fused_mlp_q8.prequantize_rows_numpy(host_norm, padded)
            staging = tuple(torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a)
                            for a in (q, s))
            (qd, tq), (sd, ts) = (timed_copy(self.telemetry, t, self.device)
                                  for t in staging)
            copies = (tq, ts)
            out = fused_mlp_q8.fused_mlp_q8_score_preq(kp, qd, sd)
        else:
            wire = self._kmod.INPUT_DTYPE if self._kmod is not None else torch.float32
            xh = torch.empty((b, self.num_features), dtype=wire, pin_memory=pin)
            xh[:take].copy_(torch.from_numpy(chunk))  # host cast to the wire
            xh[take:].zero_()
            staging = (xh,)
            xd, tx = timed_copy(self.telemetry, xh, self.device)
            copies = (tx,)
            if self._q8:
                out = fused_mlp_q8.fused_mlp_q8_score(kp, xd)
            elif kp is not None:
                out = fused_mlp.fused_mlp_score(kp, xd)
            else:
                out = self.spec.apply(params, xd, self.compute_dtype)
        oh = torch.empty((b,), dtype=torch.float32, pin_memory=pin)
        oh.copy_(out, non_blocking=True)
        done = None
        if pin:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return staging, oh, take, done, copies

    def _collect(self, pending: tuple) -> np.ndarray:
        _staging, oh, take, done, copies = pending
        if done is not None:
            done.synchronize()
        settle_copies(self.telemetry, copies)
        return oh[:take].numpy().copy()

    def warmup(self) -> None:
        """Run every bucket once through the serving path: builds the
        kernel (nvcc, first use) and raises if it does not build or
        launch."""
        with self._lock:
            live = self._live
        for b in self.batch_sizes:
            zeros = np.zeros((b, self.num_features), np.float32)
            with compile_stage("scorer.warm"):
                self._collect(self._launch(live, zeros, b))
            with self._lock:
                self._warmed.add(b)

    def score_pipelined(self, x: np.ndarray, depth: int = 2) -> np.ndarray:
        """Bulk scoring with ``depth`` dispatches in flight: the next
        chunk's copy and kernel are queued before the previous chunk's
        result is read back."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        n = x.shape[0]
        if n == 0:
            return np.zeros((0,), np.float32)
        if x.ndim != 2 or x.shape[1] != self.num_features:
            raise ValueError(
                f"expected (n, {self.num_features}) rows, got {x.shape}")
        with self._lock:
            # one snapshot: a concurrent swap must not pair a new
            # quantization grid with the old kernel weights
            live = self._live
        largest = self.batch_sizes[-1]
        pending: deque = deque()
        chunks: list[np.ndarray] = []
        start = 0
        while start < n:
            take = min(n - start, largest)
            b = self.bucket(take)
            with self._lock:  # batcher workers share this scorer
                self._dispatch_counts[b] = self._dispatch_counts.get(b, 0) + 1
            pending.append(self._launch(live, x[start:start + take], b))
            if len(pending) >= depth:
                chunks.append(self._collect(pending.popleft()))
            start += take
        while pending:
            chunks.append(self._collect(pending.popleft()))
        return np.concatenate(chunks)

    def score(self, x: np.ndarray) -> np.ndarray:
        """(n, F) float32 -> (n,) float32 proba_1: the synchronous latency
        path, one chunk in flight, within the dispatch deadline where one
        is set (module docstring)."""
        if self._dispatcher is None:
            return self.score_pipelined(x, depth=1)
        if self._wedge.wedged:
            raise ScorerTimeout(f"device wedged for {self._wedge.wedged_for_s:.1f}s")
        # the deadline is for one bucketed dispatch: a request of many chunks
        # gets one deadline a chunk
        n_chunks = max(1, -(-len(x) // self.batch_sizes[-1]))
        try:
            return self._dispatcher.call(lambda: self.score_pipelined(x, depth=1),
                                         self.dispatch_deadline_s * n_chunks)
        except ScorerTimeout:
            with self._lock:
                self.dispatch_timeouts += 1
            self._wedge.mark_wedged()
            raise

    @property
    def wedged(self) -> bool:
        return self._wedge is not None and self._wedge.wedged

    # -- the router's host tier ------------------------------------------------
    @property
    def has_host_forward(self) -> bool:
        """True when the model has a numpy forward (every registry model;
        not an inference graph)."""
        return self.spec.apply_numpy is not None

    def host_score(self, x: np.ndarray) -> np.ndarray:
        """(n, F) -> (n,) proba_1 by the family's numpy forward over the
        host copy of the params, never touching the card. Only the router's
        degradation ladder calls it, after the scorer edge failed or while
        its breaker is open, and counts every row it scores
        (``router_degraded_total{tier="host"}``); ``score`` never falls back
        to it."""
        with self._lock:
            host_params = self._host_params
        return np.asarray(self.spec.apply_numpy(host_params, np.asarray(x, np.float32)),
                          np.float32)
