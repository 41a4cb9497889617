"""Row scorer on the card: bucketed dispatch through kernel B1 and
hot-swappable params. The port of ccfd_tpu/serving/scorer.py's ``Scorer``.

- **Fixed batch shapes.** Every request batch pads up to a configured
  bucket (CCFD_BATCH_SIZES), as in the reference, so each launch has one of
  a handful of shapes (the per-bucket dispatch counts read off that grid).
- **The kernel path.** For ``mlp`` in bf16 every dispatch goes through
  ``ops.fused_mlp.fused_mlp_score``: on the card that is the CUDA kernel,
  on the CPU (``device="cpu"``, the tests) its plain PyTorch version. Rows
  are cast to the bf16 wire on the host with torch (round to nearest even,
  the same bits as the reference's ml_dtypes cast), written into a pinned
  staging buffer taken per call, copied to the card with
  ``non_blocking=True``, scored, and copied back into a pinned buffer.
  Per-call buffers come from PyTorch's caching host allocator, which keeps
  a block out of reuse until the copies that read it have finished, so the
  batcher's concurrent workers never share one.
- **Every request dispatches to the device.** The reference's host latency
  tier (small requests scored in numpy on accelerator backends), its
  dispatch deadline with host fallback, and its drop to the XLA graph on a
  kernel error are not carried over: each of them would let a request skip
  the kernel without a trace. A kernel that fails to build or launch fails
  ``warmup`` and the request.
- **Double-buffered params.** ``swap_params`` stages fresh device tensors
  (and refolds the kernel weights) before flipping the references under
  the lock; an in-flight call keeps the tensors it snapshotted.
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
from ccfd_tpu_torch.ops import fused_mlp

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


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
    ):
        self.device = resolve(device)
        self.spec: ModelSpec = get_model(model_name)
        self.num_features = num_features
        self.batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
        self.compute_dtype = _DTYPES.get(compute_dtype, torch.float32)
        # the kernel is on whenever the model is the MLP in bf16, on every
        # device: on the CPU its wrapper runs the plain version
        self._use_kernel = (self.spec.name == "mlp"
                            and self.compute_dtype == torch.bfloat16)
        if params is None:
            params = self.spec.init(torch.Generator().manual_seed(seed),
                                    num_features)
        self._lock = threading.Lock()
        # per-bucket dispatch tally for the executable inventory
        self._dispatch_counts: dict[int, int] = {}
        self._params, self._kernel_params = self._stage(params)

    # -- params ------------------------------------------------------------
    def _stage(self, params: Any) -> tuple[dict, dict | None]:
        """Fresh device copies of ``params`` and, on the kernel path, the
        folded kernel weights; committed before return. ``params`` may hold
        tensors or numpy arrays."""
        def put(a: Any) -> torch.Tensor:
            return torch.as_tensor(a).to(self.device, torch.float32, copy=True)

        staged = {
            "norm": {k: put(v) for k, v in params["norm"].items()},
            "layers": [{k: put(v) for k, v in layer.items()}
                       for layer in params["layers"]],
        }
        kp = None
        if self._use_kernel:
            kp = fused_mlp.pack_for_kernel(fused_mlp.fold_for_kernel(staged),
                                           self.device)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return staged, kp

    @property
    def params(self) -> dict:
        return self._params

    def swap_params(self, new_params: Any) -> None:
        """Publish new params without pausing serving: stage everything,
        then flip the references under the lock."""
        staged, kp = self._stage(new_params)
        with self._lock:
            self._params, self._kernel_params = staged, kp

    # -- inventory -----------------------------------------------------------
    def bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    @property
    def fused(self) -> bool:
        return self._kernel_params is not None

    def dispatch_total(self) -> int:
        with self._lock:
            return sum(self._dispatch_counts.values())

    def executable_grid(self) -> dict:
        """The bucket grid this scorer serves from, with dispatches per
        bucket."""
        with self._lock:
            counts = dict(self._dispatch_counts)
        return {
            "model": self.spec.name,
            "batch_sizes": list(self.batch_sizes),
            "fused": self.fused,
            "device": str(self.device),
            "dispatches": {str(b): int(n) for b, n in sorted(counts.items())},
        }

    # -- dispatch ------------------------------------------------------------
    def _launch(self, params: dict, kp: dict | None, chunk: np.ndarray,
                b: int) -> tuple:
        """Stage one chunk padded to bucket ``b``, score it, and queue the
        copy back; returns what ``_collect`` needs."""
        take = chunk.shape[0]
        pin = self.device.type == "cuda"
        wire = fused_mlp.INPUT_DTYPE if kp is not None else torch.float32
        xh = torch.empty((b, self.num_features), dtype=wire, pin_memory=pin)
        xh[:take].copy_(torch.from_numpy(chunk))  # host cast to the wire
        xh[take:].zero_()
        xd = xh.to(self.device, non_blocking=True)
        if kp is not None:
            out = fused_mlp.fused_mlp_score(kp, xd)
        else:
            out = self.spec.apply(params, xd, self.compute_dtype)
        oh = torch.empty((b,), dtype=torch.float32, pin_memory=pin)
        oh.copy_(out, non_blocking=True)
        done = None
        if pin:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return xh, oh, take, done

    @staticmethod
    def _collect(pending: tuple) -> np.ndarray:
        _xh, oh, take, done = pending
        if done is not None:
            done.synchronize()
        return oh[:take].numpy().copy()

    def warmup(self) -> None:
        """Run every bucket once through the serving path: builds the
        kernel (nvcc, first use) and raises if it does not build or
        launch."""
        with self._lock:
            params, kp = self._params, self._kernel_params
        for b in self.batch_sizes:
            zeros = np.zeros((b, self.num_features), np.float32)
            self._collect(self._launch(params, kp, zeros, b))

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
            params, kp = self._params, self._kernel_params
        largest = self.batch_sizes[-1]
        pending: deque = deque()
        chunks: list[np.ndarray] = []
        start = 0
        while start < n:
            take = min(n - start, largest)
            b = self.bucket(take)
            with self._lock:  # batcher workers share this scorer
                self._dispatch_counts[b] = self._dispatch_counts.get(b, 0) + 1
            pending.append(self._launch(params, kp, x[start:start + take], b))
            if len(pending) >= depth:
                chunks.append(self._collect(pending.popleft()))
            start += take
        while pending:
            chunks.append(self._collect(pending.popleft()))
        return np.concatenate(chunks)

    def score(self, x: np.ndarray) -> np.ndarray:
        """(n, F) float32 -> (n,) float32 proba_1: the synchronous latency
        path, one chunk in flight."""
        return self.score_pipelined(x, depth=1)
