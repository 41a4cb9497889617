"""Learned user-task outcome model: the reference's second Seldon model.

The port's copy of ccfd_tpu/process/usertask_model.py. The reference
system deploys a dedicated Seldon model whose job is predicting the
outcome of jBPM investigation user tasks: confidence >=
``CONFIDENCE_THRESHOLD`` auto-closes the task with the predicted outcome,
lower confidence only pre-fills it. ``OnlineUserTaskModel`` is both the
prediction service and its trainer:

- ``predict(task)`` scores a (1, 31) row (the 30 transaction features plus
  the fraud probability the router attached) through a logistic
  regression on the model's device. Confidence is ``max(p, 1-p)``.
- ``observe(task)`` ingests a HUMAN task completion as a labeled example.
  Auto-completed tasks are never observed (that would be feedback, not
  supervision).
- Every ``fit_every`` observations it runs ``epochs`` full-batch SGD
  epochs over the example buffer, padded to a power-of-two bucket with the
  padding rows masked, and swaps the params it serves.

Until ``min_examples`` human decisions exist, ``predict`` returns zero
confidence, so every task stays open for a human.

Everything is float32 on ``device`` (the card unless the caller asks for
the CPU). ``w`` starts as ``0.01 * N(0, 1)`` from a ``torch.Generator``
seeded with ``seed``; the reference draws it from JAX's PRNG, which the
port cannot reproduce, so carrying the reference's init across goes
through ``params.from_jax_model_params("usertask", ...)`` and
``set_params``. The reference's warmup thread compiled one XLA executable
per bucket; here it runs one warm epoch per bucket (the first CUDA launch
of each shape), and ``warmup_join`` waits for it.

``save``/``load`` write the checksummed artifact of
``runtime/durability.py`` (``artifact="usertask"``) holding the
reference's npz keys, so each package loads the other's file. The engine
hook is ``Engine(task_listener=model.observe)``.
"""

from __future__ import annotations

import atexit
import io
import threading
import weakref
from typing import TYPE_CHECKING, Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ccfd_tpu_torch import device as device_mod
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES

if TYPE_CHECKING:  # pragma: no cover
    from ccfd_tpu_torch.process.engine import Task

NUM_TASK_FEATURES = len(FEATURE_NAMES) + 1  # + fraud probability
PARAM_KEYS = ("w", "b", "mean", "scale")

# models whose construction-time warmup thread may still run; the one
# atexit hook stops and joins them (a WeakSet keeps discarded models
# collectable)
_live_warmups: "weakref.WeakSet[OnlineUserTaskModel]" = weakref.WeakSet()
_atexit_registered = False


def _register_warmup(model: "OnlineUserTaskModel") -> None:
    global _atexit_registered
    _live_warmups.add(model)
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_cancel_all_warmups)


def _cancel_all_warmups() -> None:
    for m in list(_live_warmups):
        m._warmup_cancel()


def task_row(task: "Task") -> np.ndarray:
    """(1, 31) float32: transaction features + attached fraud probability."""
    from ccfd_tpu_torch.process.prediction import task_features

    feats = task_features(task)
    proba = np.asarray([[float(task.vars.get("proba", 0.0))]], np.float32)
    return np.concatenate([feats, proba], axis=1)


def _predict(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    xs = (x - params["mean"]) / params["scale"]
    return torch.sigmoid(xs @ params["w"] + params["b"])


def _loss(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
          m: torch.Tensor) -> torch.Tensor:
    """Weighted BCE over the real rows of pre-standardized ``x`` (``m``
    masks the bucket's padding rows)."""
    z = x @ w + b
    n = torch.clamp(torch.sum(m), min=1.0)
    n_pos = torch.clamp(torch.sum(y * m), min=1.0)
    n_neg = torch.clamp(torch.sum((1.0 - y) * m), min=1.0)
    w_pos = n / (2.0 * n_pos)
    w_neg = n / (2.0 * n_neg)
    ll = F.logsigmoid(z) * y * w_pos + F.logsigmoid(-z) * (1.0 - y) * w_neg
    return -torch.sum(ll * m) / n


def _sgd_epoch(params: dict, x: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
               lr: float) -> tuple[dict, torch.Tensor]:
    """One full-batch step on ``w`` and ``b`` (the buffer is the batch)."""
    w = params["w"].detach().requires_grad_(True)
    b = params["b"].detach().requires_grad_(True)
    with torch.enable_grad():
        loss = _loss(w, b, x, y, m)
        gw, gb = torch.autograd.grad(loss, (w, b))
    new = {"w": (w - lr * gw).detach(), "b": (b - lr * gb).detach()}
    return {**params, **new}, loss.detach()


def _bucket(n: int) -> int:
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket


class OnlineUserTaskModel:
    """Prediction service + online trainer for investigation outcomes."""

    def __init__(
        self,
        min_examples: int = 32,
        fit_every: int = 8,
        epochs: int = 50,
        learning_rate: float = 0.5,
        buffer_size: int = 4096,
        seed: int = 0,
        warmup: bool = True,
        device: "str | torch.device | None" = None,
    ):
        self.device = device_mod.resolve(device)
        self.min_examples = min_examples
        self.fit_every = fit_every
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.buffer_size = buffer_size
        gen = torch.Generator().manual_seed(int(seed))
        w = torch.randn((NUM_TASK_FEATURES,), generator=gen, dtype=torch.float32) * 0.01
        self._params = {
            "w": w.to(self.device),
            "b": torch.zeros((), dtype=torch.float32, device=self.device),
            # feature standardization learned from the buffer at fit time,
            # carried with the params so predict() matches
            "mean": torch.zeros((NUM_TASK_FEATURES,), dtype=torch.float32, device=self.device),
            "scale": torch.ones((NUM_TASK_FEATURES,), dtype=torch.float32, device=self.device),
        }
        self._x: list[np.ndarray] = []
        self._y: list[float] = []
        self._seen = 0
        self._trained = False
        self._lock = threading.Lock()
        self.last_loss: float | None = None
        self._warmup_thread: threading.Thread | None = None
        self._warmup_stop = threading.Event()
        if warmup:
            self._warmup_thread = threading.Thread(
                target=self._warmup, name="usertask-model-warmup", daemon=True)
            self._warmup_thread.start()
            _register_warmup(self)

    def _warmup(self) -> None:
        """One epoch per bucket the buffer can reach, off the request path."""
        try:
            params = self._params
            _predict(params, torch.zeros((1, NUM_TASK_FEATURES), device=self.device))
            bucket = _bucket(self.min_examples)
            while not self._warmup_stop.is_set():
                x = torch.zeros((bucket, NUM_TASK_FEATURES), device=self.device)
                y = torch.zeros((bucket,), device=self.device)
                _sgd_epoch(params, x, y, y, self.learning_rate)
                if bucket >= self.buffer_size:
                    break
                bucket *= 2
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except Exception:  # pragma: no cover - warmup is best-effort
            pass

    def _warmup_cancel(self) -> None:
        self._warmup_stop.set()
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout=10.0)

    def warmup_join(self, timeout: float | None = None) -> None:
        """Block until the construction-time warmup finishes."""
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout)

    # -- PredictionService protocol ---------------------------------------
    def predict(self, task: "Task") -> tuple[Any, float]:
        with self._lock:
            trained = self._trained
            params = self._params
        if not trained:
            # cold start: never auto-close, nothing to pre-fill
            return None, 0.0
        x = torch.from_numpy(task_row(task)).to(self.device)
        p = float(_predict(params, x)[0])
        return p >= 0.5, max(p, 1.0 - p)

    # -- engine task_listener ---------------------------------------------
    def observe(self, task: "Task") -> None:
        """Ingest a human-completed task; refit when enough new ones landed."""
        if task.status != "completed":
            return
        with self._lock:
            self._x.append(task_row(task)[0])
            self._y.append(1.0 if task.outcome else 0.0)
            if len(self._x) > self.buffer_size:
                self._x = self._x[-self.buffer_size:]
                self._y = self._y[-self.buffer_size:]
            self._seen += 1
            n = len(self._x)
            due = n >= self.min_examples and (
                not self._trained or self._seen % self.fit_every == 0)
            if not due:
                return
            x = np.stack(self._x)
            y = np.asarray(self._y, np.float32)
            params = self._params
        self._fit(params, x, y)

    def _fit(self, params: dict, x: np.ndarray, y: np.ndarray) -> None:
        # train outside the lock: predict() keeps serving the old params
        mu = x.mean(axis=0)
        sigma = x.std(axis=0)
        sigma = np.where(sigma < 1e-6, 1.0, sigma)
        params = {**params,
                  "mean": torch.from_numpy(mu.astype(np.float32)).to(self.device),
                  "scale": torch.from_numpy(sigma.astype(np.float32)).to(self.device)}
        n = x.shape[0]
        bucket = _bucket(n)
        xs = np.zeros((bucket, x.shape[1]), np.float32)
        xs[:n] = (x - mu) / sigma
        ys = np.zeros((bucket,), np.float32)
        ys[:n] = y
        mask = np.zeros((bucket,), np.float32)
        mask[:n] = 1.0
        x_t, y_t, m_t = (torch.from_numpy(a).to(self.device) for a in (xs, ys, mask))
        loss = None
        for _ in range(self.epochs):
            params, loss = _sgd_epoch(params, x_t, y_t, m_t, self.learning_rate)
        last = float(loss)  # syncs the device
        with self._lock:
            self._params = params
            self._trained = True
            self.last_loss = last

    @property
    def n_examples(self) -> int:
        with self._lock:
            return len(self._x)

    @property
    def trained(self) -> bool:
        with self._lock:
            return self._trained

    @property
    def params(self) -> dict[str, np.ndarray]:
        """The served params as host float32 arrays."""
        with self._lock:
            return {k: v.detach().cpu().numpy() for k, v in self._params.items()}

    def set_params(self, params: Mapping[str, Any]) -> None:
        """Serve ``params`` (``w``, ``b``, ``mean``, ``scale``; numpy or
        tensors), e.g. the reference's init carried across."""
        new = {k: torch.as_tensor(np.asarray(params[k], np.float32)).to(self.device)
               for k in PARAM_KEYS}
        with self._lock:
            self._params = new

    # -- persistence (restarts must not discard investigator supervision) --
    def save(self, path: str) -> None:
        """Checksummed atomic .npz of params + example buffer."""
        from ccfd_tpu_torch.runtime.durability import write_artifact

        with self._lock:
            params = {k: v.detach().cpu().numpy() for k, v in self._params.items()}
            x = np.stack(self._x) if self._x else np.zeros((0, NUM_TASK_FEATURES), np.float32)
            y = np.asarray(self._y, np.float32)
            trained = self._trained
            seen = self._seen
        buf = io.BytesIO()  # file object: savez won't append .npz
        np.savez(buf, x=x, y=y, trained=trained, seen=seen, **params)
        write_artifact(path, buf.getvalue(), artifact="usertask")

    def load(self, path: str) -> None:
        """Verified restore: a corrupt file falls back to the last-good
        retained generation."""
        from ccfd_tpu_torch.runtime.durability import read_artifact

        data = np.load(io.BytesIO(read_artifact(path, artifact="usertask")))
        with self._lock:
            self._params = {k: torch.from_numpy(np.asarray(data[k], np.float32)).to(self.device)
                            for k in PARAM_KEYS}
            self._x = list(data["x"])
            self._y = [float(v) for v in data["y"]]
            self._trained = bool(data["trained"])
            self._seen = int(data["seen"])
