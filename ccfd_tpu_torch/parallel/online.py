"""Online retraining: process-engine labels -> SGD on the device -> hot swap.

The port of ccfd_tpu/parallel/online.py's ``OnlineTrainer``:

1. consume label events from the bus (published by the fraud process on
   resolution, ``process/fraud.py`` ``record``), all-or-nothing per
   record;
2. keep a reservoir of the last ``buffer_size`` labels; once
   ``retrain_min_labels`` are buffered and new ones arrived, run
   ``steps_per_round`` train steps on ``retrain_batch``-row batches
   sampled from it (``parallel/train.py``);
3. hand the candidate to the model lifecycle's controller
   (``lifecycle=``, lifecycle/controller.py: checkpointed, versioned,
   shadowed, canaried and only then swapped into serving, or rejected and
   the trainer re-based onto the champion by ``rebase``); or, with no
   lifecycle (the direct swap), publish it into the serving Scorer with
   ``swap_params``, which stages fresh device copies (and, with the
   decision plane, runs its prepublish grid) before flipping: serving never
   pauses, and the Scorer's tensors never alias the trainer's.

Sampling uses a seeded rng that ``reset()`` re-seeds, so a re-run on the
same label stream reproduces the same candidates. The trainer trains on
the device its params lie on (the Scorer's, in the demo); the loss is read
back once a round, for ``retrain_last_loss``.

With a ``partitioner`` (parallel/partition.py) or a bare ``mesh`` the train
step is the sharded one (``parallel/train.py``): the state is laid out per
the partitioner, and each round's batch size rounds UP to a multiple of
the data axis (``round_batch``; sampling is with replacement), so every
data shard gets the same number of rows.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.parallel.train import (
    TrainConfig,
    detached,
    init_state,
    make_train_step,
)


class OnlineTrainer:
    def __init__(
        self,
        cfg: Config,
        broker: Any,
        scorer: Any,
        params: Any,
        tc: TrainConfig | None = None,
        mesh: Any = None,
        registry: Registry | None = None,
        checkpoints: Any = None,
        buffer_size: int = 65536,
        steps_per_round: int = 8,
        seed: int = 0,
        rng: np.random.Generator | None = None,
        lifecycle: Any = None,
        partitioner: Any = None,
    ):
        self.cfg = cfg
        self.mesh = mesh if partitioner is None else partitioner.mesh
        self.partitioner = partitioner
        # the layout the batch rounds to (a bare mesh's is the legacy one)
        self._layout = partitioner
        if partitioner is None and mesh is not None:
            from ccfd_tpu_torch.parallel.partition import legacy_partitioner

            self._layout = legacy_partitioner(mesh)
        self.broker = broker
        self.scorer = scorer
        # the governed rollout (lifecycle/controller.py): when set, every
        # candidate goes to it; None keeps the direct swap
        self.lifecycle = lifecycle
        self.tc = tc or TrainConfig()
        self.registry = registry or Registry()
        self.checkpoints = checkpoints
        self.buffer_size = buffer_size
        self.steps_per_round = steps_per_round
        self.seed = seed
        # an injected rng is the caller's to manage; the default is seeded
        # here and re-seeded by reset()
        self._rng_injected = rng is not None
        self._rng = rng if rng is not None else np.random.default_rng(seed)
        self.labels_seen = 0  # lifetime label count

        self._consumer = broker.consumer("online-trainer", (cfg.labels_topic,))
        self._X = np.zeros((0, len(FEATURE_NAMES)), np.float32)
        self._y = np.zeros((0,), np.float32)
        # init_state clones: the step updates in place and must never
        # alias the tensors the serving Scorer holds
        self._state = init_state(params, self.tc)
        self._new_labels = 0
        # rebase request (any thread -> trainer thread): applied at the top
        # of the next step(), never mid-round
        self._rebase_params: Any = None
        self._step_fn = make_train_step(self.tc, mesh=mesh, partitioner=partitioner)
        self._stop = threading.Event()

        r = self.registry
        self._c_labels = r.counter("retrain_labels_total", "labels consumed by class")
        self._c_steps = r.counter("retrain_steps_total", "optimizer steps run")
        self._c_swaps = r.counter("retrain_param_swaps_total", "serving hot swaps")
        self._g_loss = r.gauge("retrain_last_loss", "loss of last retrain step")

    @property
    def device(self) -> torch.device:
        return self._state["params"]["layers"][0]["w"].device

    @property
    def params(self) -> dict:
        """The trainer's current params (detached views of its state)."""
        return detached(self._state["params"])

    # -- label ingestion ---------------------------------------------------
    def _ingest(self, max_records: int = 4096) -> int:
        records = self._consumer.poll(max_records, 0.0)
        if not records:
            return 0
        rows, labels = [], []
        for rec in records:
            msg = rec.value or {}
            tx = msg.get("transaction") or {}
            try:  # parse the whole record before appending anything: a partial
                # failure must not desynchronize the (X, y) pairing
                row = [float(tx.get(n, 0.0) or 0.0) for n in FEATURE_NAMES]
                label = float(msg.get("label", 0))
            except (TypeError, ValueError):
                continue
            rows.append(row)
            labels.append(label)
            self._c_labels.inc(labels={"class": "fraud" if label > 0.5 else "legit"})
        if not rows:
            return 0
        self._X = np.concatenate([self._X, np.asarray(rows, np.float32)])[-self.buffer_size:]
        self._y = np.concatenate([self._y, np.asarray(labels, np.float32)])[-self.buffer_size:]
        self.labels_seen += len(rows)
        return len(rows)

    # -- rebase ------------------------------------------------------------
    def rebase(self, params: Any) -> None:
        """Re-base the training state onto ``params`` at the next
        ``step()`` (staged here from any thread, applied on the trainer's).
        ``params`` are copied now, so the caller may change them after."""
        dev = self.device
        self._rebase_params = {
            "norm": {k: torch.as_tensor(v).detach().to(dev, torch.float32, copy=True)
                     for k, v in params["norm"].items()},
            "layers": [{k: torch.as_tensor(v).detach().to(dev, torch.float32, copy=True)
                        for k, v in layer.items()} for layer in params["layers"]],
        }

    # -- one retrain round -------------------------------------------------
    def step(self) -> bool:
        """Ingest labels; train and publish (submit or swap) only when new
        labels arrived and the buffer is warm. Returns whether it published (so the run loop
        sleeps instead of re-training a stale buffer in a tight loop)."""
        pending = self._rebase_params
        if pending is not None:
            self._rebase_params = None
            self._state = init_state(pending, self.tc)
        self._new_labels += self._ingest()
        if len(self._y) < self.cfg.retrain_min_labels or self._new_labels == 0:
            return False
        self._new_labels = 0
        batch = min(self.cfg.retrain_batch, len(self._y))
        if self._layout is not None:
            # every data shard gets the same rows (sampling with
            # replacement, so rounding UP is always satisfiable)
            batch = self._layout.round_batch(batch)
        loss = None
        for _ in range(self.steps_per_round):
            idx = self._rng.integers(0, len(self._y), size=batch)
            self._state, loss = self._step_fn(
                self._state, torch.from_numpy(self._X[idx]), torch.from_numpy(self._y[idx]))
            self._c_steps.inc()
        if loss is not None:
            self._g_loss.set(float(loss))
        new_params = self.params
        if self.lifecycle is not None:
            # the controller copies, checkpoints and versions the candidate
            # and walks it through shadow and canary before any params
            # reach serving
            self.lifecycle.submit_candidate(new_params, label_watermark=self.labels_seen)
        else:
            self.scorer.swap_params(new_params)
            self._c_swaps.inc()
        if self.checkpoints is not None:
            self.checkpoints.save(int(self._state["step"]), new_params)
        return True

    # -- daemon ------------------------------------------------------------
    def reset(self) -> None:
        """Re-arm after stop(); re-seeds the default rng so a restarted loop
        replays the same sampling stream (an injected rng is the caller's)."""
        self._stop.clear()
        if not self._rng_injected:
            self._rng = np.random.default_rng(self.seed)

    def run(self, interval_s: float = 1.0) -> None:
        while not self._stop.is_set():
            if not self.step():
                self._stop.wait(interval_s)

    def start(self, interval_s: float = 1.0) -> threading.Thread:
        self.reset()
        t = threading.Thread(target=self.run, args=(interval_s,), daemon=True,
                             name="ccfd-retrain")
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.stop()
        self._consumer.close()
