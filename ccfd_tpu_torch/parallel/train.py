"""Training the flagship MLP: the port of ccfd_tpu/parallel/train.py.

``make_train_step`` builds one step of forward, weighted BCE, backward and
SGD-with-momentum update. The reference jits ``jax.value_and_grad`` of
``mlp.loss_fn`` and applies ``optax.sgd(lr, momentum)``; here autograd
computes the gradient and ``torch.optim.SGD(lr, momentum, dampening=0,
nesterov=False)`` applies the same update: the trace starts at the first
gradient, ``trace = momentum * trace + g`` and ``p -= lr * trace``. The
training math stays torch code on the device, as it stays XLA's in the
reference: no Pallas kernel lies on it.

The state (``init_state``) owns clones of every leaf: the step updates the
weights in place, as the reference's step donates them, so it never
aliases the caller's tensors (the demo builds a trainer from the Scorer's
live params). Only the layers' weights and biases train; the normalizer is
data. The step keeps the loss on the device.

``fit_mlp`` is the reference's offline trainer line for line: the
normalizer from the data, class-balanced batches (25% positive) when the
positive rate is under ``balance_below``, drawn from
``np.random.default_rng(seed)`` with the same calls in the same order, and
the King-Zeng prior correction of the last bias. Deviation: the
reference's init comes from ``jax.random.PRNGKey(seed)`` (threefry), which
cannot be drawn without JAX; the port draws the same He init from a
``torch.Generator`` seeded with ``seed`` on the CPU and moves it to the
device, so the CPU and the card start from the same weights.

Not ported: the sharded step (``mesh=``, ``partitioner=``; ROADMAP A15).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ccfd_tpu_torch.device import resolve
from ccfd_tpu_torch.models import mlp
from ccfd_tpu_torch.params import to_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    momentum: float = 0.9
    pos_weight: float = 8.0  # up-weight the rare fraud class
    compute_dtype: str = "bfloat16"


def refuse_sharding(mesh: Any, partitioner: Any) -> None:
    if mesh is not None or partitioner is not None:
        raise NotImplementedError(
            "mesh=/partitioner=: sharded training is not ported yet "
            "(ROADMAP A15, multi-GPU); train on one device")


def make_optimizer(tc: TrainConfig, weights: list[torch.Tensor]) -> torch.optim.SGD:
    """``optax.sgd(lr, momentum)`` over ``weights``."""
    return torch.optim.SGD(weights, lr=tc.learning_rate, momentum=tc.momentum,
                           dampening=0.0, nesterov=False)


def trainable(params: dict) -> list[torch.Tensor]:
    """The leaves SGD updates: every layer's weights and biases."""
    return [layer[k] for layer in params["layers"] for k in sorted(layer)]


def init_state(params: Any, tc: TrainConfig) -> dict[str, Any]:
    """A training state over float32 clones of ``params`` (tensors, on the
    device they lie on, or numpy arrays): ``params``, ``opt_state`` (the
    optimizer) and ``step``."""
    def clone(a: Any) -> torch.Tensor:
        t = torch.as_tensor(a)
        return t.detach().to(t.device, torch.float32, copy=True)

    own = {
        "norm": {k: clone(v) for k, v in params["norm"].items()},
        "layers": [{k: clone(v).requires_grad_(True) for k, v in layer.items()}
                   for layer in params["layers"]],
    }
    return {"params": own, "opt_state": make_optimizer(tc, trainable(own)), "step": 0}


def make_train_step(
    tc: TrainConfig,
    mesh: Any = None,
    loss_fn: Callable[..., torch.Tensor] | None = None,
    partitioner: Any = None,
) -> Callable[[dict, Any, Any], tuple[dict, torch.Tensor]]:
    """(state, x, y) -> (state, loss): one update of ``state`` in place.
    ``x`` and ``y`` are tensors or numpy arrays; they are moved to the
    state's device. The loss is a 0-d tensor on that device."""
    refuse_sharding(mesh, partitioner)
    dtype = _DTYPES.get(tc.compute_dtype, torch.float32)
    base_loss = loss_fn or (
        lambda p, x, y: mlp.loss_fn(p, x, y, pos_weight=tc.pos_weight, compute_dtype=dtype))

    def step(state: dict, x: Any, y: Any) -> tuple[dict, torch.Tensor]:
        params, opt = state["params"], state["opt_state"]
        dev = params["layers"][0]["w"].device
        x = torch.as_tensor(x).to(dev, torch.float32)
        y = torch.as_tensor(y).to(dev, torch.float32)
        opt.zero_grad(set_to_none=True)
        loss = base_loss(params, x, y)
        loss.backward()
        opt.step()
        state["step"] += 1
        return state, loss.detach()

    return step


def detached(params: dict) -> dict:
    """The same tensors without their autograd state (views; no copy)."""
    return {
        "norm": {k: v.detach() for k, v in params["norm"].items()},
        "layers": [{k: v.detach() for k, v in layer.items()} for layer in params["layers"]],
    }


# ---------------------------------------------------------------------------
# Convenience offline trainer (model prep for serving)


def fit_mlp(
    X: np.ndarray,
    y: np.ndarray,
    hidden: int = mlp.DEFAULT_HIDDEN,
    steps: int = 500,
    batch: int = 1024,
    tc: TrainConfig | None = None,
    seed: int = 0,
    mesh: Any = None,
    balance_below: float = 0.05,
    device: Any = None,
) -> dict:
    """Train the flagship MLP on (X, y) on ``device`` (default: the card);
    returns the trained params there.

    Heavily imbalanced data trains with class-balanced batches (25%
    positive) plus an exact log-odds recalibration of the output bias for
    the sampling ratio, so ``proba_1`` stays calibrated to the true base
    rate (the FRAUD_THRESHOLD contract reads absolute probabilities). It
    applies whenever the positive rate is under ``balance_below`` (5%)."""
    refuse_sharding(mesh, None)
    tc = tc or TrainConfig()
    dev = resolve(device)
    params = to_device(mlp.init(torch.Generator().manual_seed(seed),
                                num_features=X.shape[1], hidden=hidden), dev)
    params = mlp.set_normalizer(params, X.mean(0), X.std(0))
    state = init_state(params, tc)
    step_fn = make_train_step(tc)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    bsz = min(batch, n)
    pos_idx = np.flatnonzero(y == 1)
    p_true = len(pos_idx) / max(1, n)
    balanced = 0 < p_true < balance_below and len(pos_idx) >= 2
    q = 0.25  # positive fraction per balanced batch
    n_pos_b = max(1, int(bsz * q))
    neg_idx = np.flatnonzero(y == 0) if balanced else None
    for _ in range(steps):
        if balanced:
            idx = np.concatenate([
                rng.choice(pos_idx, size=n_pos_b, replace=True),
                rng.choice(neg_idx, size=bsz - n_pos_b, replace=True),
            ])
        else:
            idx = rng.integers(0, n, size=bsz)
        state, _ = step_fn(state, torch.from_numpy(np.asarray(X[idx], np.float32)),
                           torch.from_numpy(np.asarray(y[idx], np.float32)))
    params = detached(state["params"])
    if balanced:
        # exact prior correction for a logistic model trained at sampling
        # rate q and deployed at base rate p: shift the output logit by
        # -[log(w) + logit(q) - logit(p)] (King & Zeng 2001), the loss's
        # pos_weight w folding into the same offset
        q_eff = n_pos_b / bsz
        off = float(
            np.log(max(1e-9, tc.pos_weight))
            + np.log(q_eff / (1 - q_eff))
            - np.log(p_true / (1 - p_true))
        )
        last = params["layers"][-1]
        last["b"] = last["b"] - off
    return params
