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

The sharded step (``partitioner=``, parallel/partition.py, or a bare
``mesh=``: the legacy megatron layout of ``sharding.mlp_param_spec``) lays
the state out per the partitioner on its first call (``layout_state``:
each param a ``ShardedTensor`` whose blocks the optimizer updates) and
splits every batch over the data axis (its rows must divide evenly:
``Partitioner.round_batch``). Each data shard runs the forward on its
device with the params gathered there through autograd; the loss's
numerator and denominator (the weighted BCE's two sums) are summed over
the shards, so one backward sums the shards' gradients into the blocks:
the reference's psum. The summation order differs from one device's, so
the sharded step agrees with the single-device one to a tolerance, not bit
for bit. When ``torch.distributed`` is initialized (parallel/multihost.py)
the denominator, the gradients and the loss are also all-reduced over the
process group, each process feeding its own rows: every process then holds
the same loss and the same params.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ccfd_tpu_torch.device import resolve
from ccfd_tpu_torch.models import mlp
from ccfd_tpu_torch.models.losses import weighted_bce_parts
from ccfd_tpu_torch.params import to_device
from ccfd_tpu_torch.parallel.sharding import ShardedTensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    momentum: float = 0.9
    pos_weight: float = 8.0  # up-weight the rare fraud class
    compute_dtype: str = "bfloat16"


def make_optimizer(tc: TrainConfig, weights: list[torch.Tensor]) -> torch.optim.SGD:
    """``optax.sgd(lr, momentum)`` over ``weights``."""
    return torch.optim.SGD(weights, lr=tc.learning_rate, momentum=tc.momentum,
                           dampening=0.0, nesterov=False)


def trainable(params: dict) -> list[torch.Tensor]:
    """The leaves SGD updates: every layer's weights and biases (each block
    of a sharded leaf)."""
    out: list[torch.Tensor] = []
    for layer in params["layers"]:
        for k in sorted(layer):
            leaf = layer[k]
            out.extend(leaf.blocks.values() if isinstance(leaf, ShardedTensor) else [leaf])
    return out


def init_state(params: Any, tc: TrainConfig) -> dict[str, Any]:
    """A training state over float32 clones of ``params`` (tensors, on the
    device they lie on, or numpy arrays): ``params``, ``opt_state`` (the
    optimizer) and ``step``."""
    def clone(a: Any) -> torch.Tensor:
        if isinstance(a, ShardedTensor):
            a = a.gather().detach()
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
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
    state's device. The loss is a 0-d tensor on that device. With a
    ``partitioner`` (or a bare ``mesh``) the step is the sharded one (module
    docstring)."""
    dtype = _DTYPES.get(tc.compute_dtype, torch.float32)
    if partitioner is None and mesh is not None:
        from ccfd_tpu_torch.parallel.partition import legacy_partitioner

        partitioner = legacy_partitioner(mesh)
    if partitioner is not None:
        return _sharded_step(tc, dtype, partitioner, loss_fn)
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


def layout_state(state: dict, partitioner: Any) -> None:
    """Lay a train state out over ``partitioner``'s mesh in place: each
    param becomes a ``ShardedTensor`` (the layers' blocks train), the
    optimizer is rebuilt over the blocks with the same settings, and
    ``state["specs"]`` records ``train_state_specs``. A state already laid
    out by this partitioner is left as it is."""
    if state.get("partitioner") is partitioner:
        return
    opt = state["opt_state"]
    sharded = partitioner.shard_params(detached(state["params"]))
    for layer in sharded["layers"]:
        for leaf in layer.values():
            for block in leaf.blocks.values():
                block.requires_grad_(True)
    d = opt.defaults
    state["params"] = sharded
    state["opt_state"] = torch.optim.SGD(trainable(sharded), lr=d["lr"], momentum=d["momentum"],
                                         dampening=d["dampening"], nesterov=d["nesterov"])
    state["partitioner"] = partitioner
    state["specs"] = partitioner.train_state_specs(state)


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _sharded_step(tc: TrainConfig, dtype: torch.dtype, partitioner: Any,
                  loss_fn: Callable[..., torch.Tensor] | None) -> Callable:
    """The data-parallel step over ``partitioner``'s data shards (module
    docstring). A custom ``loss_fn`` (a mean over its rows) is weighted by
    each shard's share of the rows."""
    mesh = partitioner.mesh
    positions = partitioner.data_positions()

    def step(state: dict, x: Any, y: Any) -> tuple[dict, torch.Tensor]:
        partitioner.partition_train_step(step, state)
        params, opt = state["params"], state["opt_state"]
        home = params["layers"][0]["w"].device
        x = torch.as_tensor(x).to(torch.float32)
        y = torch.as_tensor(y).to(torch.float32)
        n = len(positions)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over the "
                             f"{n}-way data axis (round it with Partitioner.round_batch)")
        dist = _distributed()
        if dist:
            import torch.distributed as tdist
        opt.zero_grad(set_to_none=True)
        parts = []
        for pos, xs, ys in zip(positions, x.chunk(n), y.chunk(n)):
            dev = mesh.devices[pos]
            local = {"norm": {k: v.gather(dev) for k, v in params["norm"].items()},
                     "layers": [{k: v.gather(dev) for k, v in layer.items()}
                                for layer in params["layers"]]}
            xs, ys = xs.to(dev), ys.to(dev)
            if loss_fn is None:
                z = mlp.logits(local, xs, dtype)
                parts.append(tuple(t.to(home) for t in
                                   weighted_bce_parts(z, ys, tc.pos_weight)))
            else:
                parts.append((loss_fn(local, xs, ys).to(home) * xs.shape[0],
                              torch.tensor(float(xs.shape[0]), device=home)))
        num = parts[0][0]
        den = parts[0][1].detach()
        for a, b in parts[1:]:
            num = num + a
            den = den + b.detach()
        if dist:
            tdist.all_reduce(den)
        loss = num / den
        loss.backward()
        if dist:
            for t in trainable(params):
                tdist.all_reduce(t.grad)
            loss = loss.detach().clone()
            tdist.all_reduce(loss)
        opt.step()
        state["step"] += 1
        return state, loss.detach()

    return step


def detached(params: dict) -> dict:
    """The same tensors without their autograd state (views; no copy); a
    sharded leaf is gathered whole on its first block's device."""
    def leaf(v: Any) -> torch.Tensor:
        return v.gather().detach() if isinstance(v, ShardedTensor) else v.detach()

    return {
        "norm": {k: leaf(v) for k, v in params["norm"].items()},
        "layers": [{k: leaf(v) for k, v in layer.items()} for layer in params["layers"]],
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
    applies whenever the positive rate is under ``balance_below`` (5%).
    With a ``mesh`` the steps are the sharded ones over it."""
    tc = tc or TrainConfig()
    dev = resolve(device)
    params = to_device(mlp.init(torch.Generator().manual_seed(seed),
                                num_features=X.shape[1], hidden=hidden), dev)
    params = mlp.set_normalizer(params, X.mean(0), X.std(0))
    state = init_state(params, tc)
    step_fn = make_train_step(tc, mesh=mesh)
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
