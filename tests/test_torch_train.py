"""Port's training (models/losses.py, mlp.loss_fn, parallel/train.py) vs the
JAX reference (ccfd_tpu/models/losses.py, ccfd_tpu/parallel/train.py).

The same seeded numpy inputs and the same initial params (the reference's
``PRNGKey`` init carried across as numpy) go through both. The rounding
points are the same (bf16 operands, f32 products and sums, the gradients
of bf16 operands rounded to bf16), only the matmuls' summation order
differs. Bars: the loss 1e-6; in float32 every gradient and every param
within 1e-5 of the leaf's largest magnitude; in bf16 the gradients within
2^-8 of the leaf's largest magnitude (a gradient element is rounded to
bf16, and the two summation orders can round it on either side of a bf16
boundary: one bf16 ulp, at most 2^-8 of the element), and
params after training within 1e-5 absolute (each step moves a weight by
the learning rate 1e-3 times its momentum trace, so a 2^-8 gradient
difference moves it ~1e-6 a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccfd_tpu.data.ccfd import synthetic_dataset
from ccfd_tpu.models import losses as jax_losses
from ccfd_tpu.models import mlp as jax_mlp
from ccfd_tpu.parallel import train as jax_train
from ccfd_tpu_torch.models import losses, mlp
from ccfd_tpu_torch.parallel import train
from ccfd_tpu_torch.params import from_jax_params, to_numpy
from tests.torch_helpers import mlp_tree

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
PARAM_TOL = {"float32": 1e-5, "bfloat16": 1e-5}


@pytest.fixture(scope="module")
def data():
    ds = synthetic_dataset(n=256, fraud_rate=0.3, seed=11)
    return ds.X, ds.y.astype(np.float32)


def _leaves(tree: dict) -> dict:
    """{"layers/0/w": ..., "norm/mu": ...} of numpy arrays."""
    tree = to_numpy(tree) if any(isinstance(v, torch.Tensor) for v in tree["norm"].values()) \
        else jax.tree.map(np.asarray, tree)
    out = {f"norm/{k}": np.asarray(v) for k, v in tree["norm"].items()}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers/{i}/{k}": np.asarray(v) for k, v in layer.items()})
    return out


def _close(got: dict, want: dict, rel: float, what: str) -> None:
    """Every leaf within ``rel`` of that leaf's largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= rel * scale, f"{what} {k}: |d|={err:.3e} > {rel} x {scale:.3e}"


def test_weighted_bce_matches_reference():
    rng = np.random.default_rng(0)
    z = (rng.normal(size=512) * 6).astype(np.float32)
    z[:4] = [80.0, -80.0, 0.0, 1e-3]  # overflow guards and the kink
    y = (rng.random(512) < 0.2).astype(np.float32)
    for pw in (1.0, 8.0):
        want = float(jax_losses.weighted_bce_from_logits(jnp.asarray(z), jnp.asarray(y), pw))
        got = losses.weighted_bce_from_logits(torch.from_numpy(z), torch.from_numpy(y), pw)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradient_match_reference(data, dtype):
    X, y = data
    tree = mlp_tree(X, hidden=64, seed=4)
    tdt, jdt = DTYPES[dtype]
    want_loss, grads = jax.value_and_grad(jax_mlp.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(X), jnp.asarray(y), 8.0, jdt)
    params = from_jax_params(tree)
    for layer in params["layers"]:
        for t in layer.values():
            t.requires_grad_(True)
    loss = mlp.loss_fn(params, torch.from_numpy(X), torch.from_numpy(y), 8.0, tdt)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-6 * max(1.0, float(want_loss))
    got_g = {f"layers/{i}/{k}": t.grad.numpy() for i, layer in enumerate(params["layers"])
             for k, t in layer.items()}
    want_g = {k: v for k, v in _leaves(grads).items() if k.startswith("layers/")}
    _close(got_g, want_g, GRAD_TOL[dtype], f"{dtype} gradient")
    # the normalizer is data: no gradient on either side
    assert all(t.grad is None for t in params["norm"].values())
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(grads["norm"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference_over_five_steps(data, dtype):
    """optax.sgd(lr, momentum) against torch.optim.SGD: the same params and
    losses after each of 5 steps from one init over the same batches."""
    X, y = data
    tree = mlp_tree(X, hidden=64, seed=5)
    tc_j = jax_train.TrainConfig(compute_dtype=dtype, learning_rate=0.05)
    tc_t = train.TrainConfig(compute_dtype=dtype, learning_rate=0.05)
    state_j = jax_train.init_state(jax.tree.map(jnp.asarray, tree), tc_j)
    step_j = jax_train.make_train_step(tc_j)
    state_t = train.init_state(from_jax_params(tree), tc_t)
    step_t = train.make_train_step(tc_t)
    norm0 = {k: v.clone() for k, v in state_t["params"]["norm"].items()}
    rng = np.random.default_rng(9)
    for i in range(5):
        idx = rng.integers(0, len(y), size=128)
        state_j, loss_j = step_j(state_j, jnp.asarray(X[idx]), jnp.asarray(y[idx]))
        state_t, loss_t = step_t(state_t, torch.from_numpy(X[idx]), torch.from_numpy(y[idx]))
        assert loss_t.shape == () and loss_t.requires_grad is False
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * max(1.0, float(loss_j)), i
        got = _leaves(train.detached(state_t["params"]))
        want = _leaves(state_j["params"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL[dtype],
                                       err_msg=f"step {i} {k}")
    assert state_t["step"] == 5 and int(state_j["step"]) == 5
    # the normalizer got no update
    for k, v in norm0.items():
        assert torch.equal(state_t["params"]["norm"][k], v)
    # the weights did move
    assert not np.allclose(_leaves(train.detached(state_t["params"]))["layers/0/w"],
                           tree["layers"][0]["w"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fraud_rate", [0.01, 0.3], ids=["balanced", "plain"])
def test_fit_mlp_matches_reference(monkeypatch, fraud_rate, dtype):
    """fit_mlp with the reference's PRNGKey init carried in: the same batches
    (class-balanced below a 5% base rate), the same updates, and the same
    prior-corrected last bias."""
    ds = synthetic_dataset(n=1024, fraud_rate=fraud_rate, seed=13)
    pos = int(ds.y.sum())
    assert (pos / ds.n < 0.05) == (fraud_rate < 0.05) and pos >= 2

    def jax_init(generator, num_features, hidden, **kw):
        return from_jax_params(jax_mlp.init(jax.random.PRNGKey(3), num_features, hidden))

    monkeypatch.setattr(mlp, "init", jax_init)
    kw = dict(hidden=32, steps=10, batch=128, seed=3)
    want = jax_train.fit_mlp(ds.X, ds.y, tc=jax_train.TrainConfig(compute_dtype=dtype), **kw)
    got = train.fit_mlp(ds.X, ds.y, tc=train.TrainConfig(compute_dtype=dtype),
                        device="cpu", **kw)
    got_l, want_l = _leaves(got), _leaves(want)
    for k in want_l:
        np.testing.assert_allclose(got_l[k], want_l[k], rtol=0, atol=PARAM_TOL[dtype],
                                   err_msg=k)
    # the balanced path shifted the last bias by its log-odds offset
    b_init = 0.0
    shift = float(got_l["layers/2/b"][0]) - b_init
    assert (shift < -1.0) == (fraud_rate < 0.05)
    assert all(t.device.type == "cpu" and not t.requires_grad
               for t in got["norm"].values())


def test_init_state_owns_its_tensors():
    params = mlp.init(torch.Generator().manual_seed(0), hidden=32)
    state = train.init_state(params, train.TrainConfig())
    for a, b in zip(train.trainable(params), train.trainable(state["params"])):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    assert all(t.requires_grad for t in train.trainable(state["params"]))
    assert not any(t.requires_grad for t in state["params"]["norm"].values())
    step = train.make_train_step(train.TrainConfig())
    x = torch.randn(16, 30, generator=torch.Generator().manual_seed(1))
    step(state, x, (x[:, 0] > 0).float())
    # the caller's tensors are untouched by the in-place update
    assert torch.equal(params["layers"][0]["w"],
                       mlp.init(torch.Generator().manual_seed(0), hidden=32)["layers"][0]["w"])


def test_init_is_drawn_on_the_cpu_from_the_seed():
    """The port's fit_mlp init: the same weights from the same seed, on any
    device they are then moved to (deviation from the reference's PRNGKey)."""
    a = mlp.init(torch.Generator().manual_seed(7), hidden=32)
    b = mlp.init(torch.Generator().manual_seed(7), hidden=32)
    for x, z in zip(train.trainable(a), train.trainable(b)):
        assert torch.equal(x, z)


def test_sharding_is_refused_by_name():
    """Named for the refusal before A15b: the sharded step is served since.
    ``mesh=`` (the megatron layout over the model axis) and
    ``partitioner=`` (data parallel) each step on logical CPU shards within
    the reduction-order bar of the single-device step, and ``fit_mlp`` takes
    a mesh."""
    from ccfd_tpu_torch.parallel.mesh import make_mesh, make_named_mesh
    from ccfd_tpu_torch.parallel.partition import DataParallelPartitioner, gather_params

    cpu = [torch.device("cpu")] * 4
    tc = train.TrainConfig(compute_dtype="float32", learning_rate=0.05)
    ds = synthetic_dataset(n=64, fraud_rate=0.3, seed=1)
    init = mlp.init(torch.Generator().manual_seed(3), hidden=32)
    y = ds.y.astype(np.float32)

    def run(**kw):
        state = train.init_state(init, tc)
        step = train.make_train_step(tc, **kw)
        for _ in range(3):
            state, loss = step(state, ds.X, y)
        return float(loss), gather_params(state["params"])

    loss1, p1 = run()
    for kw in ({"mesh": make_mesh(cpu, model_parallel=2)},
               {"partitioner": DataParallelPartitioner(make_named_mesh(cpu))}):
        loss, p = run(**kw)
        np.testing.assert_allclose(loss, loss1, rtol=5e-4, atol=1e-6)
        for a, b in zip(p["layers"], p1["layers"]):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k], b[k], rtol=5e-4, atol=5e-5)
    fitted = train.fit_mlp(ds.X, ds.y, hidden=32, steps=1, mesh=make_mesh(cpu), device="cpu")
    assert tuple(fitted["layers"][0]["w"].shape) == (30, 32)


def test_fit_mlp_runs_on_the_card_unless_asked(monkeypatch):
    """No silent fallback: without CUDA, the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = synthetic_dataset(n=64, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.fit_mlp(ds.X, ds.y, steps=1)
