"""Shared inputs for the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX reference
and the port, so the two see the same numbers.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

# the port's CPU tests run small matmuls: one intra-op thread keeps them
# from oversubscribing the cores that parallel test workers share
torch.set_num_threads(1)


def mlp_tree(X: np.ndarray, hidden: int = 256, seed: int = 0,
             depth: int = 3) -> dict:
    """Seeded MLP params in the reference's pytree layout (numpy float32):
    He-scaled weights, small random biases, the normalizer fitted to ``X``
    so probabilities spread over (0, 1) instead of saturating."""
    rng = np.random.default_rng(seed)
    dims = [X.shape[1]] + [hidden] * (depth - 1) + [1]
    layers = [
        {"w": (rng.normal(size=(dims[i], dims[i + 1]))
               * np.sqrt(2.0 / dims[i])).astype(np.float32),
         "b": (0.1 * rng.normal(size=dims[i + 1])).astype(np.float32)}
        for i in range(depth)
    ]
    return {
        "norm": {"mu": X.mean(0).astype(np.float32),
                 "sigma": X.std(0).astype(np.float32)},
        "layers": layers,
    }


def assert_matches_jax(got: np.ndarray, eager: np.ndarray, jitted: np.ndarray) -> None:
    """1e-5 against the op-by-op JAX graph on every row, and against the
    jitted one on every row where the jitted graph agrees with its own
    op-by-op evaluation (at most 1% of rows do not)."""
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-5)
    same = np.abs(jitted - eager) <= 1e-6
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got[same], jitted[same], rtol=0, atol=1e-5)


def keep_port_logging():
    """A generator fixture body: restores the ``ccfd_tpu_torch`` logger's
    handlers, level and propagation after a test whose platform's tracing
    block switched on the JSON logs (``slog.configure`` stops propagation,
    which would hide later tests' warnings from ``caplog``), and the
    process-wide hooks a platform installs: the storage quarantine's
    incident recorder (``durability.set_recorder``), which would otherwise
    dump bundles into a torn-down platform's recorder from later tests.
    A fixture wider than a function runs before this one saves anything,
    so one that brings a platform up wraps it in ``port_process_state``."""
    with port_process_state():
        yield


@contextlib.contextmanager
def port_process_state():
    """What ``keep_port_logging`` restores, around any block of code."""
    from ccfd_tpu_torch.runtime import durability

    log = logging.getLogger("ccfd_tpu_torch")
    saved = (list(log.handlers), log.level, log.propagate)
    saved_recorder = durability._recorder
    try:
        yield
    finally:
        log.handlers[:] = saved[0]
        log.setLevel(saved[1])
        log.propagate = saved[2]
        durability.set_recorder(saved_recorder)


@contextlib.contextmanager
def warnings_of(*names: str):
    """The messages of the WARNING records of the loggers ``names``, caught
    at each logger: a platform's JSON logs (``slog.configure``) stop the
    package logger's propagation, which hides them from ``caplog``."""
    got: list[str] = []

    class Tap(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())

    tap = Tap(level=logging.WARNING)
    loggers = [logging.getLogger(n) for n in names]
    for lg in loggers:
        lg.addHandler(tap)
    try:
        yield got
    finally:
        for lg in loggers:
            lg.removeHandler(tap)
