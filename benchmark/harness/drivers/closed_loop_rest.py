"""Mix kind ``closed_loop_rest``: ``harness/rest.py`` runs the cell (what
``serve`` runs, driven by closed-loop Seldon clients), and
``harness/judge.py::rest`` judges each reply against the reference over
the pool's rows. The reference sees the pool, the rows the requests carry.
"""
from __future__ import annotations

import contextlib

import numpy as np

from benchmark.harness import judge as _judge
from benchmark.harness import rest, spec


def run(cell, seed: int, seconds: float, trace: bool, device, state: str,
        record: bool) -> dict:
    # looked up on the module at each call, so a wrap of rest.run (traced.py)
    # takes effect
    out = rest.run(cell, seed, seconds, trace, device, state, record)
    done = np.concatenate([r["t_done"][r["status"] == 200] for r in out["requests"]])
    per_s = np.histogram(done, bins=np.arange(out["t0_mono"], out["t0_mono"] + seconds
                                              + 1e-9, 1.0))[0]
    out["notes"] = [f"replies a second in the window: {per_s.tolist()}"]
    out["traffic"] = out["pool"]
    return out


def judge(out: dict, mix: dict, ref: np.ndarray, seconds: float, limits: dict) -> dict:
    return _judge.rest(out, mix, ref, seconds, limits)


@contextlib.contextmanager
def in_place(config: dict):
    """While open, every answer the program's row scorer hands back is the
    reference's control for the rows it was handed; the launch still runs."""
    from ccfd_tpu_torch.serving.scorer import Scorer

    ref = spec.reference(config["name"])
    state = ref.load(config)
    launch, collect = Scorer._launch, Scorer._collect

    def control_launch(self, live, chunk, b):
        return launch(self, live, chunk, b), np.array(chunk, np.float32)

    def control_collect(self, pending):
        inner, rows = pending
        collect(self, inner)
        return ref.control(state, rows).astype(np.float32)

    Scorer._launch, Scorer._collect = control_launch, control_collect
    try:
        yield
    finally:
        Scorer._launch, Scorer._collect = launch, collect
