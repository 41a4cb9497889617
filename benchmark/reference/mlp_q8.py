"""The plain reference of configuration ``mlp_q8``: the checkpoint quantized
to int8 again here and run at its rounding points; its control is the same
model one step below, int4 (``mlp.quantize(bits=4)``)."""
from __future__ import annotations

import numpy as np

from benchmark.reference import mlp
from benchmark.harness.spec import ROOT


def load(config: dict) -> dict:
    return mlp.load(str(ROOT / config["params"]))


def reference(state: dict, rows: np.ndarray) -> np.ndarray:
    q = mlp.quantize(state, bits=8)
    return mlp.blocks(lambda x: mlp.forward_int(q, x), rows)


def control(state: dict, rows: np.ndarray) -> np.ndarray:
    q = mlp.quantize(state, bits=4)
    return mlp.blocks(lambda x: mlp.forward_int(q, x), rows)
