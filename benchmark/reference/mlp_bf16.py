"""The plain reference of configuration ``mlp_bf16``: the checkpoint's MLP
at bf16 serving precision; its control is the same model one step below,
int8 (``mlp.quantize(bits=8)``)."""
from __future__ import annotations

import numpy as np

from benchmark.reference import mlp
from benchmark.harness.spec import ROOT


def load(config: dict) -> dict:
    return mlp.load(str(ROOT / config["params"]))


def reference(state: dict, rows: np.ndarray) -> np.ndarray:
    return mlp.blocks(lambda x: mlp.forward_bf16(state, x), rows)


def control(state: dict, rows: np.ndarray) -> np.ndarray:
    q = mlp.quantize(state, bits=8)
    return mlp.blocks(lambda x: mlp.forward_int(q, x), rows)
