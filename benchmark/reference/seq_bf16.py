"""The plain reference of configuration ``seq_bf16``: the committed seq
params at bf16 serving precision over each decision's history, rebuilt from
the records in produce order; its control is the same model one step below,
int8 (``seq.Forward(bits=8)``). On the card when there is one."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.spec import ROOT
from benchmark.reference import seq


def load(config: dict, served: dict | None = None) -> dict:
    """The configuration's params file; with ``served`` (host copies of the
    params the program served) each leaf must be the file's, bit for bit."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    p = seq.load(str(ROOT / config["params"]), device)
    if served is not None:
        gap = seq.same_params(p, served)
        if gap != 0.0:
            raise ValueError(f"the program served other params than {config['params']} "
                             f"(widest gap {gap!r})")
    return {"params": p, "heads": int(config["num_attention_heads"]),
            "length": int(config["cr"]["scorer"]["history_length"])}


def reference(state: dict, traffic: dict) -> np.ndarray:
    return seq.score_traffic(seq.Forward(state["params"], state["heads"]), traffic,
                             state["length"])


def control(state: dict, traffic: dict) -> np.ndarray:
    return seq.score_traffic(seq.Forward(state["params"], state["heads"], bits=8), traffic,
                             state["length"])


def control_histories(state: dict, hist: np.ndarray) -> np.ndarray:
    """The control over histories already assembled (the control put in the
    program's place)."""
    return seq.score(seq.Forward(state["params"], state["heads"], bits=8), hist)
