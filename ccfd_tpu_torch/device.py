"""Where the port runs: the card, unless the caller asks for the CPU.

There is no silent fallback: a caller that names no device gets ``cuda:0``,
and a machine without CUDA raises instead of quietly scoring on the host.
"""

from __future__ import annotations

import torch


def resolve(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> ``cuda:0``; ``"cpu"`` -> the CPU; anything else as given.

    Raises ``RuntimeError`` when a CUDA device is wanted and CUDA is not
    available."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev
