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


def require_full_f32(t: torch.Tensor, what: str) -> None:
    """Raise when a float32 matmul on ``t``'s device would run in TF32.

    TF32 keeps 10 mantissa bits of each operand: the tree family's
    selection matmul would flip split decisions, and the f32 dot of
    ``logreg`` and of the graph's ``hash_split`` router would lose about
    three digits. On the CPU there is no TF32."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{what} needs full float32 matmuls on the card: TF32 is on "
            "(torch.backends.cuda.matmul.allow_tf32 / set_float32_matmul_precision)")
