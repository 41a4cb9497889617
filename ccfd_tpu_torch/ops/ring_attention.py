"""Single-device attention of the seq family.

The port of ``reference_attention`` in ccfd_tpu/ops/ring_attention.py.
The sharded ring attention of that module (and Ulysses) wait for the
multi-card slice (ROADMAP A15b).
"""

from __future__ import annotations

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain full attention over (B, H, L, Dh), no mask: the scores in
    float32 at scale ``1/sqrt(Dh)``, softmax in float32, the weights cast
    to ``v``'s dtype, and P·V summed in float32 and cast to ``v``'s dtype.
    A product of two bf16 values is exact in float32, so the float32
    matmuls of the rounded operands are the reference's
    ``preferred_element_type=float32`` einsums up to summation order."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale.to(q.device)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)
