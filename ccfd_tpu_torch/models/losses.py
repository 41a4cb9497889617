"""Shared losses: the port of ccfd_tpu/models/losses.py.

One numerically stable weighted binary cross-entropy: the log-sum-exp form
``max(z, 0) - z*y + log1p(exp(-|z|))`` avoids overflow for large |z|, and
``pos_weight`` up-weights the rare fraud class. Computed in float32.
"""

from __future__ import annotations

import torch


def weighted_bce_parts(z: torch.Tensor, y: torch.Tensor,
                       pos_weight: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The loss's numerator (the weighted sum of the per-row losses) and
    denominator (the sum of the weights): a batch sharded over devices sums
    each over its shards (parallel/train.py's data-parallel step)."""
    y = y.float()
    z = z.float()
    per = torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-z.abs()))
    w = torch.where(y > 0.5, z.new_tensor(pos_weight), z.new_tensor(1.0))
    return torch.sum(per * w), torch.sum(w)


def weighted_bce_from_logits(z: torch.Tensor, y: torch.Tensor,
                             pos_weight: float = 1.0) -> torch.Tensor:
    num, den = weighted_bce_parts(z, y, pos_weight)
    return num / den
