"""Ulysses-style all-to-all sequence parallelism: the port of
ccfd_tpu/ops/ulysses.py, the second long-context strategy beside ring
attention (ops/ring_attention.py).

Two all-to-all reshards: each shard goes from holding all heads of its L/n
slice of the sequence to holding H/n heads of the FULL sequence, runs the
dense ``reference_attention`` once on them, and a reverse all-to-all
restores the sequence sharding. Communication is two all-to-alls instead
of n-1 ring rotations; each shard holds (B, H/n, L, L) scores, so it is
the choice when L is moderate and heads are plentiful (H % n == 0).

Both strategies share one contract: (B, H, L, D) in and out, the sequence
axis sharded over the named mesh axis, non-causal, exact softmax
attention. The all-to-alls are the single-controller ``shard_map``'s
(ops/shard_compat.py); the whole is torch code and differentiable through
autograd.
"""

from __future__ import annotations

import torch

from ccfd_tpu_torch.ops.ring_attention import reference_attention
from ccfd_tpu_torch.ops.shard_compat import shard_map
from ccfd_tpu_torch.parallel.sharding import P


def _ulysses_body(ax, q, k, v):
    """One shard's program. Local shapes: (B, H, L/n, D) in and out."""
    # scatter heads (dim 1), gather the sequence (dim 2) -> (B, H/n, L, D);
    # q, k and v travel in one all-to-all (stacked on a new dim 0)
    qh, kh, vh = ax.all_to_all(torch.stack([q, k, v]), split_axis=2,
                               concat_axis=3).unbind(0)
    oh = reference_attention(qh, kh, vh)
    # reverse: scatter the sequence, gather heads -> (B, H, L/n, D)
    return ax.all_to_all(oh, split_axis=2, concat_axis=1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      axis_name: str, at: dict | None = None) -> torch.Tensor:
    """Exact attention with L sharded over ``axis_name``. (B, H, L, D) in
    and out.

    Requires H and L both divisible by the axis size (the all-to-alls
    redistribute heads across shards and the sequence across the local
    dim)."""
    n = mesh.shape[axis_name]
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses_attention needs heads ({q.shape[1]}) divisible by "
            f"mesh axis {axis_name!r} size ({n}); use ring_attention for "
            f"head counts below the axis size")
    if q.shape[2] % n:
        raise ValueError(
            f"sequence length {q.shape[2]} must divide evenly over mesh "
            f"axis {axis_name!r} size ({n})")
    spec = P(None, None, axis_name, None)
    return shard_map(_ulysses_body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                     axis_name=axis_name, at=at)(q, k, v)
