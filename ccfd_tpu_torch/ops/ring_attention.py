"""Attention of the seq family: the dense single-device attention and ring
attention over sequence-sharded inputs. The port of
ccfd_tpu/ops/ring_attention.py.

Ring attention computes EXACT softmax attention with the sequence
dimension sharded over a mesh axis: each shard keeps its Q slice and
rotates its K/V slice around the ring with ``ppermute``, accumulating the
softmax online (flash-attention style running max and denominator), so a
shard holds O(L/n) keys at a time whatever the length. The reference runs
the per-device body as a ``lax.scan`` inside ``shard_map``; the port runs
it through its single-controller ``shard_map`` (ops/shard_compat.py):
n-1 (accumulate, rotate) steps, then a last accumulate with no rotation
(the last rotation's output would never be read). It is torch code, as
the reference's is XLA's (no Pallas kernel lies on it), and it is
differentiable through autograd.
"""

from __future__ import annotations

import torch

from ccfd_tpu_torch.ops.shard_compat import shard_map
from ccfd_tpu_torch.parallel.sharding import P


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


def _online_block(q, k_blk, v_blk, m, l, o):
    """One blockwise-attention accumulation step (numerically stable).

    q: (B, H, Lq, D); k_blk/v_blk: (B, H, Lk, D); m: (B, H, Lq) running
    max; l: (B, H, Lq) running denominator; o: (B, H, Lq, D) running
    numerator, all float32. The scale is ``1/sqrt(D)`` rounded to q's
    dtype, as the reference's."""
    scale = (1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]))).to(q.dtype)).float()
    s = torch.matmul(q.float(), k_blk.float().transpose(-1, -2)) * scale.to(q.device)
    m_new = torch.maximum(m, s.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.matmul(p.to(v_blk.dtype).float(), v_blk.float())
    o_new = o * correction[..., None] + pv
    return m_new, l_new, o_new


def _ring_body(ax, q, k, v):
    """One shard's program: accumulate over every ring position."""
    n = ax.size
    batch, heads, lq, d = q.shape
    m = torch.full((batch, heads, lq), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((batch, heads, lq), dtype=torch.float32, device=q.device)
    o = torch.zeros((batch, heads, lq, d), dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for _ in range(n - 1):
        m, l, o = _online_block(q, k, v, m, l, o)
        # K and V travel together: one rendezvous a step
        k, v = ax.ppermute(torch.stack([k, v]), perm).unbind(0)
    m, l, o = _online_block(q, k, v, m, l, o)
    return (o / l[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str, at: dict | None = None) -> torch.Tensor:
    """Exact attention with L sharded over ``axis_name`` of ``mesh`` (the
    shards along it, the other axes at ``at``). (B, H, L, D) in and out.

    L must divide evenly by the axis size. Non-causal (transaction
    histories attend bidirectionally)."""
    spec = P(None, None, axis_name, None)
    return shard_map(_ring_body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                     axis_name=axis_name, at=at)(q, k, v)
