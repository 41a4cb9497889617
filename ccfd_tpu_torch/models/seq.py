"""Sequence fraud scorer: a transformer over per-customer transaction history.

The port of ccfd_tpu/models/seq.py. Each decision sees the customer's
recent history (B, L, 30) and predicts fraud for the newest transaction:
pre-norm blocks (``D_MODEL`` 128, ``N_HEADS`` 4, ``N_BLOCKS`` 2, MLP x4),
sinusoidal positions, last-token readout. The reference leaves it to XLA;
here it is torch code on the params' device.

The reference's rounding points are kept:

- every dense product rounds both operands to the compute dtype and sums in
  float32 (``mlp._dot_f32``), adds the float32 bias, then casts to the
  compute dtype; the head's logit stays float32;
- ``_layer_norm`` takes float32 statistics, ``rsqrt(var + 1e-6)`` and a
  float32 scale and bias, then casts back (``F.layer_norm``'s eps is 1e-5);
- GELU is the tanh approximation (``jax.nn.gelu``'s default), in float32;
- positions are the sin half then the cos half, concatenated, anchored as
  the last ``L`` rows of a ``pos_length`` table (``logits_readout``);
- the attention (``ops/ring_attention.reference_attention``) has no padding
  mask: a short history's zero left-pad tokens are attended, as in the
  reference.

``logits`` runs every block over all L; ``logits_readout`` (the serving
path) computes K/V over all L in the last block, and its Q, proj and MLP
for the last token only. ``init(generator, num_features)`` draws from a
seeded ``torch.Generator``: the reference's ``PRNGKey`` stream cannot be
reproduced, so the operator serves the committed ``assets/seq_init.npz``
(the reference's ``init(PRNGKey(0))`` with its normalizer), carried across
by ``params.from_jax_model_params``. ``loss_fn`` is the reference's
weighted BCE on ``logits`` (``models/losses.py``); the registry entry stays
untrainable, as the reference's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ccfd_tpu_torch.data.ccfd import NUM_FEATURES
from ccfd_tpu_torch.models.mlp import _dot_f32
from ccfd_tpu_torch.ops.ring_attention import reference_attention

Params = Mapping[str, Any]

D_MODEL = 128
N_HEADS = 4
N_BLOCKS = 2
MLP_MULT = 4

# (h, layer, compute_dtype) -> the dense layer's output in the compute dtype
Dense = Callable[[torch.Tensor, Mapping[str, Any], torch.dtype], torch.Tensor]


def init(
    generator: torch.Generator | None = None,
    num_features: int = NUM_FEATURES,
    d_model: int = D_MODEL,
    n_blocks: int = N_BLOCKS,
    device: "str | torch.device" = "cpu",
) -> dict:
    """N(0, 1/fan_in) dense weights from ``generator``, unit layer norms,
    zero biases, identity normalizer."""

    def dense(fan_in: int, shape: tuple[int, int]) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * math.sqrt(1.0 / fan_in)).to(device)

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.float32, device=device)

    def ln() -> dict:
        return {"scale": torch.ones(d_model, device=device), "bias": zeros(d_model)}

    blocks = []
    for _ in range(n_blocks):
        blocks.append({
            "ln1": ln(),
            "qkv": {"w": dense(d_model, (d_model, 3 * d_model)), "b": zeros(3 * d_model)},
            "proj": {"w": dense(d_model, (d_model, d_model)), "b": zeros(d_model)},
            "ln2": ln(),
            "mlp_in": {"w": dense(d_model, (d_model, MLP_MULT * d_model)),
                       "b": zeros(MLP_MULT * d_model)},
            "mlp_out": {"w": dense(MLP_MULT * d_model, (MLP_MULT * d_model, d_model)),
                        "b": zeros(d_model)},
        })
    return {
        "norm": {"mu": zeros(num_features), "sigma": torch.ones(num_features, device=device)},
        "embed": {"w": dense(num_features, (num_features, d_model)), "b": zeros(d_model)},
        "blocks": blocks,
        "head": {"ln": ln(), "w": dense(d_model, (d_model, 1)), "b": zeros(1)},
    }


def set_normalizer(params: Params, mean: np.ndarray, std: np.ndarray) -> dict:
    sigma = np.where(np.asarray(std) == 0.0, 1.0, np.asarray(std))
    device = params["norm"]["mu"].device
    out = dict(params)
    out["norm"] = {
        "mu": torch.as_tensor(np.asarray(mean, np.float32), device=device),
        "sigma": torch.as_tensor(np.asarray(sigma, np.float32), device=device),
    }
    return out


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6) * scale + bias).to(x.dtype)


def _positions(length: int, d_model: int,
               device: "str | torch.device" = "cpu") -> torch.Tensor:
    """(length, d_model) float32: sin of each position's angles, then cos."""
    pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d_model // 2, device=device, dtype=torch.float32)[None, :]
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=device))
    freq = torch.exp(-log_base * 2.0 * dim / d_model)
    angles = pos * freq
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def _gelu(m: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return F.gelu(m.float(), approximate="tanh").to(compute_dtype)


def dense_f(h: torch.Tensor, layer: Mapping[str, Any], compute_dtype: torch.dtype) -> torch.Tensor:
    """The float dense: operands in the compute dtype, float32 sum and bias,
    cast to the compute dtype."""
    return (_dot_f32(h.to(compute_dtype), layer["w"], compute_dtype)
            + layer["b"]).to(compute_dtype)


def columns(layer: Mapping[str, Any], sl: slice) -> dict:
    """The dense ``layer`` cut to output columns ``sl`` (every leaf: the
    weight's last axis, the bias and a per-channel scale)."""
    return {k: (v[:, sl] if v.dim() == 2 else v[sl]) for k, v in layer.items()}


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, lq, d = t.shape
    return t.reshape(b, lq, n_heads, d // n_heads).transpose(1, 2)


def _merge(a: torch.Tensor) -> torch.Tensor:
    b, h, lq, dh = a.shape
    return a.transpose(1, 2).reshape(b, lq, h * dh)


def _block(h: torch.Tensor, blk: Mapping[str, Any], compute_dtype: torch.dtype,
           dense: Dense, attn: Callable, n_heads: int, readout: bool) -> torch.Tensor:
    """One pre-norm block. ``readout``: K/V over all L; Q, proj and the MLP
    for the last token only (returns (B, 1, D))."""
    d_model = h.shape[-1]
    z = _layer_norm(h, blk["ln1"]["scale"], blk["ln1"]["bias"])
    if readout:
        kv = dense(z, columns(blk["qkv"], slice(d_model, None)), compute_dtype)
        k, v = kv.split(d_model, dim=-1)
        q = dense(z[:, -1:, :], columns(blk["qkv"], slice(0, d_model)), compute_dtype)
        h = h[:, -1:, :]
    else:
        q, k, v = dense(z, blk["qkv"], compute_dtype).split(d_model, dim=-1)
    a = _merge(attn(_heads(q, n_heads), _heads(k, n_heads), _heads(v, n_heads)))
    h = h + dense(a, blk["proj"], compute_dtype)
    z = _layer_norm(h, blk["ln2"]["scale"], blk["ln2"]["bias"])
    m = _gelu(dense(z, blk["mlp_in"], compute_dtype), compute_dtype)
    return h + dense(m, blk["mlp_out"], compute_dtype)


def trunk(params: Params, h: torch.Tensor, compute_dtype: torch.dtype, dense: Dense,
          readout: bool, pos_length: int | None = None,
          attention_fn: Callable | None = None, n_heads: int = N_HEADS) -> torch.Tensor:
    """Embedded (B, L, D) tokens -> the last token's head-normed (B, D):
    positions added, every block, the readout shape when ``readout``."""
    attn = attention_fn or reference_attention
    length, d_model = h.shape[1], h.shape[2]
    pos = _positions(pos_length or length, d_model, h.device)[-length:]
    h = h + pos.to(compute_dtype)[None]
    blocks = params["blocks"]
    for i, blk in enumerate(blocks):
        h = _block(h, blk, compute_dtype, dense, attn, n_heads,
                   readout and i == len(blocks) - 1)
    head = params["head"]
    return _layer_norm(h[:, -1, :], head["ln"]["scale"], head["ln"]["bias"])


def _normalized(params: Params, x: torch.Tensor) -> torch.Tensor:
    # the normalizer is data, not a weight: no gradient reaches it (the
    # reference's stop_gradient)
    return (x.float() - params["norm"]["mu"].detach()) / params["norm"]["sigma"].detach()


def _logits(params: Params, x: torch.Tensor, compute_dtype: torch.dtype, readout: bool,
            pos_length: int | None, attention_fn: Callable | None,
            n_heads: int) -> torch.Tensor:
    h = dense_f(_normalized(params, x).to(compute_dtype), params["embed"], compute_dtype)
    last = trunk(params, h, compute_dtype, dense_f, readout, pos_length, attention_fn, n_heads)
    z = _dot_f32(last, params["head"]["w"], compute_dtype)
    return (z + params["head"]["b"]).reshape(x.shape[0])


def logits(params: Params, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
           attention_fn: Callable | None = None, n_heads: int = N_HEADS) -> torch.Tensor:
    """(B, L, F) -> (B,) float32 fraud logit for the last transaction."""
    return _logits(params, x, compute_dtype, False, None, attention_fn, n_heads)


@torch.no_grad()
def apply(params: Params, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, L, F) -> (B,) proba_1 for the newest transaction."""
    return torch.sigmoid(logits(params, x, compute_dtype))


def logits_readout(params: Params, x: torch.Tensor,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   attention_fn: Callable | None = None, n_heads: int = N_HEADS,
                   pos_length: int | None = None) -> torch.Tensor:
    """Serving-path ``logits``: the last block computes only the readout
    token's output. ``pos_length`` anchors the positions as the last ``L``
    rows of a ``pos_length``-long table, so a short window of a full-L
    history keeps the full path's encodings; ``None`` anchors at L."""
    return _logits(params, x, compute_dtype, True, pos_length, attention_fn, n_heads)


@torch.no_grad()
def apply_serving(params: Params, x: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  pos_length: int | None = None) -> torch.Tensor:
    """Serving twin of ``apply`` on ``logits_readout``: what
    ``serving/history.py::SeqScorer`` dispatches."""
    return torch.sigmoid(logits_readout(params, x, compute_dtype, pos_length=pos_length))


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor,
            pos_weight: float = 8.0, compute_dtype: torch.dtype = torch.bfloat16,
            attention_fn: Callable | None = None) -> torch.Tensor:
    """Weighted binary cross-entropy of the newest transaction's logit
    (numerically stable), differentiable in ``params``."""
    from ccfd_tpu_torch.models.losses import weighted_bce_from_logits

    return weighted_bce_from_logits(logits(params, x, compute_dtype, attention_fn=attention_fn),
                                    y, pos_weight)
