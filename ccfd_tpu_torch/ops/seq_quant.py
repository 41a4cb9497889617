"""Int8 quantized sequence scorer (model ``seq_q8``).

The port of ccfd_tpu/ops/seq_quant.py, with the conventions of
``ops/quant.py``:

- **Weights**: symmetric per-output-channel int8 (``quantize_seq``), in
  numpy exactly as the reference: ``scale_o = max(max|W[:, o]| / 127,
  1e-8)``, ``wq = clip(rint(W / scale), -127, 127)``, for every dense
  weight (embed, each block's qkv/proj/mlp_in/mlp_out, head). ``wq`` and
  ``scale`` equal the reference's bit for bit.
- **Activations**: symmetric per-token dynamic int8 at run time
  (``_rowquant_tokens``): one amax per token row, ``s = max(amax / 127,
  1e-8)``, ``q = clip(round(h / s), -127, 127)``; ``torch.round`` rounds
  half to even, as ``jnp.rint``.
- **Accumulation**: the int8 x int8 products are summed as a float32
  matmul of the integer values. That sum is exact: every partial sum is an
  integer below 127 * 127 * 512 < 2^24 at the widest K (512), with TF32 on
  or off (an int8 value is exact in TF32's 10-bit mantissa). ``_int_acc``
  returns it as int32, the reference's accumulator; the dequant follows the
  op-by-op graph, ``(acc * s) * scale + b`` in float32, then the cast to
  the compute dtype. Layer norms, attention, GELU and positions run in the
  compute dtype as in ``models/seq.py``, whose trunk this reuses.

``logits``/``apply`` are readout-shaped (the serving path), with
``pos_length`` anchoring as ``seq.logits_readout``. ``register`` adds
``seq`` and ``seq_q8`` to the model registry, neither trainable, as the
reference registers them; ``serving/history.py::SeqScorer`` serves both.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.models import seq as seq_mod

Params = Mapping[str, Any]

_EPS = 1e-8


def _q_weight(w: Any) -> dict[str, np.ndarray]:
    """(in, out) f32 weight -> {"wq" int8, "scale" f32 (out,)}."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    scale = np.maximum(np.abs(w).max(axis=0) / 127.0, _EPS)
    wq = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {"wq": wq, "scale": np.asarray(scale, np.float32)}


def _host(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _q_dense_params(layer: Mapping[str, Any]) -> dict[str, np.ndarray]:
    out = _q_weight(layer["w"])
    out["b"] = _host(layer["b"])
    return out


def quantize_seq(params: Params, device: "str | torch.device | None" = None) -> dict:
    """Float seq params (models/seq.py layout) -> int8 inference params on
    ``device`` (default: where ``params`` lie). Layer norms, biases and the
    normalizer stay float32; every dense weight becomes {"wq", "scale", "b"}."""
    from ccfd_tpu_torch.params import to_device

    if device is None:
        mu = params["norm"]["mu"]
        device = mu.device if isinstance(mu, torch.Tensor) else "cpu"

    def f32(t: Mapping[str, Any]) -> dict:
        return {k: _host(v) for k, v in t.items()}

    blocks = [{
        "ln1": f32(blk["ln1"]),
        "qkv": _q_dense_params(blk["qkv"]),
        "proj": _q_dense_params(blk["proj"]),
        "ln2": f32(blk["ln2"]),
        "mlp_in": _q_dense_params(blk["mlp_in"]),
        "mlp_out": _q_dense_params(blk["mlp_out"]),
    } for blk in params["blocks"]]
    tree = {
        "norm": f32(params["norm"]),
        "embed": _q_dense_params(params["embed"]),
        "blocks": blocks,
        "head": {"ln": f32(params["head"]["ln"]), **_q_weight(params["head"]["w"]),
                 "b": _host(params["head"]["b"])},
    }
    return to_device(tree, device)


def is_quantized(params: Params) -> bool:
    """A quantized seq tree carries int8 "wq" leaves where the float tree
    has "w" (``SeqScorer.swap_params`` re-binds its apply on this)."""
    try:
        return "wq" in params["embed"] and "blocks" in params
    except (TypeError, KeyError):
        return False


def _rowquant_tokens(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: (..., D) -> ((..., D) int8, (..., 1) f32)."""
    h32 = h.float()
    amax = torch.amax(torch.abs(h32), dim=-1, keepdim=True)
    s = torch.clamp(amax / 127.0, min=_EPS)
    q = torch.clamp(torch.round(h32 / s), -127, 127).to(torch.int8)
    return q, s


def _int_acc(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (K, N) -> the exact int32 sums (..., N)."""
    return torch.matmul(q.float(), wq.float()).to(torch.int32)


def _q_dense(h: torch.Tensor, layer: Mapping[str, Any],
             compute_dtype: torch.dtype) -> torch.Tensor:
    """One quantized dense over the token axis: (..., D_in) -> (..., D_out)
    in the compute dtype."""
    q, s = _rowquant_tokens(h)
    acc = _int_acc(q, layer["wq"])
    out = acc.float() * s * layer["scale"] + layer["b"]
    return out.to(compute_dtype)


def logits(params: Params, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
           attention_fn: Callable | None = None, n_heads: int = seq_mod.N_HEADS,
           pos_length: int | None = None) -> torch.Tensor:
    """(B, L, F) -> (B,) fraud logit: ``seq.logits_readout`` with every
    dense product int8-quantized (the embed quantizes the float32
    normalized rows)."""
    h = _q_dense(seq_mod._normalized(params, x), params["embed"], compute_dtype)
    last = seq_mod.trunk(params, h, compute_dtype, _q_dense, True, pos_length,
                         attention_fn, n_heads)
    head = params["head"]
    q, s = _rowquant_tokens(last)
    z = _int_acc(q, head["wq"]).float() * s * head["scale"] + head["b"]
    return z.reshape(x.shape[0])


@torch.no_grad()
def apply(params: Params, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
          pos_length: int | None = None) -> torch.Tensor:
    """(B, L, F) -> (B,) proba_1."""
    return torch.sigmoid(logits(params, x, compute_dtype, pos_length=pos_length))


# serving entry point: logits are already readout-shaped
apply_serving = apply


def register() -> None:
    """Register ``seq`` (the float graph) and ``seq_q8`` (this variant) in
    the model registry, neither trainable and neither with a host-tier
    forward, as the reference does: both apply over (B, L, F) histories,
    so the row ``Scorer`` cannot serve them; ``SeqScorer`` does."""
    from ccfd_tpu_torch.models.registry import ModelSpec, register_model

    register_model(ModelSpec("seq", seq_mod.init, seq_mod.apply, seq_mod.logits,
                             trainable=False))

    def init_q8(generator: torch.Generator | None = None, **kw) -> dict:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return quantize_seq(seq_mod.init(generator, **kw))

    register_model(ModelSpec("seq_q8", init_q8, apply, logits, trainable=False))
