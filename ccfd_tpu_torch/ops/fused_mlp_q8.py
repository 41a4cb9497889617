"""Kernels B2 and B3: the fused int8 MLP fraud scorer, as CUDA kernels for
Hopper.

Replaces the Pallas TPU kernels of ``ccfd_tpu/ops/fused_mlp_q8.py``:

- **B2** ``_kernel`` (entry ``fused_mlp_q8_score``): f32 rows ->
  ``(x - mu) / sigma`` -> per-row int8 requantization before each layer ->
  int8 x int8 -> int32 layers 1 and 2 with f32 dequant, bias, relu ->
  layer 3 as an integer-exact sum -> sigmoid. The f32 wire
  (``CCFD_Q8_WIRE=f32``).
- **B3** ``_kernel_preq`` (entry ``fused_mlp_q8_score_preq``): B2 from the
  layer-1 int8 matmul on, for rows the host already normalized and
  quantized (``prequantize_rows_numpy``): 30 int8 bytes and one f32 scale
  per row on the wire instead of 120 bytes. The default int8 wire.

The CUDA source is ``ops/csrc/fused_mlp_q8.cu``; its head says what bounds
the kernels and how the first design works. This module holds what
surrounds them:

- ``fold_for_kernel`` checks a quantized tree against the reference's
  limits and the kernels' own, and lays the weights out for the kernels
  (W transposed to output-major, layer 1's depth zero-padded to 32);
- ``pack_for_kernel`` puts them on a device, once per params publish;
- ``prequantize_rows_numpy`` is B3's host half, bit for bit the
  reference's;
- ``fused_mlp_q8_reference`` and ``fused_mlp_q8_preq_reference`` are the
  plain PyTorch versions of the kernels' arithmetic, each returning
  ``(proba, logits)``;
- ``fused_mlp_q8_score`` and ``fused_mlp_q8_score_preq`` are the wrappers:
  the plain version for a CPU tensor, the kernel for a CUDA tensor (or an
  error: there is no fallback), each with its launch count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.ops.launches import LaunchCounter
from ccfd_tpu_torch.ops.quant import EPS, host_array, int_matmul, quantize_rows

K_PAD = 32  # layer-1 depth: features zero-padded to one 32-deep int8 MMA step
TILE_ROWS = 64  # rows per block
SMEM_LIMIT = 232_448  # dynamic shared memory one block may have on Hopper
# the integer-exact f32 layer-3 sum of the reference holds while
# hidden * 127^2 < 2^24 (fused_mlp_q8.py:86-98 of the reference)
MAX_EXACT_HIDDEN = 1040
INPUT_DTYPE = torch.float32  # the f32 wire's rows

launches = LaunchCounter("fused_mlp_q8")  # B2
launches_preq = LaunchCounter("fused_mlp_q8_preq")  # B3


def smem_bytes(hidden: int) -> int:
    """Dynamic shared memory of one block at ``hidden``: the same layout as
    ``smem_layout`` in the CUDA source, each part aligned to 128 bytes."""
    ldh, ldf, ld1 = hidden + 16, hidden + 8, K_PAD + 16
    parts = (hidden * ld1, hidden * ldh, TILE_ROWS * ldh, TILE_ROWS * ld1,
             4 * TILE_ROWS * ldf, hidden, 4 * 4 * hidden, 4 * TILE_ROWS,
             4 * TILE_ROWS)
    return sum(-(-p // 128) * 128 for p in parts)


# the widest hidden layer whose block fits in shared memory (288 on Hopper)
MAX_HIDDEN = max(h for h in range(32, 2048, 32) if smem_bytes(h) <= SMEM_LIMIT)


def check_shapes(features: int, hidden: int) -> None:
    """Raise ``ValueError`` for a model the kernels do not take."""
    if not 0 < features <= K_PAD:
        raise ValueError(
            f"fused q8 kernel takes at most {K_PAD} features, not {features}")
    if hidden % 32 or not 32 <= hidden <= MAX_HIDDEN:
        raise ValueError(
            f"fused q8 kernel takes a hidden width that is a multiple of 32 "
            f"in [32, {MAX_HIDDEN}] (what one block's shared memory holds), "
            f"not {hidden}")


def fold_for_kernel(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Quantized MLP params (ops/quant.py layout) -> the kernels' weights
    as CPU tensors.

    Refuses, each with a ``ValueError`` naming the limit: a tree that is
    not quantized, a depth other than 3, a last layer wider than 1,040
    inputs (the reference's bound for its integer-exact layer-3 sum), more
    than 32 features, and a hidden width the kernels do not take.

    The normalizer is not folded into the int8 weights (per-input scaling
    would break the per-output-channel grid): mu and sigma ride along and
    the kernel divides by sigma, as the served graph does. Layout:
    ``w1t`` (H, 32) and ``w2t`` (H, H) int8 are W transposed (output-major,
    the tensor cores' "col" operand), ``w1t``'s columns past the feature
    count zero; ``w3`` (H,) int8; ``s*``/``b*`` float32."""
    n = host_array
    layers = params["layers"]
    if len(layers) != 3 or any("wq" not in layer for layer in layers):
        raise ValueError("fused q8 kernel expects a 3-layer quantized MLP "
                         "(ops/quant.py quantize_mlp)")
    hidden_last = int(n(layers[2]["wq"], np.int8).shape[0])
    if hidden_last > MAX_EXACT_HIDDEN:
        raise ValueError(
            f"fused q8 kernel: last-layer input width {hidden_last} > "
            f"{MAX_EXACT_HIDDEN} breaks the integer-exact layer-3 sum (2^24 bound)")
    w1 = n(layers[0]["wq"], np.int8)
    w2 = n(layers[1]["wq"], np.int8)
    w3 = n(layers[2]["wq"], np.int8)
    mu = n(params["norm"]["mu"])
    sigma = n(params["norm"]["sigma"])
    features, hidden = w1.shape
    check_shapes(features, hidden)
    if (mu.shape != (features,) or sigma.shape != (features,)
            or w2.shape != (hidden, hidden) or w3.shape != (hidden, 1)):
        raise ValueError(
            f"fused q8 kernel: inconsistent shapes mu {mu.shape}, sigma "
            f"{sigma.shape}, w1 {w1.shape}, w2 {w2.shape}, w3 {w3.shape}")
    w1t = np.zeros((hidden, K_PAD), np.int8)
    w1t[:, :features] = w1.T
    vec = {f"{k}{i + 1}": torch.from_numpy(n(layers[i][name]).reshape(-1).copy())
           for i in range(3) for k, name in (("s", "scale"), ("b", "b"))}
    return {
        "mu": torch.from_numpy(mu.copy()),
        "sigma": torch.from_numpy(sigma.copy()),
        "w1t": torch.from_numpy(w1t),
        "w2t": torch.from_numpy(np.ascontiguousarray(w2.T)),
        "w3": torch.from_numpy(w3.reshape(hidden).copy()),
        **vec,
    }


def _want(features: int, hidden: int) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    f32, i8 = torch.float32, torch.int8
    return {
        "mu": ((features,), f32), "sigma": ((features,), f32),
        "w1t": ((hidden, K_PAD), i8), "s1": ((hidden,), f32), "b1": ((hidden,), f32),
        "w2t": ((hidden, hidden), i8), "s2": ((hidden,), f32), "b2": ((hidden,), f32),
        "w3": ((hidden,), i8), "s3": ((1,), f32), "b3": ((1,), f32),
    }


def pack_for_kernel(folded: Mapping[str, torch.Tensor],
                    device: "str | torch.device") -> dict[str, torch.Tensor]:
    """Folded weights -> the kernels' operands on ``device``: fresh
    contiguous tensors, so a publish never aliases the caller's."""
    features, hidden = folded["mu"].shape[0], folded["w2t"].shape[0]
    check_shapes(features, hidden)
    return {k: folded[k].to(dtype).contiguous().to(device, copy=True)
            for k, (_shape, dtype) in _want(features, hidden).items()}


def prequantize_rows_numpy(kernel_params: Mapping[str, Any],
                           x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """B3's host half: normalize and quantize each row, as the kernels'
    first requantization does. (B, F) f32 rows -> ((B, F) int8, (B, 1) f32
    scales), bit for bit the reference's ``prequantize_rows_numpy``: a true
    division by the raw sigma (a multiply by its reciprocal differs in the
    last ulp and can flip a quantization step)."""
    mu = np.asarray(kernel_params["mu"], np.float32)
    sigma = np.asarray(kernel_params["sigma"], np.float32)
    x = np.asarray(x, np.float32)
    n_feat = x.shape[1]
    h = (x - mu[:n_feat]) / sigma[:n_feat]
    amax = np.max(np.abs(h), axis=1, keepdims=True)
    s = np.maximum(amax / 127.0, EPS).astype(np.float32)
    q = np.clip(np.rint(h / s), -127, 127).astype(np.int8)
    return q, s


def _from_layer1(kp: Mapping[str, torch.Tensor], q: torch.Tensor,
                 sx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' arithmetic from the layer-1 matmul on: (B, F) int8
    rows and their (B,) scales -> (proba, logits)."""
    f = q.shape[1]
    acc = int_matmul(q, kp["w1t"][:, :f].t())
    h = torch.relu(acc * sx[:, None] * kp["s1"] + kp["b1"])
    q, sx = quantize_rows(h)
    acc = int_matmul(q, kp["w2t"].t())
    h = torch.relu(acc * sx[:, None] * kp["s2"] + kp["b2"])
    q, sx = quantize_rows(h)
    z = int_matmul(q, kp["w3"][:, None]).reshape(-1) * sx * kp["s3"] + kp["b3"]
    return torch.sigmoid(z), z


def fused_mlp_q8_reference(kp: Mapping[str, torch.Tensor],
                           x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B2's plain PyTorch version: (B, F) f32 rows -> (proba, logits), both
    (B,) float32, with the kernel's rounding points (the served graph's)."""
    f = x.shape[1]
    h = (x.float() - kp["mu"][:f]) / kp["sigma"][:f]
    q, sx = quantize_rows(h)
    return _from_layer1(kp, q, sx)


def fused_mlp_q8_preq_reference(kp: Mapping[str, torch.Tensor], q: torch.Tensor,
                                s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B3's plain PyTorch version: (B, F) int8 rows and (B, 1) f32 scales
    -> (proba, logits)."""
    return _from_layer1(kp, q, s.reshape(-1).float())


@functools.cache
def _kernel_entries():
    """The two bound C entries and CUDA's error-string lookup; builds the
    kernel library on first use."""
    from ccfd_tpu_torch.ops import _build

    lib = _build.load("fused_mlp_q8")
    p, i = ctypes.c_void_p, ctypes.c_int
    full = lib.ccfd_fused_mlp_q8
    full.argtypes = [p] * 14 + [i] * 3 + [p]
    full.restype = i
    preq = lib.ccfd_fused_mlp_q8_preq
    preq.argtypes = [p] * 13 + [i] * 3 + [p]
    preq.restype = i
    err = lib.ccfd_q8_cuda_error_string
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    return full, preq, err


def _check_weights(kp: Mapping[str, torch.Tensor], device: torch.device) -> tuple[int, int]:
    features, hidden = kp["mu"].shape[0], kp["w2t"].shape[0]
    check_shapes(features, hidden)
    for name, (shape, dtype) in _want(features, hidden).items():
        t = kp[name]
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"kernel weight {name}: want {shape} {dtype} contiguous on "
                f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
                f"(use pack_for_kernel)")
    return features, hidden


def _check_rows(t: torch.Tensor, what: str, dtype: torch.dtype, width: int) -> None:
    if (t.dtype != dtype or t.dim() != 2 or t.shape[1] != width
            or not t.is_contiguous()):
        raise ValueError(
            f"{what} must be a contiguous (B, {width}) {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _outputs(batch: int, device: torch.device, with_logits: bool):
    proba = torch.empty(batch, dtype=torch.float32, device=device)
    z = torch.empty(batch, dtype=torch.float32, device=device) if with_logits else None
    return proba, z


def _raise_on(rc: int, err, which: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{which} kernel launch failed: CUDA error {rc} ({err(rc).decode()})")


def fused_mlp_q8_score(kp: Mapping[str, torch.Tensor], x: torch.Tensor,
                       with_logits: bool = False):
    """B2: (B, F<=32) f32 rows -> (B,) float32 proba (and logits when
    ``with_logits``). Any B: the kernel masks the ragged last tile.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream, or raises."""
    if x.device.type == "cpu":
        proba, z = fused_mlp_q8_reference(kp, x)
        return (proba, z) if with_logits else proba
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_q8_score runs on cuda or cpu, not {x.device}")
    features, hidden = _check_weights(kp, x.device)
    _check_rows(x, "x", INPUT_DTYPE, features)
    batch = x.shape[0]
    proba, z = _outputs(batch, x.device, with_logits)
    if batch:
        full, _preq, err = _kernel_entries()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = full(x.data_ptr(), kp["mu"].data_ptr(), kp["sigma"].data_ptr(),
                  kp["w1t"].data_ptr(), kp["s1"].data_ptr(), kp["b1"].data_ptr(),
                  kp["w2t"].data_ptr(), kp["s2"].data_ptr(), kp["b2"].data_ptr(),
                  kp["w3"].data_ptr(), kp["s3"].data_ptr(), kp["b3"].data_ptr(),
                  proba.data_ptr(), z.data_ptr() if z is not None else None,
                  batch, features, hidden, stream)
        _raise_on(rc, err, "fused_mlp_q8")
        launches.inc()
    return (proba, z) if with_logits else proba


def fused_mlp_q8_score_preq(kp: Mapping[str, torch.Tensor], q: torch.Tensor,
                            s: torch.Tensor, with_logits: bool = False):
    """B3: (B, F<=32) int8 rows and their (B, 1) f32 scales (from
    ``prequantize_rows_numpy``) -> (B,) float32 proba (and logits).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream, or raises."""
    if q.device.type == "cpu" and s.device.type == "cpu":
        proba, z = fused_mlp_q8_preq_reference(kp, q, s)
        return (proba, z) if with_logits else proba
    if q.device.type != "cuda" or s.device != q.device:
        raise ValueError(
            f"fused_mlp_q8_score_preq runs on cuda or cpu, with q and s on one "
            f"device, not {q.device} and {s.device}")
    features, hidden = _check_weights(kp, q.device)
    _check_rows(q, "q", torch.int8, features)
    _check_rows(s, "s", torch.float32, 1)
    batch = q.shape[0]
    if s.shape[0] != batch:
        raise ValueError(f"q has {batch} rows but s has {s.shape[0]}")
    proba, z = _outputs(batch, q.device, with_logits)
    if batch:
        _full, preq, err = _kernel_entries()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = preq(q.data_ptr(), s.data_ptr(),
                  kp["w1t"].data_ptr(), kp["s1"].data_ptr(), kp["b1"].data_ptr(),
                  kp["w2t"].data_ptr(), kp["s2"].data_ptr(), kp["b2"].data_ptr(),
                  kp["w3"].data_ptr(), kp["s3"].data_ptr(), kp["b3"].data_ptr(),
                  proba.data_ptr(), z.data_ptr() if z is not None else None,
                  batch, features, hidden, stream)
        _raise_on(rc, err, "fused_mlp_q8_preq")
        launches_preq.inc()
    return (proba, z) if with_logits else proba
