"""Kernel B1: the fused MLP fraud scorer, as a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``ccfd_tpu/ops/fused_mlp.py::_kernel``
(entry ``fused_mlp_score``, ``pallas_call`` at its line 138). The CUDA
source is ``ops/csrc/fused_mlp.cu``; its head says what bounds the kernel
on the H100 (the tensor cores: ~2,300 operations per input byte at H=256)
and how the simple first design keeps weights and activations in shared
memory.

- ``fold_for_kernel`` folds the standardizer into W1/b1 exactly as the
  reference does, and zero-pads the feature dim to 32 (the reference pads
  to the TPU's 128-lane width; the tensor cores need a multiple of 16).
- ``pack_for_kernel`` puts the folded weights in the kernel's types on a
  device, once per params publish: W1, W2, w3 in bf16, biases in f32.
- ``fused_mlp_reference`` is the plain PyTorch version of the kernel's
  arithmetic, with the same rounding points.
- ``fused_mlp_score`` is the wrapper: the plain version for a CPU tensor,
  the kernel for a CUDA tensor (or an error: there is no fallback), with a
  launch count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.ops.launches import LaunchCounter

K_PAD = 32  # layer-1 depth: features zero-padded to two 16-deep MMA steps
MAX_HIDDEN = 256  # W2 must fit in one block's shared memory
INPUT_DTYPE = torch.bfloat16  # wire format for rows

launches = LaunchCounter("fused_mlp_bf16")


def check_hidden(hidden: int) -> None:
    if hidden % 16 or not 16 <= hidden <= MAX_HIDDEN:
        raise ValueError(
            f"fused_mlp kernel takes a hidden width that is a multiple of 16 "
            f"in [16, {MAX_HIDDEN}], not {hidden}")


def fold_for_kernel(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """MLP params (models/mlp.py layout) -> folded float32 kernel weights.

    With s = 1/sigma, (x - mu) * s @ W1 + b1 == x @ (s[:, None] * W1) +
    (b1 - (mu * s) @ W1). Computed on the host in numpy float32, as the
    reference does, so the folded weights match it to f32 rounding; W1 is
    returned (32, H), rows past the feature count exactly zero."""
    def n(a: Any) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            return a.detach().to("cpu", torch.float32).numpy()
        return np.asarray(a, np.float32)

    layers = params["layers"]
    if len(layers) != 3:
        raise ValueError("fused kernel expects a 3-layer MLP")
    mu = n(params["norm"]["mu"])
    sigma = n(params["norm"]["sigma"])
    s = 1.0 / np.where(sigma == 0.0, 1.0, sigma)
    w1 = n(layers[0]["w"])
    b1 = n(layers[0]["b"])
    if w1.shape[0] > K_PAD:
        raise ValueError(f"fused kernel takes at most {K_PAD} features, not {w1.shape[0]}")
    w1_folded = np.zeros((K_PAD, w1.shape[1]), np.float32)
    w1_folded[: w1.shape[0]] = s[:, None] * w1
    b1_folded = b1 - (mu * s) @ w1
    return {
        "w1": torch.from_numpy(w1_folded),
        "b1": torch.from_numpy(np.ascontiguousarray(b1_folded, np.float32)),
        "w2": torch.from_numpy(n(layers[1]["w"]).copy()),
        "b2": torch.from_numpy(n(layers[1]["b"]).copy()),
        "w3": torch.from_numpy(n(layers[2]["w"]).copy()),  # (H, 1)
        "b3": torch.from_numpy(n(layers[2]["b"]).copy()),
    }


def pack_for_kernel(folded: Mapping[str, torch.Tensor],
                    device: "str | torch.device") -> dict[str, torch.Tensor]:
    """Folded weights -> the kernel's operands on ``device``: w1 (32, H),
    w2 (H, H) and w3 (H,) in bf16 (round to nearest even, as the reference
    kernel's in-body casts), b1, b2 (H,) and b3 (1,) in f32. Fresh tensors,
    so a publish never aliases the caller's."""
    hidden = folded["w2"].shape[0]
    check_hidden(hidden)
    bf16, f32 = torch.bfloat16, torch.float32

    def put(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return a.to(dtype).contiguous().to(device, copy=True)

    return {
        "w1": put(folded["w1"], bf16),
        "b1": put(folded["b1"].reshape(hidden), f32),
        "w2": put(folded["w2"], bf16),
        "b2": put(folded["b2"].reshape(hidden), f32),
        "w3": put(folded["w3"].reshape(hidden), bf16),
        "b3": put(folded["b3"].reshape(1), f32),
    }


def fused_mlp_reference(kp: Mapping[str, torch.Tensor],
                        x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (B, F) bf16 rows -> (proba, logits), both
    (B,) float32. Products of bf16 values are exact in f32, so the f32
    matmuls here are the kernel's bf16 MMAs with f32 accumulation up to
    summation order; h is rounded to bf16 after each bias + relu, and the
    last layer is an f32 reduce against the bf16 w3."""
    f = x.shape[1]
    h = torch.matmul(x.float(), kp["w1"][:f].float()) + kp["b1"]
    h = torch.relu(h).to(torch.bfloat16)
    h = torch.matmul(h.float(), kp["w2"].float()) + kp["b2"]
    h = torch.relu(h).to(torch.bfloat16)
    z = (h.float() * kp["w3"].float()).sum(dim=1) + kp["b3"]
    return torch.sigmoid(z), z


@functools.cache
def _kernel_entry():
    """The bound C entry and CUDA's error-string lookup; builds the kernel
    library on first use."""
    from ccfd_tpu_torch.ops import _build

    lib = _build.load("fused_mlp")
    fn = lib.ccfd_fused_mlp_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.ccfd_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _check_cuda_args(kp: Mapping[str, torch.Tensor], x: torch.Tensor) -> int:
    if x.dtype != INPUT_DTYPE or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"x must be a contiguous (B, F) bfloat16 tensor, got {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    if not 0 < x.shape[1] <= K_PAD:
        raise ValueError(f"x has {x.shape[1]} features; the kernel takes 1..{K_PAD}")
    hidden = kp["w2"].shape[0]
    check_hidden(hidden)
    want = {
        "w1": ((K_PAD, hidden), torch.bfloat16), "b1": ((hidden,), torch.float32),
        "w2": ((hidden, hidden), torch.bfloat16), "b2": ((hidden,), torch.float32),
        "w3": ((hidden,), torch.bfloat16), "b3": ((1,), torch.float32),
    }
    for name, (shape, dtype) in want.items():
        t = kp[name]
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"kernel weight {name}: want {shape} {dtype} contiguous on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
                f"(use pack_for_kernel)")
    return hidden


def fused_mlp_score(kp: Mapping[str, torch.Tensor], x: torch.Tensor,
                    with_logits: bool = False):
    """(B, F<=32) bf16 rows -> (B,) float32 proba (and logits when
    ``with_logits``). Any B: the kernel masks the ragged last tile.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream, or raises."""
    if x.device.type == "cpu":
        proba, z = fused_mlp_reference(kp, x)
        return (proba, z) if with_logits else proba
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_score runs on cuda or cpu, not {x.device}")
    hidden = _check_cuda_args(kp, x)
    batch, features = x.shape
    proba = torch.empty(batch, dtype=torch.float32, device=x.device)
    z = torch.empty(batch, dtype=torch.float32, device=x.device) if with_logits else None
    if batch:
        fn, err = _kernel_entry()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), kp["w1"].data_ptr(), kp["b1"].data_ptr(),
                kp["w2"].data_ptr(), kp["b2"].data_ptr(), kp["w3"].data_ptr(),
                kp["b3"].data_ptr(), proba.data_ptr(),
                z.data_ptr() if z is not None else None,
                batch, features, hidden, stream)
        if rc != 0:
            raise RuntimeError(
                f"fused_mlp kernel launch failed: CUDA error {rc} "
                f"({err(rc).decode()})")
        launches.inc()
    return (proba, z) if with_logits else proba
