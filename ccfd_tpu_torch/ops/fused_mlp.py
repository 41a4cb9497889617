"""Kernel B1: the fused MLP fraud scorer, as a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``ccfd_tpu/ops/fused_mlp.py::_kernel``
(entry ``fused_mlp_score``, ``pallas_call`` at its line 138). The CUDA
source is ``ops/csrc/fused_mlp.cu``; its head says what bounds the kernel
on the H100 (the tensor cores: ~2,300 operations per input byte at H=256)
and how the design streams host-packed weight chunks through a ring of
shared-memory stages into ``wgmma``. Wider than H=1,024 (the "wide"
layout) layer 1 writes h1 to a per-block scratch in global memory that the
wrapper allocates, and layer 2 streams it back through the ring.

- ``fold_for_kernel`` folds the standardizer into W1/b1 exactly as the
  reference does, and zero-pads the feature dim to a multiple of 16 (the
  bf16 MMA depth; the reference pads to the TPU's 128-lane width).
- ``pack_for_kernel`` puts the folded weights in the kernel's types on a
  device, once per params publish: the plain version's W1, W2, w3 in bf16
  and biases in f32, and the kernel's own operands: the weight stream
  (``pack_stream``, W1^T and W2^T in wgmma's swizzled shared-memory layout)
  and the epilogue vectors b1, b2, w3 zero-padded to the kernel's width.
- ``plan`` mirrors the CUDA source's shared-memory layout.
- ``path_for`` chooses between the persistent grid and the cluster launch
  (small batches at H <= 512: one cluster of ``hp / 64`` CTAs a 64-row
  tile); the CUDA entry launches what it is told.
- ``fused_mlp_reference`` is the plain PyTorch version of the kernel's
  arithmetic, with the same rounding points.
- ``fused_mlp_score`` is the wrapper: the plain version for a CPU tensor,
  the kernel for a CUDA tensor on ``path_for``'s launch (or an error: there
  is no fallback). ``launch`` runs the kernel on a named launch, and counts
  it (``launches``; ``launches_cluster`` those on the cluster path).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.ops.launches import LaunchCounter

MMA_K = 16  # bf16 MMA depth: fold pads the feature dim to a multiple of it
MAX_FEATURES = 128  # the reference's lane bound (ccfd_tpu/ops/fused_mlp.py LANE)
MAX_RESIDENT_H1 = 1024  # widest H whose 64-row h1 tile stays in shared memory
INPUT_DTYPE = torch.bfloat16  # wire format for rows
# the CUDA source's geometry (ops/csrc/fused_mlp.cu)
TILE_ROWS = 64
K_BLOCK = 64  # bf16 inputs in one 128-byte swizzle row
PART = 256  # output columns of one weight chunk
HALF = 128  # output columns one consumer warpgroup owns in a part
STAGE_BYTES = PART * 128
ATOM_BYTES = TILE_ROWS * 128  # a 64-row x 64-input block of an A operand
MAX_STAGES = 8
SMEM_LIMIT = 232_448
# the cluster path (the CUDA source's kGroup, kClusterMaxCtas): a cluster
# of hp / 64 CTAs, at most the portable 8; path_for takes it for batches up
# to the crossover measured on the H100 (tools/torch_q8_crossover.py
# --kernel b1; the figures are in the CUDA source's head)
GROUP = 64
CLUSTER_MAX_CTAS = 8
CLUSTER_MAX_BATCH = 1024
PATHS = ("persistent", "cluster")  # the CUDA entry's launch argument, by index

launches = LaunchCounter("fused_mlp_bf16")  # either path
launches_cluster = LaunchCounter("fused_mlp_bf16.cluster")  # the cluster path's


def check_shapes(features: int, hidden: int) -> None:
    """Raise ``ValueError`` for a model the kernel does not take: more
    features than the reference's 128-lane bound (any hidden width goes)."""
    if not 0 < features <= MAX_FEATURES:
        raise ValueError(
            f"fused kernel takes at most {MAX_FEATURES} features, not {features}")
    if hidden <= 0:
        raise ValueError(f"hidden width must be positive, not {hidden}")


@functools.cache
def plan(features: int, hidden: int) -> dict[str, int]:
    """The kernel's padded widths and shared-memory layout, as
    ``make_layout`` in the CUDA source computes them: F padded to a
    multiple of 64 (``k1p``), H to a multiple of 128 (``hp``); the chunks a
    tile streams, the ring's stages (``resident`` when every chunk has its
    own), ``wide`` when h1 goes through global scratch (H > 1,024; a stage
    then also holds one 8 KB block of h1), and the dynamic shared memory of
    one block."""
    k1p = -(-features // K_BLOCK) * K_BLOCK
    hp = -(-hidden // HALF) * HALF
    parts = -(-hp // PART)
    chunks = parts * (k1p // K_BLOCK + hp // K_BLOCK)
    wide = hidden > MAX_RESIDENT_H1
    sbytes = STAGE_BYTES + (ATOM_BYTES if wide else 0)
    fixed = ((0 if wide else TILE_ROWS * hp * 2) + TILE_ROWS * k1p * 2
             + -(-(TILE_ROWS * features * 2) // 128) * 128
             + 4 * TILE_ROWS * 2 * (MAX_RESIDENT_H1 // PART) + 256)
    stages = min(chunks, MAX_STAGES, max(0, (SMEM_LIMIT - fixed) // sbytes))
    return {"k1p": k1p, "hp": hp, "chunks": chunks, "stages": stages,
            "resident": int(stages == chunks), "wide": int(wide),
            "smem": fixed + stages * sbytes}


def path_for(batch: int, features: int, hidden: int) -> str:
    """The launch ``fused_mlp_score`` hands B1's entry at this shape, the
    one place it is chosen: ``"cluster"`` (a cluster of ``hp / 64`` CTAs a
    64-row tile) for ``0 < batch <= CLUSTER_MAX_BATCH`` where ``hp / 64 <=
    CLUSTER_MAX_CTAS``, else ``"persistent"``. Raises ``ValueError`` for a
    shape the kernel does not take."""
    check_shapes(features, hidden)
    if 0 < batch <= CLUSTER_MAX_BATCH and plan(features, hidden)["hp"] // GROUP <= CLUSTER_MAX_CTAS:
        return "cluster"
    return "persistent"


def stream_offset(layer: int, k, n, features: int, hidden: int):
    """Byte offset in the packed stream of W_layer[k, n] (input k, output
    n; layer 1 or 2): chunks of up to 256 output rows x 64 inputs, parts
    in order, K blocks in order within a part; inside a chunk row n holds
    its 64 inputs as eight 16-byte groups, group c at position c ^ (n % 8)
    (the 128-byte swizzle; ``a_offset`` in the CUDA source). ``k`` and
    ``n`` may be ints or numpy arrays."""
    p = plan(features, hidden)
    kp = p["k1p"] if layer == 1 else p["hp"]
    base = 0 if layer == 1 else p["hp"] * p["k1p"] * 2
    part, nl = np.divmod(n, PART)
    rows = np.minimum(PART, p["hp"] - part * PART)
    kb, kk = np.divmod(k, K_BLOCK)
    return (base + part * PART * kp * 2 + kb * rows * 128 + nl * 128
            + ((kk // 8) ^ (nl % 8)) * 16 + (kk % 8) * 2)


def pack_stream(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """W1 (F', H) and W2 (H, H), any float type -> the kernel's weight
    stream, uint8 on the CPU: W1^T and W2^T in bf16, zero-padded to
    (hp, k1p) and (hp, hp), cut into chunks and swizzled as
    ``stream_offset`` says."""
    features, hidden = w1.shape[0], w2.shape[0]
    p = plan(features, hidden)
    hp = p["hp"]
    n = torch.arange(PART)[:, None]
    swz = torch.arange(8)[None, :] ^ (n % 8)  # the group at each position

    def layer(w: torch.Tensor, kp: int) -> list[torch.Tensor]:
        wt = torch.zeros((hp, kp), dtype=torch.bfloat16)
        wt[: w.shape[1], : w.shape[0]] = w.t().to(torch.bfloat16)
        out = []
        for p0 in range(0, hp, PART):
            rows = min(PART, hp - p0)
            blk = wt[p0:p0 + rows].reshape(rows, kp // K_BLOCK, 8, 8).transpose(0, 1)
            out.append(blk[:, n[:rows], swz[:rows]].reshape(-1))
        return out

    w = torch.cat(layer(w1, p["k1p"]) + layer(w2, hp))
    return w.contiguous().view(torch.uint8)


def fold_for_kernel(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """MLP params (models/mlp.py layout) -> folded float32 kernel weights.

    With s = 1/sigma, (x - mu) * s @ W1 + b1 == x @ (s[:, None] * W1) +
    (b1 - (mu * s) @ W1). Computed on the host in numpy float32, as the
    reference does, so the folded weights match it to f32 rounding; W1 is
    returned (F', H) with F' the feature count rounded up to 16, rows past
    the feature count exactly zero. Refuses a model the kernel does not
    take with a ``ValueError`` that names the limit."""
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
    check_shapes(w1.shape[0], w1.shape[1])
    w1_folded = np.zeros((-(-w1.shape[0] // MMA_K) * MMA_K, w1.shape[1]), np.float32)
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
    """Folded weights -> the operands on ``device``. The plain version's:
    w1 (F', H), w2 (H, H) and w3 (H,) in bf16 (round to nearest even, as the
    reference kernel's in-body casts), b1, b2 (H,) and b3 (1,) in f32. The
    kernel's: ``stream`` (``pack_stream`` of the same bf16 W1 and W2) and
    ``vec`` (3, hp) f32 holding b1, b2 and w3 zero-padded. Fresh tensors,
    so a publish never aliases the caller's."""
    hidden = folded["w2"].shape[0]
    check_shapes(folded["w1"].shape[0], hidden)
    bf16, f32 = torch.bfloat16, torch.float32
    hp = plan(folded["w1"].shape[0], hidden)["hp"]

    def put(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return a.to(dtype).contiguous().to(device, copy=True)

    vec = torch.zeros((3, hp), dtype=f32)
    vec[0, :hidden] = folded["b1"].reshape(hidden)
    vec[1, :hidden] = folded["b2"].reshape(hidden)
    vec[2, :hidden] = folded["w3"].reshape(hidden).to(bf16).to(f32)
    return {
        "w1": put(folded["w1"], bf16),
        "b1": put(folded["b1"].reshape(hidden), f32),
        "w2": put(folded["w2"], bf16),
        "b2": put(folded["b2"].reshape(hidden), f32),
        "w3": put(folded["w3"].reshape(hidden), bf16),
        "b3": put(folded["b3"].reshape(1), f32),
        "stream": put(pack_stream(folded["w1"], folded["w2"]), torch.uint8),
        "vec": put(vec, f32),
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
    """The bound C entries (launch, plan, blocks) and CUDA's error-string
    lookup; builds the kernel library on first use."""
    from ccfd_tpu_torch.ops import _build

    lib = _build.load("fused_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.ccfd_fused_mlp_bf16
    fn.argtypes = [p] * 7 + [ctypes.c_longlong] + [i] * 4 + [p]
    fn.restype = i
    plan_fn = lib.ccfd_fused_mlp_bf16_plan
    plan_fn.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    plan_fn.restype = i
    blocks_fn = lib.ccfd_fused_mlp_bf16_blocks
    blocks_fn.argtypes = [i]
    blocks_fn.restype = i
    err = lib.ccfd_cuda_error_string
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    return fn, plan_fn, blocks_fn, err


def kernel_plan(features: int, hidden: int) -> dict[str, int]:
    """``plan`` as the built CUDA library computes it (needs nvcc; the card
    is not touched): ``chip_smoke.py`` holds it against ``plan``."""
    _fn, plan_fn, _blocks, _err = _kernel_entry()
    out = (ctypes.c_int * 7)()
    if plan_fn(features, hidden, out) != 0:
        raise ValueError(f"the kernel does not take F={features}, H={hidden}")
    return dict(zip(("k1p", "hp", "chunks", "stages", "resident", "wide", "smem"), out))


def _check_cuda_args(kp: Mapping[str, torch.Tensor], x: torch.Tensor) -> int:
    if x.dtype != INPUT_DTYPE or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"x must be a contiguous (B, F) bfloat16 tensor, got {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    features, hidden = x.shape[1], kp["w2"].shape[0]
    check_shapes(features, hidden)
    p = plan(features, hidden)
    if kp["w1"].shape[0] < features:
        raise ValueError(f"x has {features} features; the weights take {kp['w1'].shape[0]}")
    want = {  # the plain version's operands, then the kernel's own
        "w1": ((kp["w1"].shape[0], hidden), torch.bfloat16),
        "b1": ((hidden,), torch.float32), "w2": ((hidden, hidden), torch.bfloat16),
        "b2": ((hidden,), torch.float32), "w3": ((hidden,), torch.bfloat16),
        "b3": ((1,), torch.float32),
        "stream": (((p["k1p"] + p["hp"]) * p["hp"] * 2,), torch.uint8),
        "vec": ((3, p["hp"]), torch.float32),
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


# ccfd-lint: hot-path
def launch(kp: Mapping[str, torch.Tensor], x: torch.Tensor, path: str,
           with_logits: bool = False):
    """B1 on the card on the launch ``path`` names (one of ``PATHS``), at
    any batch: (B, F<=128) bf16 CUDA rows -> (B,) float32 proba (and
    logits), on the current stream. Both launches give a row the same bits.
    ``fused_mlp_score`` calls it with ``path_for``'s answer; the card tests
    and tools run the other. Counts the launch in ``launches`` and, on the
    cluster, in ``launches_cluster``. Raises ``ValueError`` for rows or
    weights the kernel does not take, ``RuntimeError`` when the entry
    refuses (a cluster of more than ``CLUSTER_MAX_CTAS`` CTAs)."""
    if x.device.type != "cuda":
        raise ValueError(f"B1's launch runs on cuda, not {x.device}")
    hidden = _check_cuda_args(kp, x)
    if x.data_ptr() % 16:  # a row slice at any offset: the tiles are bulk-copied
        x = x.clone()
    batch, features = x.shape
    proba = torch.empty(batch, dtype=torch.float32, device=x.device)
    z = torch.empty(batch, dtype=torch.float32, device=x.device) if with_logits else None
    if batch:
        fn, _plan, blocks_fn, err = _kernel_entry()
        scratch = None
        p = plan(features, hidden)
        if p["wide"]:  # one h1 tile per block, in global memory
            blocks = blocks_fn(batch)
            if blocks <= 0:
                raise RuntimeError("fused_mlp kernel: CUDA initialisation failed")
            scratch = torch.empty(blocks * TILE_ROWS * p["hp"] * 2, dtype=torch.uint8,
                                  device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), kp["stream"].data_ptr(), kp["vec"].data_ptr(),
                kp["b3"].data_ptr(), proba.data_ptr(),
                z.data_ptr() if z is not None else None,
                scratch.data_ptr() if scratch is not None else None,
                scratch.numel() if scratch is not None else 0,
                batch, features, hidden, PATHS.index(path), stream)
        if rc != 0:
            raise RuntimeError(
                f"fused_mlp kernel launch failed: CUDA error {rc} "
                f"({err(rc).decode()})")
        launches.inc()
        if path == "cluster":
            launches_cluster.inc()
    return (proba, z) if with_logits else proba


# ccfd-lint: hot-path
def fused_mlp_score(kp: Mapping[str, torch.Tensor], x: torch.Tensor,
                    with_logits: bool = False):
    """(B, F<=128) bf16 rows -> (B,) float32 proba (and logits when
    ``with_logits``). Any B: the kernel masks the ragged last tile.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (``launch``) on the launch ``path_for`` picks from the shape,
    or raises."""
    if x.device.type == "cpu":
        proba, z = fused_mlp_reference(kp, x)
        return (proba, z) if with_logits else proba
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_score runs on cuda or cpu, not {x.device}")
    return launch(kp, x, path_for(len(x), x.shape[-1], kp["w2"].shape[0]), with_logits)
