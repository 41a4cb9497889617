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
the kernels and how the design streams host-packed weight chunks through a
ring of shared-memory stages. This module holds what surrounds them:

- ``fold_for_kernel`` checks a quantized tree against the reference's
  limits, and lays the weights out for the plain versions (W transposed to
  output-major, layer 1's depth zero-padded to a multiple of 32);
- ``pack_for_kernel`` puts them on a device, once per params publish, with
  the kernels' own operands: the weight stream (``pack_stream``), the
  scales and biases zero-padded to the kernels' width, and w3 likewise;
- ``plan`` mirrors the CUDA source's shared-memory layout;
- ``path_for`` chooses between B3's persistent grid and its cluster launch
  for small batches; the CUDA entry launches what it is told;
- ``prequantize_rows_numpy`` is B3's host half, bit for bit the
  reference's;
- ``fused_mlp_q8_reference`` and ``fused_mlp_q8_preq_reference`` are the
  plain PyTorch versions of the kernels' arithmetic, each returning
  ``(proba, logits)``;
- ``fused_mlp_q8_score`` and ``fused_mlp_q8_score_preq`` are the wrappers:
  the plain version for a CPU tensor, the kernel for a CUDA tensor (or an
  error: there is no fallback), each with its launch count;
  ``launch_preq`` runs B3 on a named launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Mapping

import numpy as np
import torch

from ccfd_tpu_torch.ops.launches import LaunchCounter
from ccfd_tpu_torch.ops.quant import EPS, host_array, int_matmul, quantize_rows

MMA_K = 32  # int8 MMA depth: fold pads layer 1's depth to a multiple of it
MAX_FEATURES = 128  # the reference's lane bound (ccfd_tpu/ops/fused_mlp.py LANE)
# the integer-exact f32 layer-3 sum of the reference holds while
# hidden * 127^2 < 2^24 (fused_mlp_q8.py:86-98 of the reference)
MAX_EXACT_HIDDEN = 1040
INPUT_DTYPE = torch.float32  # the f32 wire's rows
# the CUDA source's geometry (ops/csrc/fused_mlp_q8.cu)
GROUP = 64  # output columns of one chunk row group
SLICE = 256  # layer-2 K-slice of one chunk
STAGE_BYTES = GROUP * (SLICE + 16)
MAX_STAGES = 8
SMEM_LIMIT = 232_448  # dynamic shared memory one block may have on Hopper
# B3's cluster path (the CUDA source's kClusterMaxCtas): a cluster of hp / 64
# CTAs, at most the portable 8; path_for takes it for batches up to the
# crossover measured on the H100 (tools/torch_q8_crossover.py; the figures
# are in the CUDA source's head)
CLUSTER_MAX_CTAS = 8
CLUSTER_MAX_BATCH = 2048
PATHS = ("persistent", "cluster")  # B3's entry's launch argument, by index

launches = LaunchCounter("fused_mlp_q8")  # B2
launches_preq = LaunchCounter("fused_mlp_q8_preq")  # B3, either path
launches_preq_cluster = LaunchCounter("fused_mlp_q8_preq.cluster")  # B3's cluster path


def _a128(n: int) -> int:
    return -(-n // 128) * 128


def _plan_rows(features: int, hidden: int, rows: int) -> dict[str, int]:
    k1p = -(-features // 32) * 32
    hp = -(-hidden // GROUP) * GROUP
    ld1 = k1p + 16
    groups = hp // GROUP
    g1 = min(groups, STAGE_BYTES // (GROUP * ld1))
    c1 = -(-groups // g1)
    slices = -(-hp // SLICE)
    chunks = c1 + groups * slices
    sraw = _a128(4 * rows)
    fixed = (_a128(4 * rows * (max(hp, k1p) + 8)) + _a128(rows * (hp + 16))
             + _a128(rows * ld1) + _a128(4 * rows * features) + 4 * sraw + 256)
    stages = min(chunks, MAX_STAGES, max(0, (SMEM_LIMIT - fixed) // STAGE_BYTES))
    return {"k1p": k1p, "hp": hp, "rows": rows, "chunks": chunks, "stages": stages,
            "resident": int(stages == chunks), "smem": fixed + stages * STAGE_BYTES,
            "ld1": ld1, "g1": g1, "slices": slices}


@functools.cache
def plan(features: int, hidden: int) -> dict[str, int]:
    """The kernels' padded widths and shared-memory layout, as
    ``make_layout`` in the CUDA source computes them: F padded to a
    multiple of 32 (``k1p``), H to a multiple of 64 (``hp``); the most rows
    per tile (64 or 32) whose f32 activation tile, int8 tiles and a
    two-stage ring fit; the chunks a tile streams, the ring's stages
    (``resident`` when every chunk has its own), and the dynamic shared
    memory of one block."""
    for rows in (64, 32):
        p = _plan_rows(features, hidden, rows)
        if p["stages"] >= 2:
            break
    return p


def path_for(batch: int, features: int, hidden: int) -> str:
    """The launch ``fused_mlp_q8_score_preq`` hands B3's entry at this
    shape, the one place it is chosen: ``"cluster"`` (a cluster of ``hp /
    64`` CTAs a 64-row tile) for ``0 < batch <= CLUSTER_MAX_BATCH`` where
    ``hp / 64 <= CLUSTER_MAX_CTAS``, else ``"persistent"``. Raises
    ``ValueError`` for a shape the kernels do not take."""
    check_shapes(features, hidden)
    ctas = plan(features, hidden)["hp"] // GROUP
    if 0 < batch <= CLUSTER_MAX_BATCH and ctas <= CLUSTER_MAX_CTAS:
        return "cluster"
    return "persistent"


def stream_offset(layer: int, k, n, features: int, hidden: int):
    """Byte offset in the packed stream of Wq_layer[k, n] (input k, output
    n; layer 1 or 2). Layer 1 is W1^T with rows of ``k1p + 16`` bytes
    (streamed in chunks of whole 64-row groups); layer 2 is W2^T cut into
    64-row groups, each group's K in slices of up to 256 with rows of
    ``slice + 16`` bytes, groups in order, slices in order within a group.
    ``k`` and ``n`` may be ints or numpy arrays."""
    p = plan(features, hidden)
    if layer == 1:
        return n * p["ld1"] + k
    grp, nl = np.divmod(n, GROUP)
    s, kk = np.divmod(k, SLICE)
    ks = np.minimum(SLICE, p["hp"] - s * SLICE)
    return (p["hp"] * p["ld1"] + grp * GROUP * (p["hp"] + 16 * p["slices"])
            + s * GROUP * (SLICE + 16) + nl * (ks + 16) + kk)


def pack_stream(w1t: torch.Tensor, w2t: torch.Tensor, features: int) -> torch.Tensor:
    """W1^T (H, F') and W2^T (H, H) int8 -> the kernels' weight stream,
    int8 on the CPU, zero-padded and laid out as ``stream_offset`` says."""
    hidden = w2t.shape[0]
    p = plan(features, hidden)
    hp, ld1 = p["hp"], p["ld1"]
    l1 = torch.zeros((hp, ld1), dtype=torch.int8)
    l1[:hidden, : w1t.shape[1]] = w1t
    w2p = torch.zeros((hp, hp), dtype=torch.int8)
    w2p[:hidden, :hidden] = w2t
    out = [l1.reshape(-1)]
    for g0 in range(0, hp, GROUP):
        for k0 in range(0, hp, SLICE):
            ks = min(SLICE, hp - k0)
            blk = torch.zeros((GROUP, ks + 16), dtype=torch.int8)
            blk[:, :ks] = w2p[g0:g0 + GROUP, k0:k0 + ks]
            out.append(blk.reshape(-1))
    return torch.cat(out)


def check_shapes(features: int, hidden: int) -> None:
    """Raise ``ValueError`` for a model the kernels do not take: what the
    reference refuses (more than 128 features, a layer-3 input wider than
    1,040)."""
    if not 0 < features <= MAX_FEATURES:
        raise ValueError(
            f"fused q8 kernel takes at most {MAX_FEATURES} features, not {features}")
    if not 0 < hidden <= MAX_EXACT_HIDDEN:
        raise ValueError(
            f"fused q8 kernel: last-layer input width {hidden} > "
            f"{MAX_EXACT_HIDDEN} breaks the integer-exact layer-3 sum (2^24 bound)")


def fold_for_kernel(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Quantized MLP params (ops/quant.py layout) -> the kernels' weights
    as CPU tensors.

    Refuses, each with a ``ValueError`` naming the limit: a tree that is
    not quantized, a depth other than 3, a last layer wider than 1,040
    inputs (the reference's bound for its integer-exact layer-3 sum), and
    more than 128 features (the reference's lane bound).

    The normalizer is not folded into the int8 weights (per-input scaling
    would break the per-output-channel grid): mu and sigma ride along and
    the kernel divides by sigma, as the served graph does. Layout:
    ``w1t`` (H, F') and ``w2t`` (H, H) int8 are W transposed (output-major,
    the tensor cores' "col" operand), F' the feature count rounded up to
    32, ``w1t``'s columns past the feature count zero; ``w3`` (H,) int8;
    ``s*``/``b*`` float32."""
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
    w1t = np.zeros((hidden, -(-features // MMA_K) * MMA_K), np.int8)
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
    """Every operand's shape and type: the plain versions' and then the
    kernels' own (``stream``, ``vec`` = s1, b1, s2, b2 and ``w3p``, padded)."""
    f32, i8 = torch.float32, torch.int8
    p = plan(features, hidden)
    stream = p["hp"] * p["ld1"] + p["hp"] * (p["hp"] + 16 * p["slices"])
    return {
        "mu": ((features,), f32), "sigma": ((features,), f32),
        "w1t": ((hidden, -(-features // MMA_K) * MMA_K), i8),
        "s1": ((hidden,), f32), "b1": ((hidden,), f32),
        "w2t": ((hidden, hidden), i8), "s2": ((hidden,), f32), "b2": ((hidden,), f32),
        "w3": ((hidden,), i8), "s3": ((1,), f32), "b3": ((1,), f32),
        "stream": ((stream,), i8), "vec": ((4, p["hp"]), f32), "w3p": ((p["hp"],), i8),
    }


def pack_for_kernel(folded: Mapping[str, torch.Tensor],
                    device: "str | torch.device") -> dict[str, torch.Tensor]:
    """Folded weights -> the operands on ``device``: fresh contiguous
    tensors, so a publish never aliases the caller's."""
    features, hidden = folded["mu"].shape[0], folded["w2t"].shape[0]
    check_shapes(features, hidden)
    hp = plan(features, hidden)["hp"]
    vec = torch.zeros((4, hp), dtype=torch.float32)
    for i, k in enumerate(("s1", "b1", "s2", "b2")):
        vec[i, :hidden] = folded[k]
    w3p = torch.zeros(hp, dtype=torch.int8)
    w3p[:hidden] = folded["w3"]
    kernel = {"stream": pack_stream(folded["w1t"], folded["w2t"], features),
              "vec": vec, "w3p": w3p}
    return {k: (kernel[k] if k in kernel else folded[k]).to(dtype).contiguous()
            .to(device, copy=True)
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


def bind_entries(lib: ctypes.CDLL):
    """The C entries of a build of the CUDA source (B2, B3, plan) and
    CUDA's error-string lookup, bound with their types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    full = lib.ccfd_fused_mlp_q8
    full.argtypes = [p] * 10 + [i] * 3 + [p]
    full.restype = i
    preq = lib.ccfd_fused_mlp_q8_preq
    preq.argtypes = [p] * 9 + [i] * 4 + [p]
    preq.restype = i
    plan_fn = lib.ccfd_fused_mlp_q8_plan
    plan_fn.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    plan_fn.restype = i
    err = lib.ccfd_q8_cuda_error_string
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    return full, preq, plan_fn, err


@functools.cache
def _kernel_entries():
    """``bind_entries`` of the shipped library; builds it on first use."""
    from ccfd_tpu_torch.ops import _build

    return bind_entries(_build.load("fused_mlp_q8"))


def kernel_plan(features: int, hidden: int) -> dict[str, int]:
    """``plan`` as the built CUDA library computes it (needs nvcc; the card
    is not touched): ``chip_smoke.py`` holds it against ``plan``."""
    plan_fn = _kernel_entries()[2]
    out = (ctypes.c_int * 7)()
    if plan_fn(features, hidden, out) != 0:
        raise ValueError(f"the kernels do not take F={features}, H={hidden}")
    return dict(zip(("k1p", "hp", "rows", "chunks", "stages", "resident", "smem"), out))


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


def _check_rows(t: torch.Tensor, what: str, dtype: torch.dtype,
                width: int) -> torch.Tensor:
    """``t`` checked, and copied when it does not start 16-byte aligned (a
    row slice at any offset): the kernels bulk-copy its tiles."""
    if (t.dtype != dtype or t.dim() != 2 or t.shape[1] != width
            or not t.is_contiguous()):
        raise ValueError(
            f"{what} must be a contiguous (B, {width}) {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    return t.clone() if t.data_ptr() % 16 else t


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
    """B2: (B, F<=128) f32 rows -> (B,) float32 proba (and logits when
    ``with_logits``). Any B: the kernel masks the ragged last tile.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream, or raises."""
    if x.device.type == "cpu":
        proba, z = fused_mlp_q8_reference(kp, x)
        return (proba, z) if with_logits else proba
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_q8_score runs on cuda or cpu, not {x.device}")
    features, hidden = _check_weights(kp, x.device)
    x = _check_rows(x, "x", INPUT_DTYPE, features)
    batch = x.shape[0]
    proba, z = _outputs(batch, x.device, with_logits)
    if batch:
        full, _preq, _plan, err = _kernel_entries()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = full(x.data_ptr(), kp["mu"].data_ptr(), kp["sigma"].data_ptr(),
                  kp["stream"].data_ptr(), kp["vec"].data_ptr(), kp["w3p"].data_ptr(),
                  kp["s3"].data_ptr(), kp["b3"].data_ptr(), proba.data_ptr(), z.data_ptr() if z is not None else None,
                  batch, features, hidden, stream)
        _raise_on(rc, err, "fused_mlp_q8")
        launches.inc()
    return (proba, z) if with_logits else proba


def launch_preq(kp: Mapping[str, torch.Tensor], q: torch.Tensor, s: torch.Tensor,
                path: str, with_logits: bool = False):
    """B3 on the card on the launch ``path`` names (one of ``PATHS``), at
    any batch: (B, F<=128) int8 CUDA rows and their (B, 1) f32 scales ->
    (B,) float32 proba (and logits), on the current stream. Both launches
    give a row the same bits. ``fused_mlp_q8_score_preq`` calls it with
    ``path_for``'s answer; the card tests and tools run the other. Counts
    the launch in ``launches_preq`` and, on the cluster, in
    ``launches_preq_cluster``. Raises ``ValueError`` for rows or weights
    the kernel does not take, ``RuntimeError`` when the entry refuses (a
    cluster of more than ``CLUSTER_MAX_CTAS`` CTAs)."""
    if q.device.type != "cuda" or s.device != q.device:
        raise ValueError(
            f"B3's launch runs on cuda, with q and s on one device, not {q.device} "
            f"and {s.device}")
    features, hidden = _check_weights(kp, q.device)
    q = _check_rows(q, "q", torch.int8, features)
    s = _check_rows(s, "s", torch.float32, 1)
    batch = q.shape[0]
    if s.shape[0] != batch:
        raise ValueError(f"q has {batch} rows but s has {s.shape[0]}")
    proba, z = _outputs(batch, q.device, with_logits)
    if batch:
        _full, preq, _plan, err = _kernel_entries()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = preq(q.data_ptr(), s.data_ptr(), kp["stream"].data_ptr(),
                  kp["vec"].data_ptr(), kp["w3p"].data_ptr(), kp["s3"].data_ptr(),
                  kp["b3"].data_ptr(), proba.data_ptr(),
                  z.data_ptr() if z is not None else None,
                  batch, features, hidden, PATHS.index(path), stream)
        _raise_on(rc, err, "fused_mlp_q8_preq")
        launches_preq.inc()
        if path == "cluster":
            launches_preq_cluster.inc()
    return (proba, z) if with_logits else proba


def fused_mlp_q8_score_preq(kp: Mapping[str, torch.Tensor], q: torch.Tensor,
                            s: torch.Tensor, with_logits: bool = False):
    """B3: (B, F<=128) int8 rows and their (B, 1) f32 scales (from
    ``prequantize_rows_numpy``) -> (B,) float32 proba (and logits).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (``launch_preq``) on the launch ``path_for`` picks from the
    shape, or raises."""
    if q.device.type == "cpu" and s.device.type == "cpu":
        proba, z = fused_mlp_q8_preq_reference(kp, q, s)
        return (proba, z) if with_logits else proba
    if q.device.type != "cuda" or s.device != q.device:
        raise ValueError(
            f"fused_mlp_q8_score_preq runs on cuda or cpu, with q and s on one "
            f"device, not {q.device} and {s.device}")
    return launch_preq(kp, q, s, path_for(len(q), q.shape[-1], kp["w2t"].shape[0]),
                       with_logits)
