#!/usr/bin/env python3
"""Where a tile's time goes inside kernels B2 and B3, on the card.

Builds a copy of ``ccfd_tpu_torch/ops/csrc/fused_mlp_q8.cu`` with
``clock64()`` stamps at the phase boundaries of the first tile of block 0
(thread 0, a consumer), runs B2 and B3 through the port's wrappers on
seeded random params, and prints the SM cycles at which each phase ended.
B3 runs on its persistent grid at every batch (``launch_preq`` with
``"persistent"``), where the stamps are. The copy is built into
``build/ccfd_tpu_torch/trace/``; the shipped library is untouched.
``ncu`` does not run on the card's machine; this is the kernel's own
clock.

    python tools/torch_q8_phase_trace.py        (from the repository root)

Exits non-zero without CUDA, or when a stamp's anchor is missing from the
source (the kernel was edited: update ANCHORS).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# (phase that ends here, source text the stamp follows, occurrence)
ANCHORS = (
    ("init", "  if (static_cast<int>(threadIdx.x) < R) amax[threadIdx.x] = 0u;\n"
             "  __syncthreads();", 1),
    ("row tile in", "    hopper::mbar_wait(xfull, xphase);", 1),
    ("input quantized", "    // ---- layer 1: chunks", 0),
    ("W1 chunk in", "      hopper::mbar_wait(&full[stage], phase);", 1),
    ("layer 1 products", "      next_stage();\n    }", 1),
    ("requantized", "    requantize(hf, L.ldf, hq, L.ldh, L.hp, rows, sx, rcp, warp, lane);\n"
                    "    hopper::named_sync(kConsumers);", 1),
    ("layer 2 products", "      if (live) dequant(acc, nj, col0, e, hf, L.ldf, r0, sx0, sx1, m0, m1);\n"
                         "    }", 1),
    ("row scales", "    take_row_scales(sx, rcp, amax, R);\n    hopper::named_sync(kConsumers);", 2),
    ("layer 3", "    hopper::named_sync(kConsumers);  // the tile's f32 activations", 0),
)
HEAD = """#include <stdint.h>
__device__ long long g_trace[16];
#define STAMP(i) do { if (blockIdx.x == 0 && threadIdx.x == 0 && g_trace[i] == 0) \\
    g_trace[i] = clock64(); } while (0)
"""
TAIL = """
extern "C" int q8_trace_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(long long) * 16);
}
extern "C" int q8_trace_reset() {
  long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
"""


def stamped_source(src: str) -> str:
    """The kernel source with STAMP(0) at its start and STAMP(i) after (or,
    for occurrence 0, before) each anchor."""
    start = "  const Layout L = make_layout(features, hidden);\n  const int R = L.rows;"
    if start not in src:
        raise SystemExit("anchor for the kernel's start not found: update the tool")
    src = src.replace(start, start + "\nSTAMP(0);", 1)
    for i, (phase, anchor, nth) in enumerate(ANCHORS, start=1):
        at = -1
        for _ in range(max(nth, 1)):
            at = src.find(anchor, at + 1)
            if at < 0:
                raise SystemExit(f"anchor for {phase!r} not found: update the tool")
        cut = at if nth == 0 else at + len(anchor)
        src = src[:cut] + f"\nSTAMP({i});\n" + src[cut:]
    return HEAD + src + TAIL


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_q8_phase_trace: needs a CUDA card", file=sys.stderr)
        return 1
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
    from ccfd_tpu_torch.models import mlp
    from ccfd_tpu_torch.ops import _build, quant
    from ccfd_tpu_torch.ops import fused_mlp_q8 as q8

    out_dir = _build.BUILD_DIR / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "fused_mlp_q8_trace.cu", out_dir / "fused_mlp_q8_trace.so"
    cu.write_text(stamped_source((_build.CSRC / "fused_mlp_q8.cu").read_text()))
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                            "-o", str(so), str(cu)], capture_output=True, text=True)
    if built.returncode:
        print(built.stdout + built.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    entries = q8.bind_entries(lib)
    q8._kernel_entries = lambda: entries  # the wrappers launch the copy

    dev = torch.device("cuda:0")
    rows = kaggle_surrogate(n=20_000).X
    names = ("start",) + tuple(a[0] for a in ANCHORS)
    print(torch.cuda.get_device_name(0), flush=True)
    for hidden in (256, 1040):
        g = torch.Generator().manual_seed(7)
        qp = quant.quantize_mlp(mlp.set_normalizer(mlp.init(g, hidden=hidden),
                                                   rows.mean(0), rows.std(0)))
        kp = q8.pack_for_kernel(q8.fold_for_kernel(qp), dev)
        for b in (16, 16384):
            x = torch.from_numpy(rows[:b]).to(dev)
            qh, sh = q8.prequantize_rows_numpy({k: kp[k].cpu() for k in ("mu", "sigma")},
                                               rows[:b])
            qd, sd = torch.from_numpy(qh).to(dev), torch.from_numpy(sh).to(dev)
            for label, fn in (("B2", lambda: q8.fused_mlp_q8_score(kp, x)),
                              ("B3", lambda: q8.launch_preq(kp, qd, sd, "persistent"))):
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                lib.q8_trace_reset()
                fn()
                torch.cuda.synchronize()
                stamps = (ctypes.c_longlong * 16)()
                lib.q8_trace_read(stamps)
                t0 = stamps[0]
                print(f"H={hidden} {label} B={b}: " + ", ".join(
                    f"{names[k]} +{stamps[k] - t0}" for k in range(len(names))
                    if stamps[k]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
