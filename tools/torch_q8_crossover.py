#!/usr/bin/env python3
"""Kernel B3's two launches timed against each other on the card: the
crossover that ``kClusterMaxBatch`` in ``ccfd_tpu_torch/ops/csrc/fused_mlp_q8.cu``
(``CLUSTER_MAX_BATCH`` in ``ops/fused_mlp_q8.py``) records.

Builds two copies of the source into ``build/ccfd_tpu_torch/crossover/``,
one whose entry always takes the persistent grid and one that takes the
cluster launch at every batch; the shipped library is untouched. At each
batch it holds the two copies' outputs and the plain version to the same
bits, then times each
as the lesser of two CUDA graphs of 100 back-to-back launches (the
wrapper's host work is not in them), on the committed int8 model (F=30,
H=256) unless ``--hidden`` says otherwise (seeded random params).

    python tools/torch_q8_crossover.py [--hidden 256] [--batches 16,32,...]

Exits non-zero without CUDA, when a copy fails to build, or when the two
paths or the plain version differ in a bit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BATCHES = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
CONSTANT = re.compile(r"constexpr int kClusterMaxBatch = [^;]+;")
VARIANTS = {"persistent": "0", "cluster": "1 << 30"}


def build(variant: str) -> ctypes.CDLL:
    from ccfd_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_mlp_q8.cu").read_text()
    if not CONSTANT.search(src):
        raise SystemExit("kClusterMaxBatch not found in the source: update the tool")
    out_dir = _build.BUILD_DIR / "crossover"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"fused_mlp_q8_{variant}.cu", out_dir / f"fused_mlp_q8_{variant}.so"
    cu.write_text(CONSTANT.sub(f"constexpr int kClusterMaxBatch = {VARIANTS[variant]};", src))
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                            "-o", str(so), str(cu)], capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"{variant}: nvcc exited {built.returncode}\n"
                         f"{built.stdout}{built.stderr}")
    for line in (built.stdout + built.stderr).splitlines():
        if line.strip():
            print(f"{variant} ptxas: {line.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def entries(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    full, preq = lib.ccfd_fused_mlp_q8, lib.ccfd_fused_mlp_q8_preq
    full.argtypes, preq.argtypes = [p] * 10 + [i] * 3 + [p], [p] * 9 + [i] * 3 + [p]
    full.restype = preq.restype = i
    err = lib.ccfd_q8_cuda_error_string
    err.argtypes, err.restype = [i], ctypes.c_char_p
    return full, preq, None, err


def graph_ms(torch, fn, n: int = 100) -> float:
    """Device ms a launch: ``n`` launches in one CUDA graph, replayed 5
    times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_q8_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
    from ccfd_tpu_torch.models import mlp
    from ccfd_tpu_torch.ops import fused_mlp_q8 as q8
    from ccfd_tpu_torch.ops import quant
    from ccfd_tpu_torch.params import load_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip() or torch.cuda.get_device_name(0)}", flush=True)
    libs = {v: entries(build(v)) for v in VARIANTS}
    dev = torch.device("cuda:0")
    rows = kaggle_surrogate(n=20_000).X
    if args.hidden == 256:
        qp = quant.quantize_mlp(load_params())
    else:
        g = torch.Generator().manual_seed(7)
        qp = quant.quantize_mlp(mlp.set_normalizer(mlp.init(g, hidden=args.hidden),
                                                   rows.mean(0), rows.std(0)))
    kp = q8.pack_for_kernel(q8.fold_for_kernel(qp), dev)
    host_norm = {k: kp[k].cpu() for k in ("mu", "sigma")}
    shipped = q8._kernel_entries
    out = []
    try:
        for b in (int(x) for x in args.batches.split(",")):
            qh, sh = q8.prequantize_rows_numpy(host_norm, rows[:b])
            q, s = torch.from_numpy(qh).to(dev), torch.from_numpy(sh).to(dev)
            ms, res = {}, {}
            for v, ent in libs.items():
                q8._kernel_entries = lambda ent=ent: ent  # the wrapper launches the copy
                res[v] = q8.fused_mlp_q8_score_preq(kp, q, s, with_logits=True)
                torch.cuda.synchronize()
                launch = lambda: q8.fused_mlp_q8_score_preq(kp, q, s)  # noqa: E731
                ms[v] = min(graph_ms(torch, launch), graph_ms(torch, launch))
            ref = q8.fused_mlp_q8_preq_reference(kp, q, s)
            same = all(torch.equal(a, c) and torch.equal(a, r)
                       for a, c, r in zip(res["persistent"], res["cluster"], ref))
            line = {"batch": b, "hidden": args.hidden, "persistent_ms": ms["persistent"],
                    "cluster_ms": ms["cluster"], "ratio": ms["cluster"] / ms["persistent"],
                    "bit_equal": same, "shipped_path": q8.path_for(b, 30, args.hidden)}
            out.append(line)
            print(json.dumps(line), flush=True)
            if not same:
                print(f"B={b}: the two paths and the plain version differ", file=sys.stderr)
                return 1
    finally:
        q8._kernel_entries = shipped
    wins = [ln["batch"] for ln in out if ln["cluster_ms"] < ln["persistent_ms"]]
    print(json.dumps({"cluster_faster_at": wins}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
