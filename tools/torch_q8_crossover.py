#!/usr/bin/env python3
"""A kernel's two launches timed against each other on the card: the
crossover that ``kClusterMaxBatch`` records, for B3 in
``ccfd_tpu_torch/ops/csrc/fused_mlp_q8.cu`` (``CLUSTER_MAX_BATCH`` in
``ops/fused_mlp_q8.py``) and, with ``--kernel b1``, for B1 in
``ops/csrc/fused_mlp.cu`` (``ops/fused_mlp.py``).

Builds two copies of the source into ``build/ccfd_tpu_torch/crossover/``,
one whose entry always takes the persistent grid and one that takes the
cluster launch at every batch it can; the shipped library is untouched. At
each batch it holds the two copies' outputs to the same bits (B3: and the
plain version too; B1 sums in another order than its plain version, so the
widest |dp| against it is printed), then times each as the lesser of two
CUDA graphs of 100 back-to-back launches (the wrapper's host work is not in
them), on the committed model (F=30, H=256; B3 its int8 quantization)
unless ``--hidden`` says otherwise (seeded random params).

    python tools/torch_q8_crossover.py [--kernel b3|b1] [--hidden 256] [--batches 16,32,...]

Exits non-zero without CUDA, when a copy fails to build, or when the two
paths (B3: or the plain version) differ in a bit.
"""

from __future__ import annotations

import argparse
import contextlib
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
SOURCES = {"b3": "fused_mlp_q8", "b1": "fused_mlp"}  # the library of each kernel


def build(variant: str, source: str = "fused_mlp_q8") -> ctypes.CDLL:
    from ccfd_tpu_torch.ops import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    if not CONSTANT.search(src):
        raise SystemExit("kClusterMaxBatch not found in the source: update the tool")
    out_dir = _build.BUILD_DIR / "crossover"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{source}_{variant}.cu", out_dir / f"{source}_{variant}.so"
    cu.write_text(CONSTANT.sub(f"constexpr int kClusterMaxBatch = {VARIANTS[variant]};", src))
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                            "-o", str(so), str(cu)], capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"{source} {variant}: nvcc exited {built.returncode}\n"
                         f"{built.stdout}{built.stderr}")
    for line in (built.stdout + built.stderr).splitlines():
        if line.strip():
            print(f"{source} {variant} ptxas: {line.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def entries(lib: ctypes.CDLL):
    """B3's library as ``ops/fused_mlp_q8.py _kernel_entries`` binds it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    full, preq = lib.ccfd_fused_mlp_q8, lib.ccfd_fused_mlp_q8_preq
    full.argtypes, preq.argtypes = [p] * 10 + [i] * 3 + [p], [p] * 9 + [i] * 3 + [p]
    full.restype = preq.restype = i
    err = lib.ccfd_q8_cuda_error_string
    err.argtypes, err.restype = [i], ctypes.c_char_p
    return full, preq, None, err


def b1_entries(lib: ctypes.CDLL):
    """B1's library as ``ops/fused_mlp.py _kernel_entry`` binds it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn, plan_fn, blocks = lib.ccfd_fused_mlp_bf16, lib.ccfd_fused_mlp_bf16_plan, \
        lib.ccfd_fused_mlp_bf16_blocks
    fn.argtypes, fn.restype = [p] * 7 + [ctypes.c_longlong] + [i] * 3 + [p], i
    plan_fn.argtypes, plan_fn.restype = [i, i, ctypes.POINTER(ctypes.c_int)], i
    blocks.argtypes, blocks.restype = [i], i
    err = lib.ccfd_cuda_error_string
    err.argtypes, err.restype = [i], ctypes.c_char_p
    return fn, plan_fn, blocks, err


def b1_variants() -> dict:
    """B1's two copies, built and bound: {"persistent": entries, "cluster":
    entries}, for ``launching``."""
    return {v: b1_entries(build(v, SOURCES["b1"])) for v in VARIANTS}


@contextlib.contextmanager
def launching(module, attr: str, ent):
    """The kernel wrapper of ``module`` launches the copy bound in ``ent``
    (its cached ``attr`` entry replaced) while the block runs."""
    shipped = getattr(module, attr)
    setattr(module, attr, lambda: ent)
    try:
        yield
    finally:
        setattr(module, attr, shipped)


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


def _b3_case(torch, dev, rows, hidden: int):
    """B3's wrapper, its plain version and its rows at a batch."""
    from ccfd_tpu_torch.models import mlp
    from ccfd_tpu_torch.ops import fused_mlp_q8 as q8
    from ccfd_tpu_torch.ops import quant
    from ccfd_tpu_torch.params import load_params

    if hidden == 256:
        qp = quant.quantize_mlp(load_params())
    else:
        g = torch.Generator().manual_seed(7)
        qp = quant.quantize_mlp(mlp.set_normalizer(mlp.init(g, hidden=hidden),
                                                   rows.mean(0), rows.std(0)))
    kp = q8.pack_for_kernel(q8.fold_for_kernel(qp), dev)
    host_norm = {k: kp[k].cpu() for k in ("mu", "sigma")}

    def at(b: int):
        qh, sh = q8.prequantize_rows_numpy(host_norm, rows[:b])
        q, s = torch.from_numpy(qh).to(dev), torch.from_numpy(sh).to(dev)
        return (lambda logits=False: q8.fused_mlp_q8_score_preq(kp, q, s, with_logits=logits),
                lambda: q8.fused_mlp_q8_preq_reference(kp, q, s))

    return q8, "_kernel_entries", at


def _b1_case(torch, dev, rows, hidden: int):
    """B1's wrapper, its plain version and its rows at a batch."""
    from ccfd_tpu_torch.models import mlp
    from ccfd_tpu_torch.ops import fused_mlp as b1
    from ccfd_tpu_torch.params import load_params

    if hidden == 256:
        params = load_params()
    else:
        g = torch.Generator().manual_seed(7)
        params = mlp.set_normalizer(mlp.init(g, hidden=hidden), rows.mean(0), rows.std(0))
    kp = b1.pack_for_kernel(b1.fold_for_kernel(params), dev)

    def at(b: int):
        x = torch.from_numpy(rows[:b]).to(torch.bfloat16).to(dev)
        return (lambda logits=False: b1.fused_mlp_score(kp, x, with_logits=logits),
                lambda: b1.fused_mlp_reference(kp, x))

    return b1, "_kernel_entry", at


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(SOURCES), default="b3")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_q8_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip() or torch.cuda.get_device_name(0)}", flush=True)
    bind = b1_entries if args.kernel == "b1" else entries
    libs = {v: bind(build(v, SOURCES[args.kernel])) for v in VARIANTS}
    dev = torch.device("cuda:0")
    rows = kaggle_surrogate(n=20_000).X
    case = _b1_case if args.kernel == "b1" else _b3_case
    module, attr, at = case(torch, dev, rows, args.hidden)
    out = []
    for b in (int(x) for x in args.batches.split(",")):
        score, plain = at(b)
        ms, res = {}, {}
        for v, ent in libs.items():
            with launching(module, attr, ent):  # the wrapper launches the copy
                res[v] = score(True)
                torch.cuda.synchronize()
                ms[v] = min(graph_ms(torch, score), graph_ms(torch, score))
        ref = plain()
        same = all(torch.equal(a, c) for a, c in zip(res["persistent"], res["cluster"]))
        dp = (res["persistent"][0] - ref[0]).abs().max().item()
        if args.kernel == "b3":
            same = same and all(torch.equal(a, r) for a, r in zip(res["persistent"], ref))
        line = {"kernel": args.kernel, "batch": b, "hidden": args.hidden,
                "persistent_ms": ms["persistent"], "cluster_ms": ms["cluster"],
                "ratio": ms["cluster"] / ms["persistent"], "bit_equal": same,
                "max_dp_vs_plain": dp, "shipped_path": module.path_for(b, 30, args.hidden)}
        out.append(line)
        print(json.dumps(line), flush=True)
        if not same:
            print(f"B={b}: the two paths differ"
                  + (" or differ from the plain version" if args.kernel == "b3" else ""),
                  file=sys.stderr)
            return 1
    wins = [ln["batch"] for ln in out if ln["cluster_ms"] < ln["persistent_ms"]]
    print(json.dumps({"cluster_faster_at": wins}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
