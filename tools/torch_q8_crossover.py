#!/usr/bin/env python3
"""A kernel's two launches timed against each other on the card: the
crossover that ``CLUSTER_MAX_BATCH`` records, for B3 in
``ccfd_tpu_torch/ops/fused_mlp_q8.py`` and, with ``--kernel b1``, for B1 in
``ops/fused_mlp.py``.

Runs both launches of the shipped library at each batch, through the
wrapper's named-path launch (``fused_mlp_q8.launch_preq``,
``fused_mlp.launch``). It holds the two launches' outputs to the same bits
(B3: and the plain version too; B1 sums in another order than its plain
version, so the widest |dp| against it is printed), then times each as the
lesser of two CUDA graphs of 100 back-to-back launches (the wrapper's host
work is not in them), on the committed model (F=30, H=256; B3 its int8
quantization) unless ``--hidden`` says otherwise (seeded random params).
``shipped_path`` is the launch ``path_for`` picks at that batch.

    python tools/torch_q8_crossover.py [--kernel b3|b1] [--hidden 256] [--batches 16,32,...]

Exits non-zero without CUDA, when the library fails to build or a launch
is refused, or when the two launches (B3: or the plain version) differ in
a bit.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BATCHES = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
KERNELS = ("b3", "b1")


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
    """B3's named-path launch and its plain version on its rows at a batch."""
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
        return (lambda path, logits=False: q8.launch_preq(kp, q, s, path, with_logits=logits),
                lambda: q8.fused_mlp_q8_preq_reference(kp, q, s))

    return q8, at


def _b1_case(torch, dev, rows, hidden: int):
    """B1's named-path launch and its plain version on its rows at a batch."""
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
        return (lambda path, logits=False: b1.launch(kp, x, path, with_logits=logits),
                lambda: b1.fused_mlp_reference(kp, x))

    return b1, at


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=KERNELS, default="b3")
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
    dev = torch.device("cuda:0")
    rows = kaggle_surrogate(n=20_000).X
    case = _b1_case if args.kernel == "b1" else _b3_case
    module, at = case(torch, dev, rows, args.hidden)
    out = []
    for b in (int(x) for x in args.batches.split(",")):
        score, plain = at(b)
        ms, res = {}, {}
        for path in module.PATHS:
            res[path] = score(path, True)
            torch.cuda.synchronize()
            launch = functools.partial(score, path)
            ms[path] = min(graph_ms(torch, launch), graph_ms(torch, launch))
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
            print(f"B={b}: the two launches differ"
                  + (" or differ from the plain version" if args.kernel == "b3" else ""),
                  file=sys.stderr)
            return 1
    wins = [ln["batch"] for ln in out if ln["cluster_ms"] < ln["persistent_ms"]]
    print(json.dumps({"cluster_faster_at": wins}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
