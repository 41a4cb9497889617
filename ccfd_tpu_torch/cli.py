"""Command-line entry points of the port.

  python -m ccfd_tpu_torch serve [--device cuda|cpu] [--params PATH]
                                 [--host H] [--port N]
  python -m ccfd_tpu_torch quantize --out PATH [--params PATH]
                                    [--test-frac F] [--device cuda|cpu]

``serve`` is the Seldon-contract REST scorer of the reference's
``python -m ccfd_tpu serve``: it serves the committed checkpoint
(``assets/mlp_step_1200.npz``, the reference's ``checkpoints/step_1200``)
unless ``--params`` names another ``.npz``, on the card unless
``--device cpu`` is given. The knobs of ``config.Config`` come from the
environment (CCFD_MODEL, CCFD_DTYPE, CCFD_BATCH_SIZES, CCFD_Q8_WIRE, ...).
With ``CCFD_MODEL=mlp_q8`` it serves int8 params: those of a q8 ``.npz``
(``quantize``'s output), or ``quantize_mlp`` of an f32 one, which for the
committed checkpoint equals the reference's ``checkpoints_q8/step_1200``.

``quantize`` is the reference's ``cmd_quantize``: f32 ``.npz`` in, q8
``.npz`` out, and one JSON line of evidence that quantization kept the
model's quality: the f32-to-int8 delta (AUC and probability) on a seeded
sample of the training dataset (the Kaggle-shaped surrogate, or the CSV at
CCFD_CSV; CCFD_SURROGATE_ROWS shrinks the surrogate). The f32 side runs the
served ``mlp`` graph on ``--device`` (the card by default), the int8 side
the host-tier forward, as the reference does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ccfd_tpu_torch.config import Config


def build_server(cfg: Config, device: str | None = None,
                 params_path: str | None = None):
    """The warmed-up ``PredictionServer`` that ``serve`` runs (not yet
    listening): params from ``params_path`` (default: the committed
    checkpoint; quantized when the model is ``mlp_q8`` and they are f32),
    a ``Scorer`` on ``device`` (default: the card)."""
    from ccfd_tpu_torch.ops import quant
    from ccfd_tpu_torch.params import DEFAULT_PARAMS, load_params
    from ccfd_tpu_torch.serving.scorer import Scorer
    from ccfd_tpu_torch.serving.server import PredictionServer

    params = load_params(params_path or DEFAULT_PARAMS)
    if cfg.model_name == "mlp_q8" and not quant.is_quantized(params):
        params = quant.quantize_mlp(params)
    scorer = Scorer(model_name=cfg.model_name, params=params,
                    batch_sizes=cfg.batch_sizes,
                    compute_dtype=cfg.compute_dtype, device=device,
                    q8_wire=cfg.q8_wire)
    scorer.warmup()
    return PredictionServer(scorer, cfg)


def cmd_serve(args: argparse.Namespace) -> int:
    cfg = Config.from_env()
    srv = build_server(cfg, device=args.device, params_path=args.params)
    host = args.host if args.host is not None else cfg.serve_host
    port = srv.start(host, args.port if args.port is not None else cfg.serve_port)
    grid = srv.scorer.executable_grid()
    print(f"[serve] model={cfg.model_name} device={srv.scorer.device} "
          f"kernel={'on' if grid['fused'] else 'off'} "
          f"int8_wire={'on' if grid['int8_wire'] else 'off'} listening on "
          f"{host}:{port}", file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def training_dataset():
    """The dataset ``quantize`` samples, as the reference's
    ``_training_dataset``: the CSV at CCFD_CSV, else the Kaggle-shaped
    surrogate (CCFD_SURROGATE_ROWS rows when set, else the full table)."""
    from ccfd_tpu_torch.data.ccfd import load_dataset
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

    if os.environ.get("CCFD_CSV"):
        return load_dataset()
    rows = int(os.environ.get("CCFD_SURROGATE_ROWS", "0") or 0)
    return kaggle_surrogate(n=rows) if rows > 0 else kaggle_surrogate()


def cmd_quantize(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from ccfd_tpu_torch.device import resolve
    from ccfd_tpu_torch.models import mlp
    from ccfd_tpu_torch.ops import quant
    from ccfd_tpu_torch.params import DEFAULT_PARAMS, load_params, save_params
    from ccfd_tpu_torch.utils.metrics_math import roc_auc

    src = args.params or DEFAULT_PARAMS
    dev = resolve(args.device)
    params = load_params(src)
    if quant.is_quantized(params):
        print(f"[quantize] {src} already holds int8 params", file=sys.stderr)
        return 2
    qp = quant.quantize_mlp(params)

    ds = training_dataset()
    rng = np.random.default_rng(0)
    te = rng.permutation(ds.n)[: max(1, int(ds.n * args.test_frac))]
    on_dev = load_params(src, device=dev)
    p32 = mlp.apply(on_dev, torch.from_numpy(ds.X[te]).to(dev)).cpu().numpy()
    p8 = quant.apply_numpy(qp, ds.X[te])
    save_params(qp, args.out)
    print(json.dumps({
        "source": str(src),
        "eval_rows": int(len(te)),
        "auc_f32": round(roc_auc(ds.y[te], p32), 6),
        "auc_int8": round(roc_auc(ds.y[te], p8), 6),
        "max_prob_delta": round(float(np.abs(p8 - p32).max()), 6),
        "evidence": "f32-to-int8 delta on a sampled evaluation set",
        "out": str(args.out),
        "serve_with": f"CCFD_MODEL=mlp_q8 python -m ccfd_tpu_torch serve --params {args.out}",
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ccfd_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="Seldon-contract REST scorer")
    s.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where to score (default: the card)")
    s.add_argument("--params", default=None,
                   help=".npz of MLP or int8 MLP params (default: the committed checkpoint)")
    s.add_argument("--host", default=None, help="bind address (CCFD_SERVE_HOST)")
    s.add_argument("--port", type=int, default=None, help="port (CCFD_SERVE_PORT)")
    s.set_defaults(fn=cmd_serve)
    q = sub.add_parser("quantize", help="int8-quantize f32 MLP params (mlp_q8)")
    q.add_argument("--params", default=None,
                   help="f32 .npz to quantize (default: the committed checkpoint)")
    q.add_argument("--out", required=True, help="where to write the int8 .npz")
    q.add_argument("--test-frac", type=float, default=0.2)
    q.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the f32 evidence forward runs (default: the card)")
    q.set_defaults(fn=cmd_quantize)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
