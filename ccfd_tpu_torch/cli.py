"""Command-line entry points of the port.

  python -m ccfd_tpu_torch serve [--device cuda|cpu] [--params PATH]
                                 [--host H] [--port N]

``serve`` is the Seldon-contract REST scorer of the reference's
``python -m ccfd_tpu serve``: it serves the committed checkpoint
(``assets/mlp_step_1200.npz``, the reference's ``checkpoints/step_1200``)
unless ``--params`` names another ``.npz``, on the card unless
``--device cpu`` is given. The knobs of ``config.Config`` come from the
environment (CCFD_MODEL, CCFD_DTYPE, CCFD_BATCH_SIZES, ...).
"""

from __future__ import annotations

import argparse
import sys
import time

from ccfd_tpu_torch.config import Config


def build_server(cfg: Config, device: str | None = None,
                 params_path: str | None = None):
    """The warmed-up ``PredictionServer`` that ``serve`` runs (not yet
    listening): params from ``params_path`` (default: the committed
    checkpoint), a ``Scorer`` on ``device`` (default: the card)."""
    from ccfd_tpu_torch.params import DEFAULT_PARAMS, load_params
    from ccfd_tpu_torch.serving.scorer import Scorer
    from ccfd_tpu_torch.serving.server import PredictionServer

    params = load_params(params_path or DEFAULT_PARAMS)
    scorer = Scorer(model_name=cfg.model_name, params=params,
                    batch_sizes=cfg.batch_sizes,
                    compute_dtype=cfg.compute_dtype, device=device)
    scorer.warmup()
    return PredictionServer(scorer, cfg)


def cmd_serve(args: argparse.Namespace) -> int:
    cfg = Config.from_env()
    srv = build_server(cfg, device=args.device, params_path=args.params)
    host = args.host if args.host is not None else cfg.serve_host
    port = srv.start(host, args.port if args.port is not None else cfg.serve_port)
    print(f"[serve] model={cfg.model_name} device={srv.scorer.device} "
          f"kernel={'on' if srv.scorer.fused else 'off'} listening on "
          f"{host}:{port}", file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ccfd_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="Seldon-contract REST scorer")
    s.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where to score (default: the card)")
    s.add_argument("--params", default=None,
                   help=".npz of MLP params (default: the committed checkpoint)")
    s.add_argument("--host", default=None, help="bind address (CCFD_SERVE_HOST)")
    s.add_argument("--port", type=int, default=None, help="port (CCFD_SERVE_PORT)")
    s.set_defaults(fn=cmd_serve)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
