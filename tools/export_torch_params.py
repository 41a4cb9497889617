"""Write the committed MLP checkpoint as the PyTorch port's params file.

Restores ``checkpoints/step_1200`` through the JAX package (the same restore
``python -m ccfd_tpu serve`` uses) and writes it as an ``.npz`` with keys
``norm/mu``, ``norm/sigma``, ``layers/{i}/w``, ``layers/{i}/b``, which
``ccfd_tpu_torch.params.load_params`` reads without JAX.

    python tools/export_torch_params.py [--checkpoint-dir ./checkpoints]
        [--out ccfd_tpu_torch/assets/mlp_step_1200.npz]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def restore_reference(checkpoint_dir: str):
    """The MLP params the reference serves from ``checkpoint_dir``, as a
    tree of numpy float32 arrays."""
    import jax
    import numpy as np

    from ccfd_tpu.cli import _restore_mlp_checkpoint

    params = _restore_mlp_checkpoint(checkpoint_dir)
    if params is None:
        raise SystemExit(f"no MLP checkpoint in {checkpoint_dir!r}")
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint-dir", default="./checkpoints")
    ap.add_argument("--out", default="ccfd_tpu_torch/assets/mlp_step_1200.npz")
    args = ap.parse_args(argv)

    from ccfd_tpu_torch.params import save_params

    save_params(restore_reference(args.checkpoint_dir), args.out)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
