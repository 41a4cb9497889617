"""Write the seq family's committed assets of the PyTorch port from the JAX
reference.

- ``ccfd_tpu_torch/assets/seq_init.npz``: the params the reference's
  operator serves for ``scorer.model: seq`` — ``seq.init(PRNGKey(0))``
  normalized on ``synthetic_dataset(n=4096, fraud_rate=0.01, seed=0)`` —
  flattened as ``params.save_params`` writes any tree (``embed/w``,
  ``blocks/0/qkv/w``, ...). The port cannot draw JAX's PRNG stream, so its
  operator loads this file (``params.load_tree``).
- ``ccfd_tpu_torch/assets/seq_golden.npz``: ``GOLDEN_ROWS`` seeded
  (64, 30) histories (``x``; row i holds ``depth[i]`` real transactions,
  newest last, zero left-pad) and the reference's probabilities at
  ``pos_length=64``: ``p_seq_f32``, ``p_seq_bf16`` (``seq.apply_serving``)
  and ``p_seq_q8_bf16``, ``p_seq_q8_f32`` (``seq_quant.apply`` of
  ``quantize_seq`` of the same params). Each graph runs op by op
  (``jax.disable_jit``): the port follows the reference's op-by-op
  rounding, where XLA's fused graph may contract an FMA or a reciprocal.
  ``chip_smoke.py`` holds the card's probabilities against these, since
  the card's machine has no JAX.

    JAX_PLATFORMS=cpu python tools/export_torch_seq_assets.py [--out-dir DIR]

``tests/test_torch_seq.py`` regenerates both from the reference and checks
that they equal the committed files.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_ROWS = 32
LENGTH = 64
GOLDEN_SEED = 11


def reference_seq_params():
    """The reference operator's seq params as a tree of numpy arrays."""
    import jax
    import numpy as np

    from ccfd_tpu.data.ccfd import synthetic_dataset
    from ccfd_tpu.models import seq as seq_mod

    params = seq_mod.init(jax.random.PRNGKey(0))
    ds = synthetic_dataset(n=4096, fraud_rate=0.01, seed=0)
    params = seq_mod.set_normalizer(params, ds.X.mean(0), ds.X.std(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def golden_histories():
    """(x (GOLDEN_ROWS, LENGTH, 30) float32, depth (GOLDEN_ROWS,) int32):
    rows of the surrogate table as transactions, each history of a seeded
    depth (1 and LENGTH included), zero left-padded."""
    import numpy as np

    from ccfd_tpu.data.ccfd import synthetic_dataset

    ds = synthetic_dataset(n=4096, fraud_rate=0.05, seed=GOLDEN_SEED)
    rng = np.random.default_rng(GOLDEN_SEED)
    depth = rng.integers(1, LENGTH + 1, size=GOLDEN_ROWS).astype(np.int32)
    depth[0], depth[1] = 1, LENGTH
    x = np.zeros((GOLDEN_ROWS, LENGTH, ds.X.shape[1]), np.float32)
    for i, d in enumerate(depth):
        x[i, LENGTH - d:] = ds.X[rng.integers(0, ds.n, size=d)]
    return x, depth


def golden(params) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ccfd_tpu.models import seq as seq_mod
    from ccfd_tpu.ops import seq_quant

    x, depth = golden_histories()
    q8 = seq_quant.quantize_seq(params)
    out = {"x": x, "depth": depth}
    with jax.disable_jit():
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            out[f"p_seq_{name}"] = np.asarray(
                seq_mod.apply_serving(params, jnp.asarray(x), dt, pos_length=LENGTH), np.float32)
            out[f"p_seq_q8_{name}"] = np.asarray(
                seq_quant.apply(q8, jnp.asarray(x), dt, pos_length=LENGTH), np.float32)
    return out


def main(argv: list[str] | None = None) -> int:
    import numpy as np

    from ccfd_tpu_torch.params import save_params

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="ccfd_tpu_torch/assets")
    args = ap.parse_args(argv)
    params = reference_seq_params()
    save_params(params, os.path.join(args.out_dir, "seq_init.npz"))
    with open(os.path.join(args.out_dir, "seq_golden.npz"), "wb") as f:
        np.savez_compressed(f, **golden(params))
    print(f"wrote seq_init.npz and seq_golden.npz to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
