"""ccfd_tpu_torch: the PyTorch/CUDA port of ccfd_tpu for an NVIDIA H100.

The JAX package ``ccfd_tpu`` stays the reference. This package imports
``torch``, ``numpy`` and the standard library only; where it needs one of
the reference's modules it keeps its own copy. Its serving path is

    POST /api/v0.1/predictions -> serving.server.PredictionServer
      -> serving.batcher.DynamicBatcher -> serving.scorer.Scorer
      -> ops.fused_mlp.fused_mlp_score (CUDA kernel, ops/csrc/fused_mlp.cu)

and its decision pipeline runs in one process (``python -m ccfd_tpu_torch
demo``) or as the reference's separate service roles (``bus``, ``engine``,
``router``, ``notify``, ``producer``; cli.py). Entry points run on the card
(``cuda:0``) unless the caller asks for the CPU (``device="cpu"``), where
each kernel's plain PyTorch version runs.
"""
