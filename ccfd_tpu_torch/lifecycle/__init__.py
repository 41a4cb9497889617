"""Model lifecycle: versioned shadow -> canary -> gated promotion -> rollback.

The port of ccfd_tpu/lifecycle. The online trainer's candidates no longer
swap straight into serving: each one is checkpointed and versioned, shadows
the champion on live batches, serves a hash-split canary slice, and only
then swaps into the scorer's kernel (B1 for ``mlp``), with auto-rollback
on a guardrail breach or an open scorer-edge breaker:

    TRAIN -> SHADOW -> CANARY -> PROMOTE
                 \\        \\-> ROLLBACK (guardrail breach / breaker open)
                  \\-> REJECT

- :mod:`~ccfd_tpu_torch.lifecycle.versions`: lineage and the transition
  audit trail, persisted (the reference's file, readable by either side).
- :mod:`~ccfd_tpu_torch.lifecycle.shadow`: the challenger scores the same
  live batches off the critical path; paired scores land on a bus topic.
- :mod:`~ccfd_tpu_torch.lifecycle.evaluator`: label AUC, precision@k,
  alert-rate delta and score PSI (``analytics/engine.py::psi``).
- :mod:`~ccfd_tpu_torch.lifecycle.controller`: the guardrailed state
  machine and the canary gate (``serving/graph.py`` ``hash_split``).

The challenger scores on the model's numpy host forward (the scorer's
challenger slot), which is the reference's own design for a second model
off the device's critical path; the champion never leaves the kernel.
The seq family's lifecycle (the SeqScorer's challenger slot, ROADMAP A12b)
is not ported: the operator refuses ``lifecycle`` under a seq scorer.
"""

from ccfd_tpu_torch.lifecycle.controller import (  # noqa: F401
    CanaryGate,
    Guardrails,
    LifecycleController,
)
from ccfd_tpu_torch.lifecycle.evaluator import ShadowEvaluator  # noqa: F401
from ccfd_tpu_torch.lifecycle.shadow import ShadowTap  # noqa: F401
from ccfd_tpu_torch.lifecycle.versions import ModelVersion, VersionStore  # noqa: F401
