"""ccfd-lint: the review findings as machine-checked invariants.

The port's copy of ccfd_tpu/analysis/. The reference's review history kept
re-finding the same defect classes by hand: persistent writers bypassing
the durability seam, ``time.time()`` pairs used as durations (an NTP step
is a negative latency), silent drops that never touched a counter (the "no
silent caps" invariant), breaker paths recording zero or two outcomes, host
syncs on the device hot path, and lock inversions that only live drills
caught. The conventions are structured enough to check mechanically, so
this package turns each class into a named rule over Python ``ast``:

- :mod:`ccfd_tpu_torch.analysis.core`: rule registry, per-line suppression
  pragmas (``# ccfd-lint: disable=<rule> -- why``), the port's checked-in
  baseline for grandfathered findings (``assets/lint_baseline.json``),
  human and strict-JSON reports.
- :mod:`ccfd_tpu_torch.analysis.rules`: the seven invariants (see each
  rule's ``invariant`` string). ``hot-path-sync`` names torch's
  device-to-host syncs where the reference's names JAX's.
- :mod:`ccfd_tpu_torch.analysis.lockcheck`: the runtime half of the
  lock-order rule: ``CCFD_LOCKCHECK=1`` arms :func:`lockcheck.install`,
  which wraps ``threading.Lock``/``RLock`` so the per-thread
  acquisition-order graph is recorded live and a cycle fails the process
  instead of deadlocking a drill later.

Run via ``python -m ccfd_tpu_torch lint``. The package imports the
standard library only: the gate runs where no accelerator, no torch build
and no JAX is present.
"""

from ccfd_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    LintReport,
    Rule,
    lint_sources,
    load_baseline,
    run_lint,
)
