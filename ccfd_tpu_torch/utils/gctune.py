"""GC tuning for the service hot loops: the port's copy of
ccfd_tpu/utils/gctune.py.

The router decodes tens of thousands of records per second into
short-lived Python objects, so the default gen-0 threshold (700
allocations) fires collections hundreds of times per second, each a scan
of every tracked object. ``tune_for_service()`` raises the gen-0 threshold
so collections amortize over far more allocations (the hot loops' churn is
flat per batch; long-lived state is ``gc.freeze()``-d out of scanning).
Cycles still collect, about 100x less often.

Env: CCFD_GC_THRESHOLD overrides the gen-0 threshold (0 = leave Python's
defaults untouched), read as the reference reads it.
"""
from __future__ import annotations

import gc
import os


def tune_for_service(gen0: int | None = None) -> bool:
    """Apply service GC tuning; returns True when applied."""
    env = os.environ.get("CCFD_GC_THRESHOLD", "").strip()
    if env:
        try:
            gen0 = int(env)
        except ValueError:
            gen0 = None  # malformed: fall through to the default
    if gen0 is None:
        gen0 = 100_000
    if gen0 <= 0:
        return False
    # collect once so freeze() moves a clean startup set to the permanent
    # generation (imports, registries, the loaded kernel libraries)
    gc.collect()
    gc.freeze()
    _, g1, g2 = gc.get_threshold()
    gc.set_threshold(gen0, g1, g2)
    return True
