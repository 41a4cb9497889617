"""Bulk replay & backtest plane; the port of ccfd_tpu/replay.

Re-scores recorded decision history through the SAME serving stack that
made the original calls (bus -> router -> the scorer's kernel -> route),
under ``bulk`` admission so live traffic keeps its SLO, and holds the
verdict-parity conservation law ``replayed == recorded``: every divergence
is a classified finding, never a silent diff. See
:mod:`ccfd_tpu_torch.replay.service`.
"""

from ccfd_tpu_torch.replay.service import (  # noqa: F401
    CAUSE_CHAMPION_HASH,
    CAUSE_NONDETERMINISM,
    CAUSE_THRESHOLD,
    CAUSE_TIER,
    ReplayKilled,
    ReplayService,
    ReplayVerdictTap,
    bundle_window,
    classify_divergence,
)
