"""Batch analytics and drift monitoring (the Spark/notebook-cluster analog);
the port of ccfd_tpu/analytics."""

from ccfd_tpu_torch.analytics.engine import (  # noqa: F401
    AnalyticsEngine,
    DriftMonitor,
    Report,
    psi,
)
