"""The model operations of the rows answered in the window over the window at the chip's peak for the configuration's dtype, in %."""
from benchmark.harness import readings


def read(r):
    return readings.mfu_pct(r)
