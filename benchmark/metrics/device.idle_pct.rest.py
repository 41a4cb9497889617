"""The share of the window in which no kernel or copy ran on the device, in %."""
from benchmark.harness import readings


def read(r):
    return readings.idle_pct(r)
