"""The REST front's coalescing: rows answered in the window per scorer dispatch."""
from benchmark.harness import readings


def read(r):
    return readings.rows_per_dispatch(r)
