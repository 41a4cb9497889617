"""The router's batching on the stream: records decided on the device in the window per seq launch (SeqScorer.dispatch_total over the window)."""
from benchmark.harness import readings


def read(r):
    return readings.rows_per_dispatch(r)
