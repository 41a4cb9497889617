"""The seq scorer's host-side history assembly a router batch (prepare, L/B bucketing, padding), from the window's seq_assembly_seconds histogram, in ms."""
from benchmark.harness import readings


def read(r):
    return readings.assembly_ms_per_batch(r)
