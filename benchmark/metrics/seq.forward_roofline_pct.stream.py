"""The seq forward's share of its roofline in %: the least time of the window's seq launches (benchmark/roofline_seq.py, by L bucket from seq_bucket_dispatch_total and seq_bucket_rows_total) over the time of every kernel in the device trace."""
from benchmark.harness import readings


def read(r):
    return readings.seq_roofline_pct(r)
