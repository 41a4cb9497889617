"""The MLP kernel's share of its roofline in %: the least time of the window's launches (benchmark/roofline.py) over the time of the scorer's kernel (the program's kernel name) in the device trace."""
from benchmark.harness import readings


def read(r):
    return readings.roofline_pct(r)
