"""The model operations of the records decided on the device in the window, each on its full history, over the window at the chip's bf16 peak, in %."""
from benchmark.harness import readings


def read(r):
    return readings.seq_mfu_pct(r)
