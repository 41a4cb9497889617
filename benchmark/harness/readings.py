"""What a run hands its readers: the end-to-end device metric and the
per-layer readers (``benchmark/metrics/``), and the arithmetic they share.
A reader returns None where it finds nothing to read; the harness then
leaves its metric out of the line.
"""
from __future__ import annotations

import dataclasses

from benchmark import roofline


@dataclasses.dataclass
class Readings:
    config: dict
    mix: dict
    t0: float                 # the window, host wall clock
    t1: float
    rows: int                 # rows answered in it
    dispatches: int           # the scorer's dispatches in it
    launches: list            # (wall time, rows, bucket) of each launch in it
    rows_per_s: float = 0.0   # rows answered a second of it, by the clients' clock
    trace: object = None      # harness.devtrace.DeviceTrace, clipped to the window
    kernel: str | None = None  # the scorer's kernel, as the program names it
    # a driver's own window readings for its readers, by name (a keyed
    # stream's: the seq launches a bucket, the history assembly's time)
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def roofline_pct(r: Readings) -> float | None:
    """The launches' least time over the time of the scorer's kernel, in %."""
    if r.trace is None or not r.launches or not r.kernel:
        return None
    kernel_s = r.trace.kernel_s(r.kernel)
    if kernel_s <= 0:
        return None
    return 100.0 * roofline.bound_s(r.config, [n for _, n, _ in r.launches]) / kernel_s


def mfu_pct(r: Readings) -> float | None:
    if not r.rows:
        return None
    return 100.0 * roofline.mfu(r.config, r.rows, r.window_s)


def idle_pct(r: Readings) -> float | None:
    if r.trace is None or not r.trace.events:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.window_s)


def device_ms_per_1k_rows(r: Readings) -> float | None:
    """The device's busy time (the union of its kernels and copies) in the
    window per 1,000 rows answered in it, in ms."""
    if r.trace is None or not r.trace.events or not r.rows:
        return None
    return r.trace.busy_s * 1e3 / (r.rows / 1e3)


def rows_per_dispatch(r: Readings) -> float | None:
    return r.rows / r.dispatches if r.dispatches else None


def seq_roofline_pct(r: Readings) -> float | None:
    """The window's seq launches' least time (``roofline_seq.py``) over the
    time of every kernel the card ran in it, in %."""
    from benchmark import roofline_seq

    launches = r.counters.get("seq_launches")
    if r.trace is None or not launches:
        return None
    kernel_s = sum(b - a for _, a, b in r.trace.kernels)
    if kernel_s <= 0:
        return None
    return 100.0 * roofline_seq.bound_s(r.config, launches) / kernel_s


def seq_mfu_pct(r: Readings) -> float | None:
    """The model operations of the decisions in the window, each over the
    store's full history, over the window at the chip's peak, in %."""
    from benchmark import roofline_seq

    if not r.rows:
        return None
    length = int(r.config["cr"]["scorer"]["history_length"])
    return 100.0 * roofline_seq.mfu(r.config, r.rows, length, r.window_s)


def assembly_ms_per_batch(r: Readings) -> float | None:
    """The history assembly's host time a router batch in the window, in ms."""
    n = r.counters.get("assembly_batches")
    return 1e3 * r.counters["assembly_s"] / n if n else None
