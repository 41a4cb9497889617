"""The device's own record of the window: one device-only
``torch.profiler`` trace (``activities=[CUDA]``, as the port's
``chip_smoke.py`` takes its demo trace), reduced to intervals.

Every device event (kernels, copies, sets) becomes ``(name, start, end)``
in the host's wall clock, clipped to the window. ``busy_s`` is the length
of their union; a kernel's time is the sum of its launches' durations.
"""
from __future__ import annotations

import time
from collections import defaultdict

COPY_PREFIXES = ("Memcpy", "Memset")
NAME_CHARS = 160  # a templated kernel's name is cut to this many characters


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    """Start before the window, stop after it, then ``clip(t0, t1)``."""

    def __init__(self, cuda: bool = True) -> None:
        # without a card (the CPU tests) the profiler records host events
        # only, and the device's record is empty
        self.cuda = cuda
        self.prof = None
        self.events: list[tuple[str, float, float]] = []
        self.t0 = self.t1 = 0.0
        self.note = ""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self._enter_ns = time.time_ns()
        self.prof.__enter__()  # takes seconds on the card
        self._entered_ns = time.time_ns()

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)
        self.events = self._events()

    def _events(self) -> list[tuple[str, float, float]]:
        kr = self.prof.profiler.kineto_results
        start_ns = kr.trace_start_ns()
        # kineto stamps in Unix time, its start inside the profiler's start;
        # where it does not, its start is aligned with the host clock's
        same = self._enter_ns - 1e9 <= start_ns <= self._entered_ns + 1e9
        off = 0 if same else self._enter_ns - start_ns
        self.note = (f"the profiler took {(self._entered_ns - self._enter_ns) / 1e9:.3f} s "
                     f"to start; its clock {'is the host wall clock' if same else 'aligned'}")
        out = []
        for e in kr.events():
            if str(e.device_type()).endswith("CUDA"):
                a = (e.start_ns() + off) / 1e9
                out.append((e.name(), a, a + e.duration_ns() / 1e9))
        return out

    def clip(self, t0: float, t1: float) -> None:
        self.t0, self.t1 = t0, t1
        self.events = [(n, max(a, t0), min(b, t1)) for n, a, b in self.events
                       if b > t0 and a < t1]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def kernels(self) -> list[tuple[str, float, float]]:
        return [e for e in self.events if not e[0].startswith(COPY_PREFIXES)]

    def busy(self) -> list[tuple[float, float]]:
        return union([(a, b) for _, a, b in self.events])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_s(self, name: str) -> float:
        """The summed time of the kernels whose name holds ``name``."""
        return sum(b - a for n, a, b in self.kernels if name in n)

    def top_ops(self, n: int = 10) -> list[list]:
        tot: dict[str, float] = defaultdict(float)
        for name, a, b in self.events:
            tot[name] += b - a
        return [[k[:NAME_CHARS], v]
                for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self) -> list[tuple[float, float]]:
        """The device's idle intervals within the window, longest first."""
        gaps, t = [], self.t0
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return sorted(gaps, key=lambda g: g[0] - g[1])
