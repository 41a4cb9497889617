"""The span recorder's clock against the card's (marker ``cuda``).

A kernel launched inside a recorded span, and waited for there, lies inside
that span on the benchmark's device trace (``benchmark/harness/devtrace.py``:
a device-only ``torch.profiler`` trace on the host's wall clock), to within
0.5 ms, after the span's CLOCK_MONOTONIC stamps are put on the wall clock
(``observability/trace.py``'s one offset). The trace's own note must say
its clock is the host wall clock: an aligned trace is not the clock the
spans are read against. Skips without a card (decided in the fixture); on
the card:

    python -m pytest --noconftest -m cuda tests/test_torch_trace_cuda.py
"""

import time

import pytest
import torch

from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.observability.trace import SpanRecorder, Tracer

pytestmark = pytest.mark.cuda

SLACK_S = 0.5e-3
CYCLES = 4_000_000  # ~2-3 ms of torch.cuda._sleep at the card's clocks


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the device trace records a card's kernels)")
    d = torch.device("cuda:0")
    torch.cuda._sleep(1000)  # the context and the sleep kernel, before any span
    torch.cuda.synchronize(d)
    return d


def test_a_kernel_inside_a_span_lies_inside_it_on_the_device_trace(dev):
    from benchmark.harness.devtrace import DeviceTrace

    rec = SpanRecorder()
    tracer = Tracer(Registry(), "test", sink=rec)
    trace = DeviceTrace(cuda=True)
    trace.start()
    for i in range(5):
        with tracer.span(f"sleep{i}"):
            torch.cuda._sleep(CYCLES)
            torch.cuda.synchronize(dev)
        time.sleep(0.01)
    trace.stop()
    spans = rec.spans()
    trace.clip(spans[0]["start"] - 1.0, spans[-1]["end"] + 1.0)
    assert "is the host wall clock" in trace.note, trace.note
    kernels = sorted(trace.kernels, key=lambda e: e[1])
    assert len(kernels) == len(spans) == 5, kernels
    for (name, a, b), s in zip(kernels, spans):
        assert b - a > 1e-3, (name, b - a)  # the sleep itself, not a stray kernel
        assert s["start"] - SLACK_S <= a and b <= s["end"] + SLACK_S, (
            f"{name}: kernel {a:.6f}-{b:.6f}, span {s['start']:.6f}-{s['end']:.6f}")
