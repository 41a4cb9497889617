"""The program's own spans and counters in a traced run, read against the
device's trace: the spans ``serve``'s REST path records when its
``PredictionServer`` has a tracer (an ``observability/trace.py``
``SpanRecorder`` on it, armed for the collector's pauses). Spans come as
the recorder gives them, with ``start`` and ``end`` on the host's wall
clock, the device trace's clock.

Each reader returns None where it finds nothing to read.
"""
from __future__ import annotations

from bisect import bisect_right

from benchmark.harness.devtrace import union

# an idle instant of the device is named for the first of these spans that
# covers it: the collector, the Scorer's own steps (host work before the
# device's before the wait on it), the reply, requests waiting for a taker,
# a taker waiting for requests
GAP_ORDER = ("host.gc", "scorer.prep", "scorer.launch", "scorer.readback", "scorer.wait",
             "front.respond", "front.queue", "front.take_wait")
NONE = "(none)"
HOST_STEPS = ("scorer.prep", "scorer.launch", "scorer.readback")


def in_window(spans: list[dict], t0: float, t1: float) -> list[dict]:
    """The spans that end in the window ``[t0, t1)``."""
    return [s for s in spans if t0 <= s["end"] < t1]


def _named(spans: list[dict], name: str) -> list[dict]:
    return [s for s in spans if s["name"] == name]


def front_queue_ms(spans: list[dict], t0: float, t1: float) -> float | None:
    """The row-weighted mean wait from the C++ enqueue to the take, in ms,
    over the takes that returned in the window (each ``front.queue`` span
    weighed by the rows of its ``serve.take``)."""
    rows = {s["span_id"]: s["attrs"]["rows"] for s in _named(spans, "serve.take")}
    num = den = 0.0
    for q in _named(in_window(spans, t0, t1), "front.queue"):
        n = rows.get(q["parent_id"])
        if n:
            num += q["attrs"]["wait_ms"] * n
            den += n
    return num / den if den else None


def _self_s(span: dict, children: list[dict]) -> float:
    """``span``'s duration less the part its children cover."""
    a, b = span["start"], span["end"]
    covered = union([(max(a, c["start"]), min(b, c["end"])) for c in children
                     if c["end"] > a and c["start"] < b])
    return (b - a) - sum(y - x for x, y in covered)


def _per_dispatch_us(spans: list[dict], names: tuple, t0: float, t1: float) -> float | None:
    win = in_window(spans, t0, t1)
    dispatches = len(_named(win, "scorer.launch"))
    if not dispatches:
        return None
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)
    total = sum(_self_s(s, kids.get(s["span_id"], [])) for s in win if s["name"] in names)
    return total * 1e6 / dispatches


def scorer_host_us_per_dispatch(spans: list[dict], t0: float, t1: float) -> float | None:
    """The self time of the Scorer's host steps (``scorer.prep``,
    ``scorer.launch``, ``scorer.readback``) per dispatch, in µs."""
    return _per_dispatch_us(spans, HOST_STEPS, t0, t1)


def scorer_wait_us_per_dispatch(spans: list[dict], t0: float, t1: float) -> float | None:
    """``scorer.wait`` per dispatch, in µs: the host blocked on the device's
    round trip."""
    return _per_dispatch_us(spans, ("scorer.wait",), t0, t1)


def scorer_steps_us(spans: list[dict], t0: float, t1: float) -> dict | None:
    """For each of the Scorer's steps, its wall time and its thread's CPU
    time (the ``cpu_us`` attr) per dispatch, in µs: where a step's wall
    time is not its CPU time, its thread was waiting (for the interpreter
    lock, a CUDA call or the device). A thread CPU clock may step by a
    scheduler tick (10 ms on the card's host): each span's reading is then
    0 or a tick, and only the mean over a window's dispatches holds."""
    win = in_window(spans, t0, t1)
    dispatches = len(_named(win, "scorer.launch"))
    if not dispatches:
        return None
    out = {}
    for name in (*HOST_STEPS, "scorer.wait"):
        got = _named(win, name)
        out[name] = {"wall": sum(s["end"] - s["start"] for s in got) * 1e6 / dispatches,
                     "cpu": sum(s["attrs"].get("cpu_us", 0.0) for s in got) / dispatches}
    return out


def useful_rows_pct(spans: list[dict], t0: float, t1: float) -> float | None:
    """The rows handed to the Scorer over the bucket rows it launched for
    them, in %: the ``rows`` and ``bucket`` attrs of the ``scorer.launch``
    spans in the window."""
    launches = _named(in_window(spans, t0, t1), "scorer.launch")
    launched = sum(s["attrs"]["bucket"] for s in launches)
    return 100.0 * sum(s["attrs"]["rows"] for s in launches) / launched if launched else None


def _clipped(spans: list[dict], name: str, t0: float, t1: float) -> list[tuple]:
    return union([(max(s["start"], t0), min(s["end"], t1)) for s in spans
                  if s["name"] == name and s["end"] > t0 and s["start"] < t1])


def gc_pct(spans: list[dict], t0: float, t1: float) -> float | None:
    """The union of the collector's pauses (``host.gc``, recorded while the
    recorder is armed) in the window over the window, in %."""
    if t1 <= t0 or not spans:
        return None
    return 100.0 * sum(b - a for a, b in _clipped(spans, "host.gc", t0, t1)) / (t1 - t0)


def _overlap(ivs: list[tuple], starts: list[float], a: float, b: float) -> list[tuple]:
    """The parts of the sorted disjoint ``ivs`` inside ``[a, b]``."""
    i = max(0, bisect_right(starts, a) - 1)
    out = []
    while i < len(ivs) and ivs[i][0] < b:
        x, y = max(ivs[i][0], a), min(ivs[i][1], b)
        if y > x:
            out.append((x, y))
        i += 1
    return out


class GapNamer:
    """Names the device's idle time by the spans over it, in
    :data:`GAP_ORDER`: each instant counts once, for the first name whose
    spans cover it."""

    def __init__(self, spans: list[dict], t0: float, t1: float):
        self._ivs = {n: _clipped(spans, n, t0, t1) for n in GAP_ORDER}
        self._starts = {n: [a for a, _ in v] for n, v in self._ivs.items()}

    def cover(self, a: float, b: float) -> dict[str, float]:
        """Seconds of ``[a, b]`` counted for each name, and for
        :data:`NONE` what no span covers."""
        left = [(a, b)]
        out = dict.fromkeys(GAP_ORDER, 0.0)
        for n in GAP_ORDER:
            rest = []
            for x, y in left:
                got = _overlap(self._ivs[n], self._starts[n], x, y)
                out[n] += sum(q - p for p, q in got)
                t = x
                for p, q in got:
                    if p > t:
                        rest.append((t, p))
                    t = q
                if y > t:
                    rest.append((t, y))
            left = rest
        out[NONE] = sum(y - x for x, y in left)
        return out

    def name(self, a: float, b: float) -> str:
        """The name that covers most of ``[a, b]``; :data:`NONE` where no
        span covers any of it."""
        c = self.cover(a, b)
        best = max(GAP_ORDER, key=lambda n: c[n])
        return best if c[best] > 0 else NONE

    def shares(self, gaps: list[tuple]) -> dict[str, float]:
        """Each name's share of the idle time in ``gaps``, in %."""
        tot: dict[str, float] = {}
        for a, b in gaps:
            for n, s in self.cover(a, b).items():
                tot[n] = tot.get(n, 0.0) + s
        idle = sum(b - a for a, b in gaps)
        return {n: 100.0 * s / idle for n, s in tot.items() if s > 0} if idle else {}
