"""Minimal thread-safe Prometheus metrics with text exposition.

The port's copy of the reference's ccfd_tpu/metrics/prom.py, cut to what
the REST scorer and the decision pipeline use: Counter, Gauge and Histogram
with labels (read back with ``value``, ``count``, ``sum``, ``quantile``,
``count_le``/``total_count``/``total_count_le`` and ``Registry.get``;
``observe_many`` for a batch; the last exemplar per histogram cell), the
KIE board's ``AMOUNT_BUCKETS``, rendered in the Prometheus text format,
with no global state (each service owns a Registry). Each metric admits at
most ``labelset_limit`` distinct label sets; further ones fold into one
overflow series, counted in ``ccfd_metric_labelsets_dropped_total{metric=...}``.
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from typing import Iterable, Mapping, Sequence

import numpy as np

LabelKey = tuple[tuple[str, str], ...]

DEFAULT_LABELSET_LIMIT = 512
OVERFLOW_KEY: LabelKey = (("overflow", "true"),)
LABELSETS_DROPPED = "ccfd_metric_labelsets_dropped_total"


def _labelkey(labels: Mapping[str, str] | None) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str = "",
                 labelset_limit: int | None = None):
        self.name = name
        self.help = help_
        self.labelset_limit = (DEFAULT_LABELSET_LIMIT
                               if labelset_limit is None
                               else int(labelset_limit))
        self._lock = threading.Lock()
        self._on_overflow = None  # set by Registry

    def _admit(self, key: LabelKey, known: Mapping[LabelKey, object]) -> LabelKey:
        """Call under self._lock: the guarded key for a write. Existing
        series and the unlabeled series always pass; a NEW series past the
        limit folds into the overflow bucket."""
        if not key or key in known or len(known) < self.labelset_limit:
            return key
        if self._on_overflow is not None:
            self._on_overflow(self.name)
        return OVERFLOW_KEY

    def render(self) -> Iterable[str]:  # pragma: no cover - interface
        raise NotImplementedError


class _ScalarMetric(_Metric):
    """Shared labeled-scalar storage for Counter and Gauge."""

    def __init__(self, name: str, help_: str = "",
                 labelset_limit: int | None = None):
        super().__init__(name, help_, labelset_limit)
        self._values: dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, labels: Mapping[str, str] | None = None) -> None:
        key = _labelkey(labels)
        with self._lock:
            key = self._admit(key, self._values)
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, labels: Mapping[str, str] | None = None) -> float:
        with self._lock:
            return self._values.get(_labelkey(labels), 0.0)

    def total(self) -> float:
        """Sum across every label set."""
        with self._lock:
            return sum(self._values.values())

    def items(self) -> list[tuple[LabelKey, float]]:
        """Every (labelkey, value) pair (the stage profiler's overload
        section reads the in-flight gauges this way)."""
        with self._lock:
            return list(self._values.items())

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            yield f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}"


class Counter(_ScalarMetric):
    kind = "counter"

    def inc(self, amount: float = 1.0, labels: Mapping[str, str] | None = None) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        super().inc(amount, labels)


class Gauge(_ScalarMetric):
    kind = "gauge"

    def set(self, value: float, labels: Mapping[str, str] | None = None) -> None:
        key = _labelkey(labels)
        with self._lock:
            self._values[self._admit(key, self._values)] = float(value)


DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, math.inf,
)

# Amount histograms on the KIE board span transaction amounts, not seconds
AMOUNT_BUCKETS = (
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
    5000.0, 10000.0, math.inf,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labelset_limit: int | None = None,
    ):
        super().__init__(name, help_, labelset_limit)
        b = sorted(set(float(x) for x in buckets))
        if not b or b[-1] != math.inf:
            b.append(math.inf)
        self.buckets = tuple(b)
        self._counts: dict[LabelKey, list[int]] = {}
        self._sums: dict[LabelKey, float] = {}
        # last exemplar per (labelset, bucket): (labels, value, unix time)
        self._exemplars: dict[LabelKey, dict[int, tuple[dict, float, float]]] = {}

    def observe(self, value: float, labels: Mapping[str, str] | None = None,
                exemplar: Mapping[str, str] | None = None) -> None:
        key = _labelkey(labels)
        n = len(self.buckets)
        # the counts are cumulative: every bucket from the first that holds
        # the value on counts it (none for NaN)
        first = bisect_left(self.buckets, value) if value == value else n
        with self._lock:
            key = self._admit(key, self._counts)
            counts = self._counts.setdefault(key, [0] * n)
            for i in range(first, n):
                counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + float(value)
            if exemplar:
                self._exemplars.setdefault(key, {})[min(first, n - 1)] = (
                    dict(exemplar), float(value), time.time())

    def observe_many(self, values, labels: Mapping[str, str] | None = None) -> None:
        """Vectorized observe: one numpy pass per batch (the router observes
        every transaction of a micro-batch at once)."""
        arr = np.sort(np.asarray(values, dtype=np.float64))
        if arr.size == 0:
            return
        cums = [int(np.searchsorted(arr, ub, side="right")) if ub != math.inf
                else int(arr.size) for ub in self.buckets]
        key = _labelkey(labels)
        with self._lock:
            key = self._admit(key, self._counts)
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, c in enumerate(cums):
                counts[i] += c
            self._sums[key] = self._sums.get(key, 0.0) + float(arr.sum())

    def count(self, labels: Mapping[str, str] | None = None) -> int:
        with self._lock:
            counts = self._counts.get(_labelkey(labels))
            return counts[-1] if counts else 0

    def sum(self, labels: Mapping[str, str] | None = None) -> float:
        with self._lock:
            return self._sums.get(_labelkey(labels), 0.0)

    def count_le(self, value: float, labels: Mapping[str, str] | None = None) -> float:
        """Interpolated cumulative count of observations <= ``value``, the
        inverse of :meth:`quantile` (the SLO engine's good events)."""
        with self._lock:
            counts = list(self._counts.get(_labelkey(labels), []))
        return self._count_le_of(counts, value)

    def _count_le_of(self, counts: list, value: float) -> float:
        if not counts:
            return 0.0
        prev_ub, prev_c = 0.0, 0
        for ub, c in zip(self.buckets, counts):
            if value <= ub:
                if ub == math.inf:
                    return float(prev_c)
                span = ub - prev_ub
                frac = (value - prev_ub) / span if span > 0 else 1.0
                return prev_c + (c - prev_c) * frac
            prev_ub, prev_c = ub, c
        return float(counts[-1])

    def total_count(self) -> int:
        """Observation count summed across every label set."""
        with self._lock:
            return sum(c[-1] for c in self._counts.values())

    def total_count_le(self, value: float) -> float:
        """:meth:`count_le` summed across every label set."""
        with self._lock:
            all_counts = [list(c) for c in self._counts.values()]
        return sum(self._count_le_of(c, value) for c in all_counts)

    def exemplars(self, labels: Mapping[str, str] | None = None) -> dict:
        """bucket index -> (exemplar labels, value, unix time)."""
        with self._lock:
            return dict(self._exemplars.get(_labelkey(labels), {}))

    def quantile(self, q: float, labels: Mapping[str, str] | None = None) -> float:
        """Bucket-interpolated quantile (what histogram_quantile() computes)."""
        with self._lock:
            counts = list(self._counts.get(_labelkey(labels), []))
        if not counts or counts[-1] == 0:
            return float("nan")
        rank = q * counts[-1]
        prev_ub, prev_c = 0.0, 0
        for ub, c in zip(self.buckets, counts):
            if c >= rank:
                if ub == math.inf:
                    return prev_ub
                span = c - prev_c
                frac = (rank - prev_c) / span if span else 1.0
                return prev_ub + (ub - prev_ub) * frac
            prev_ub, prev_c = ub, c
        return prev_ub

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted((k, list(c)) for k, c in self._counts.items())
            sums = dict(self._sums)
        for key, counts in items:
            for ub, c in zip(self.buckets, counts):
                lk = key + (("le", _fmt_value(ub)),)
                yield f"{self.name}_bucket{_fmt_labels(tuple(sorted(lk)))} {c}"
            yield f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(sums.get(key, 0.0))}"
            yield f"{self.name}_count{_fmt_labels(key)} {counts[-1]}"


class Registry:
    """Per-service metric registry; renders the /prometheus scrape body."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._labelsets_dropped = Counter(
            LABELSETS_DROPPED,
            "new label-sets folded into the overflow bucket, by metric",
        )
        self._metrics[LABELSETS_DROPPED] = self._labelsets_dropped

    def _note_overflow(self, metric_name: str) -> None:
        self._labelsets_dropped.inc(labels={"metric": metric_name})

    def counter(self, name: str, help_: str = "",
                labelset_limit: int | None = None) -> Counter:
        return self._get_or_make(
            name, lambda: Counter(name, help_, labelset_limit), Counter)

    def gauge(self, name: str, help_: str = "",
              labelset_limit: int | None = None) -> Gauge:
        return self._get_or_make(
            name, lambda: Gauge(name, help_, labelset_limit), Gauge)

    def histogram(
        self, name: str, help_: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labelset_limit: int | None = None,
    ) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help_, buckets, labelset_limit),
            Histogram)

    def get(self, name: str) -> "_Metric | None":
        """A registered metric by name, or None (the SLO engine resolves its
        sources across registries this way)."""
        with self._lock:
            return self._metrics.get(name)

    def _get_or_make(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                m._on_overflow = self._note_overflow
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {m.kind}")
            return m

    def render(self) -> str:
        """Prometheus text exposition of every registered metric."""
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"
