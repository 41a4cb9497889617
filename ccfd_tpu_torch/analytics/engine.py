"""Batch analytics on the card: the Spark / notebook-cluster analog.

The port of ccfd_tpu/analytics/engine.py. A dataset summary is two device
passes over the feature matrix: the first reduces the moments, extrema,
the feature Gram matrix and the per-class aggregates; the second counts
each feature's rows into ``nbins`` linear bins once the extrema fix the
edges. The reference runs both as jitted XLA programs over rows sharded on
its mesh's data axis; here they are torch functions, on one device or,
with ``mesh=`` (parallel/mesh.py), once a data shard: the rows split into
contiguous slices over the data axis, each shard runs both passes on its
device, and the shards' partial results are reduced in shard order (sums
added in float32, extrema by min and max, counts added exactly). The
rounding points are the reference's:

- sums, squares and the per-class amount in float32;
- the Gram matrix a full-float32 product with TF32 off (the reference's
  ``Precision.HIGHEST``), a plain ``torch.matmul`` as the reference's is a
  plain XLA product outside any Pallas kernel;
- the histogram and class counts exact integers (``bincount`` in place of
  the reference's (N, F, nbins) one-hot sum, which gives the same counts),
  reported as float32 as the reference's are.

The finishing arithmetic (mean, variance, correlation, bin edges) is the
reference's numpy on the host.

- ``AnalyticsEngine.summarize``: per-feature mean/std/min/max and
  histograms, class balance, per-class amount sums, the correlation matrix.
- ``AnalyticsEngine.drift``: per-feature population stability index of a
  serving window against a reference :class:`Report`.
- :class:`DriftMonitor`: a supervised service consuming the live
  transaction topic in its own consumer group and exporting PSI gauges,
  its reference distribution persisted across restarts
  (``reference_path``, the reference's npz keys, so either package reads
  the other's file).

``analytics_workers`` reports the mesh's size (1 without a mesh).
"""

from __future__ import annotations

import io
import logging
import os
import threading
import time
import zipfile
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES, NUM_FEATURES
from ccfd_tpu_torch.device import resolve
from ccfd_tpu_torch.runtime.durability import CorruptArtifactError, read_artifact, write_artifact

DEFAULT_NBINS = 32
_EPS = 1e-6
_REPORT_KEYS = ("mean", "std", "min", "max", "hist", "edges", "corr", "class_counts",
                "amount_sum_by_class")


class Report(NamedTuple):
    """The output of one summarize job (every array host numpy)."""

    n: int
    mean: np.ndarray          # (F,)
    std: np.ndarray           # (F,)
    min: np.ndarray           # (F,)
    max: np.ndarray           # (F,)
    hist: np.ndarray          # (F, nbins) counts
    edges: np.ndarray         # (F, nbins + 1) bin edges
    corr: np.ndarray          # (F, F) Pearson correlation
    class_counts: np.ndarray  # (2,) rows per Class label
    amount_sum_by_class: np.ndarray  # (2,)

    def save(self, path: str) -> str:
        """Persist the report (one .npz through ``write_artifact``: framed,
        atomic, generations retained) so a PSI baseline survives restarts."""
        buf = io.BytesIO()
        np.savez(buf, n=np.int64(self.n),
                 **{k: np.asarray(getattr(self, k)) for k in _REPORT_KEYS})
        write_artifact(path, buf.getvalue(), artifact="drift_reference")
        return path

    @staticmethod
    def load(path: str) -> "Report":
        """Verified read: a corrupt reference is quarantined and the newest
        retained generation that verifies loads."""
        data = np.load(io.BytesIO(read_artifact(path, artifact="drift_reference")))
        return Report(n=int(data["n"]), **{k: data[k] for k in _REPORT_KEYS})

    def to_dict(self) -> dict[str, Any]:
        n1 = float(max(self.class_counts[1], 0.0))
        return {
            "rows": self.n,
            "fraud_rate": n1 / max(self.n, 1),
            "class_counts": self.class_counts.tolist(),
            "amount_mean_by_class": [
                float(s / max(c, 1.0))
                for s, c in zip(self.amount_sum_by_class, self.class_counts)
            ],
            "features": {
                name: {"mean": float(self.mean[i]), "std": float(self.std[i]),
                       "min": float(self.min[i]), "max": float(self.max[i])}
                for i, name in enumerate(FEATURE_NAMES)
            },
        }


def _gram(x: torch.Tensor) -> torch.Tensor:
    """x^T x in full float32: TF32 is switched off for the product (the
    reference's ``Precision.HIGHEST``) and the setting restored."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x.T @ x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def moments_job(x: torch.Tensor, y: torch.Tensor) -> dict[str, torch.Tensor]:
    """The first pass: sums, squares, extrema, the Gram matrix and the
    per-class row counts and amount sums of (N, F) float32 rows ``x`` with
    labels ``y`` (N,), on their device."""
    fraud = y > 0
    y1 = fraud.to(torch.float32)
    y0 = 1.0 - y1
    amount = x[:, NUM_FEATURES - 1]
    counts = torch.bincount(fraud.to(torch.int64), minlength=2)
    return {
        "n": torch.tensor(x.shape[0], dtype=torch.int64),
        "sum": x.sum(dim=0),
        "sumsq": (x * x).sum(dim=0),
        "min": x.amin(dim=0),
        "max": x.amax(dim=0),
        "gram": _gram(x),
        "class_counts": counts[[0, 1]],
        "amount_sum_by_class": torch.stack([(y0 * amount).sum(), (y1 * amount).sum()]),
    }


def hist_job(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, nbins: int) -> torch.Tensor:
    """The second pass: (F, nbins) int64 counts of each feature's rows in
    ``nbins`` linear bins over [lo, hi), the reference's float32 binning
    (a row below ``lo`` counts in the first bin, one at or past ``hi`` in
    the last)."""
    n, f = x.shape
    width = torch.clamp(hi - lo, min=_EPS)
    idx = torch.clamp(torch.floor((x - lo[None, :]) / width[None, :] * nbins).to(torch.int32),
                      0, nbins - 1)
    flat = (idx.to(torch.int64) + torch.arange(f, device=x.device)[None, :] * nbins).reshape(-1)
    return torch.bincount(flat, minlength=f * nbins).reshape(f, nbins)


def psi(p_hist: np.ndarray, q_hist: np.ndarray) -> np.ndarray:
    """Population stability index per feature between two (F, B)
    histograms (PSI < 0.1 stable, 0.1-0.25 drifting, > 0.25 action needed);
    counts are eps-smoothed so an empty bin does not blow up the log."""
    p = np.asarray(p_hist, np.float64) + _EPS
    q = np.asarray(q_hist, np.float64) + _EPS
    p /= p.sum(axis=-1, keepdims=True)
    q /= q.sum(axis=-1, keepdims=True)
    return np.sum((p - q) * np.log(p / q), axis=-1)


def _reduce(parts: list[dict[str, torch.Tensor]], home: torch.device) -> dict[str, torch.Tensor]:
    """The data shards' first-pass results combined, in shard order."""
    out = {k: v.to(home) for k, v in parts[0].items()}
    for part in parts[1:]:
        for k, v in part.items():
            v = v.to(home)
            if k == "min":
                out[k] = torch.minimum(out[k], v)
            elif k == "max":
                out[k] = torch.maximum(out[k], v)
            else:
                out[k] = out[k] + v
    return out


class AnalyticsEngine:
    """Batch analytics over CCFD feature matrices on one device (the card
    unless ``device`` names the CPU) or over a mesh's data shards."""

    def __init__(self, device: "str | torch.device | None" = None,
                 nbins: int = DEFAULT_NBINS, registry=None, mesh: Any = None):
        self.mesh = mesh
        self._shards: list[torch.device] = []
        if mesh is not None:
            from ccfd_tpu_torch.parallel.mesh import DATA_AXIS

            self._shards = [mesh.devices[p] for p in mesh.along(DATA_AXIS)]
            if device is not None and torch.device(device).type != self._shards[0].type:
                raise ValueError(f"device={device!r} but the mesh's shards lie on "
                                 f"{self._shards[0]}")
            device = self._shards[0]
        self.device = resolve(device)
        self.nbins = int(nbins)
        self._c_jobs = self._h_job_s = self._c_rows = None
        if registry is not None:
            self._c_jobs = registry.counter("analytics_jobs_completed_total",
                                            "batch analytics jobs run")
            self._h_job_s = registry.histogram("analytics_job_seconds",
                                               "analytics job wall time")
            self._c_rows = registry.counter("analytics_rows_processed_total",
                                            "rows aggregated")
            registry.gauge("analytics_workers", "devices in the analytics mesh").set(
                mesh.size if mesh is not None else 1)

    def _account(self, job: str, n_rows: int, t0: float) -> None:
        if self._c_jobs is not None:
            self._c_jobs.inc(labels={"job": job})
            self._h_job_s.observe(time.perf_counter() - t0)
            self._c_rows.inc(n_rows)

    def _rows(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def _split(self, x: np.ndarray) -> list[torch.Tensor]:
        """The rows on the device, or one contiguous slice a data shard."""
        if self.mesh is None:
            return [self._rows(x)]
        return [torch.from_numpy(np.ascontiguousarray(part, np.float32)).to(dev)
                for part, dev in zip(np.array_split(np.asarray(x), len(self._shards)),
                                     self._shards)]

    def _hist(self, xds: list[torch.Tensor], lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        counts = None
        for xd in xds:
            c = hist_job(xd, torch.from_numpy(np.asarray(lo, np.float32)).to(xd.device),
                         torch.from_numpy(np.asarray(hi, np.float32)).to(xd.device),
                         self.nbins).to(self.device)
            counts = c if counts is None else counts + c
        return counts.cpu().numpy().astype(np.float32)

    # -- jobs --------------------------------------------------------------
    def summarize(self, x: np.ndarray, y: np.ndarray | None = None) -> Report:
        t0 = time.perf_counter()
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if y is None:
            y = np.zeros(n, np.int32)
        xds = self._split(x)
        yds = [torch.from_numpy(np.ascontiguousarray(part, np.int64)).to(xd.device)
               for part, xd in zip(np.array_split(np.asarray(y), len(xds)), xds)]
        parts = [moments_job(xd, yd) for xd, yd in zip(xds, yds) if xd.shape[0]]
        mom = {k: v.cpu().numpy() for k, v in _reduce(parts, self.device).items()}
        nf = max(float(mom["n"]), 1.0)
        mean = mom["sum"] / nf
        var = np.maximum(mom["sumsq"] / nf - mean**2, 0.0)
        std = np.sqrt(var)
        lo, hi = mom["min"], mom["max"]
        hist = self._hist(xds, lo, hi)
        edges = lo[:, None] + (hi - lo)[:, None] * np.linspace(
            0.0, 1.0, self.nbins + 1)[None, :].astype(np.float32)
        cov = mom["gram"] / nf - np.outer(mean, mean)
        corr = cov / np.maximum(np.outer(std, std), _EPS)
        np.fill_diagonal(corr, 1.0)
        self._account("summarize", n, t0)
        return Report(
            n=int(mom["n"]), mean=mean, std=std, min=lo, max=hi, hist=hist,
            edges=edges.astype(np.float32), corr=corr,
            class_counts=mom["class_counts"].astype(np.float32),
            amount_sum_by_class=mom["amount_sum_by_class"])

    def window_hist(self, reference: Report, x: np.ndarray) -> np.ndarray:
        """Histogram a serving window on the reference's bin edges."""
        return self._hist(self._split(x), reference.min, reference.max)

    def drift(self, reference: Report, x: np.ndarray) -> np.ndarray:
        """Per-feature PSI of a serving window against the reference."""
        t0 = time.perf_counter()
        scores = psi(self.window_hist(reference, x), reference.hist)
        self._account("drift", int(np.asarray(x).shape[0]), t0)
        return scores


class DriftMonitor:
    """Supervised service: live-topic windows scored for drift against the
    training distribution.

    Subscribes to the transaction topic in its own consumer group (beside
    the router's), accumulates windows of rows decoded by the router's own
    decoder, and on each full window exports per-feature PSI gauges. The
    reference distribution comes from ``reference``, a readable
    ``reference_path`` (a file with another binning is ignored), or
    ``reference_builder`` on the service's own thread (then saved to
    ``reference_path``)."""

    def __init__(
        self,
        cfg: Config,
        broker,
        reference: Report | None,
        engine: AnalyticsEngine | None = None,
        registry=None,
        window: int = 4096,
        reference_builder: Callable[[], Report] | None = None,
        reference_path: str | None = None,
    ):
        self.cfg = cfg
        self.engine = engine if engine is not None else AnalyticsEngine(registry=registry)
        self.reference = reference
        self.reference_path = reference_path
        if reference is None and reference_path and os.path.exists(reference_path):
            try:
                loaded = Report.load(reference_path)
                if loaded.hist.shape[1] == self.engine.nbins:
                    self.reference = loaded
            # a truncated archive (BadZipFile), an empty file (EOFError) or
            # no verifiable generation (CorruptArtifactError): rebuild
            except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile,
                    CorruptArtifactError) as e:
                logging.getLogger(__name__).warning(
                    "drift reference %s unreadable (%r); rebuilding", reference_path, e)
        if self.reference is None and reference_builder is None:
            raise ValueError("need a reference Report, a readable "
                             "reference_path, or a reference_builder")
        self._reference_builder = reference_builder
        self.window = int(window)
        self._broker = broker
        self._group = "ccfd-analytics"
        self._topic = cfg.kafka_topic
        self._consumer = broker.consumer(self._group, (self._topic,))
        self._consumer_closed = False
        self._buf: list[np.ndarray] = []
        self._buffered = 0
        self._stop = threading.Event()
        self.windows_scored = 0
        self._g_psi = self._g_max = None
        if registry is not None:
            self._g_psi = registry.gauge("analytics_drift_psi",
                                         "per-feature PSI vs training distribution")
            self._g_max = registry.gauge("analytics_drift_max_psi", "worst-feature PSI")

    def step(self, poll_timeout_s: float = 0.0) -> int:
        """Consume one poll; score a window when one fills. Returns rows seen."""
        if self.reference is None:
            self.reference = self._reference_builder()
            if self.reference_path:
                try:
                    self.reference.save(self.reference_path)
                except OSError:
                    logging.getLogger(__name__).exception(
                        "drift reference save to %s failed; the baseline will NOT "
                        "survive a restart", self.reference_path)
        records = self._consumer.poll(self.window, poll_timeout_s)
        if not records:
            return 0
        from ccfd_tpu_torch.router.router import decode_records

        rows, _, _ = decode_records(records)
        if rows.shape[0]:
            self._buf.append(rows)
            self._buffered += rows.shape[0]
        while self._buffered >= self.window:
            allrows = np.concatenate(self._buf, axis=0)
            win, rest = allrows[: self.window], allrows[self.window:]
            self._buf = [rest] if rest.shape[0] else []
            self._buffered = rest.shape[0]
            scores = self.engine.drift(self.reference, win)
            self.windows_scored += 1
            if self._g_psi is not None:
                for i, name in enumerate(FEATURE_NAMES):
                    self._g_psi.set(float(scores[i]), labels={"feature": name})
                self._g_max.set(float(scores.max()))
        return int(rows.shape[0])

    def reset(self) -> None:
        """Re-arm after stop(); stop() closed the consumer, so re-subscribe:
        the group's committed offsets resume where the old one left off."""
        self._stop.clear()
        if self._consumer_closed:
            self._consumer = self._broker.consumer(self._group, (self._topic,))
            self._consumer_closed = False

    def run(self, interval_s: float = 0.25) -> None:
        while not self._stop.is_set():
            if self.step(poll_timeout_s=interval_s) == 0:
                self._stop.wait(interval_s)

    def stop(self) -> None:
        self._stop.set()
        self._consumer.close()
        self._consumer_closed = True
