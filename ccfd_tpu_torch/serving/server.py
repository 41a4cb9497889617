"""REST serving layer with the Seldon wire contract, backed by the port's
scorer. The port of ccfd_tpu/serving/server.py's ``PredictionServer``.

- ``POST /api/v0.1/predictions`` — the Seldon REST contract. Request:
  ``{"data": {"names": [...], "ndarray": [[...], ...]}}``; the response
  mirrors the shape with ``names: ["proba_0", "proba_1"]`` and one
  probability row per input row.
- ``POST /predict`` — the jBPM prediction-service endpoint.
- Bearer-token auth when ``SELDON_TOKEN`` is configured.
- ``GET /prometheus`` (and ``/metrics``) —
  ``seldon_api_executor_client_requests_seconds_{count,sum,bucket}``, the
  status-coded request counter, the per-request gauges
  ``proba_1``/``Amount``/``V17``/``V10``, the batcher's dispatch counters
  and ``ccfd_kernel_launches{kernel=...}``, the process's launches of each
  CUDA kernel.
- ``GET /health/status`` — Seldon-style readiness.
- Overload admission (CCFD_OVERLOAD, on by default, as in the reference):
  each predict reserves its rows against an adaptive serving budget
  (``runtime/overload.py::AdmissionGate``) by the priority in its
  ``x-ccfd-priority`` header (bulk refused at 50% utilization, normal at
  90%, critical at 100%); a refusal answers 429 with ``Retry-After``,
  counted in ``ccfd_admission_total`` and ``ccfd_shed_total``. The
  batcher's CoDel and bounded priority queue are not ported.
- A ``ScorerTimeout`` (the Scorer's dispatch deadline expired, or the
  device is still marked wedged) answers 503, as in the reference.
  ``DeadlineCounters`` folds the Scorer's ``dispatch_timeouts`` into
  ``ccfd_dispatch_timeouts_total`` at scrape time, beside the
  ``ccfd_device_wedged`` gauge; both read 0 unless CCFD_DISPATCH_DEADLINE_MS
  arms the deadline (config.py).

Decode: the canonical payload's matrix parses natively
(``native.decode_ndarray_json``, C++ strtof straight into float32); a
``names`` key, ragged or non-numeric rows, bad JSON and oversize bodies
bail to ``json.loads``, with the same status codes.

Transport: the C++ epoll front (``serving/native_front.py``) when
``cfg.native_front`` is on (CCFD_NATIVE_FRONT, default 1, as in the
reference), else the Python ``FastHTTPServer``. There is no silent
fallback: a front that cannot build or bind raises.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

import numpy as np

from ccfd_tpu_torch import native
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.ops import fused_mlp, fused_mlp_q8
from ccfd_tpu_torch.serving.batcher import DynamicBatcher
from ccfd_tpu_torch.serving.dispatch import ScorerTimeout
from ccfd_tpu_torch.serving.scorer import Scorer
from ccfd_tpu_torch.utils.fasthttp import FastHTTPServer

_AMOUNT_COL = FEATURE_NAMES.index("Amount")
_V17_COL = FEATURE_NAMES.index("V17")
_V10_COL = FEATURE_NAMES.index("V10")
# every CUDA kernel of the port, by its gauge label: B1, B2, B3
KERNEL_LAUNCHES = (fused_mlp.launches, fused_mlp_q8.launches,
                   fused_mlp_q8.launches_preq)


def publish_launches(gauge) -> None:
    """Set ``ccfd_kernel_launches{kernel=...}`` to each kernel's launches
    in this process (the REST server and the router role's exporter)."""
    for counter in KERNEL_LAUNCHES:
        gauge.set(counter.value, labels={"kernel": counter.kernel})


class DeadlineCounters:
    """The Scorer's dispatch deadline on a registry: its timeouts folded
    into ``ccfd_dispatch_timeouts_total`` at scrape time (``sync``), and the
    wedge flag as ``ccfd_device_wedged``. The serving process and the
    router role use it."""

    def __init__(self, registry: Registry, scorer: Scorer):
        self._scorer = scorer
        self._timeouts = registry.counter("ccfd_dispatch_timeouts_total",
                                          "device dispatches past the Scorer's deadline")
        self._timeouts.inc(0)  # rendered at 0 from the start
        self._wedged = registry.gauge("ccfd_device_wedged",
                                      "1 while the Scorer believes the device wedged")
        self._synced = 0
        self._lock = threading.Lock()  # concurrent scrapes fold each delta once

    def sync(self) -> None:
        with self._lock:
            n = self._scorer.dispatch_timeouts
            if n > self._synced:
                self._timeouts.inc(n - self._synced)
                self._synced = n
        self._wedged.set(1.0 if self._scorer.wedged else 0.0)


class PredictionServer:
    def __init__(
        self,
        scorer: Scorer,
        cfg: Config | None = None,
        registry: Registry | None = None,
        profiler=None,
    ):
        self.scorer = scorer
        # stage profiler (observability/profile.py): the batcher (Python
        # transport) and the native front's scorer threads feed the REST
        # path's rest.batcher / rest.dispatch stages
        self.profiler = profiler
        self.cfg = cfg or Config()
        self.registry = registry or Registry()
        r = self.registry
        self._h_latency = r.histogram(
            "seldon_api_executor_client_requests_seconds",
            "request latency by endpoint",
        )
        self._c_requests = r.counter(
            "seldon_api_executor_server_requests_total", "requests by code"
        )
        self._g_proba = r.gauge("proba_1", "last scored fraud probability")
        self._g_amount = r.gauge("Amount", "last scored transaction amount")
        self._g_v17 = r.gauge("V17", "last scored V17")
        self._g_v10 = r.gauge("V10", "last scored V10")
        self._g_launches = r.gauge(
            "ccfd_kernel_launches", "CUDA kernel launches in this process")
        self._g_dispatches = r.gauge(
            "ccfd_scorer_dispatches", "the Scorer's bucket dispatches in this process")
        self.deadline_counters = DeadlineCounters(r, scorer)
        self.admission = None
        if self.cfg.overload_enabled:
            from ccfd_tpu_torch.runtime.overload import AdmissionGate

            self.admission = AdmissionGate.from_config(
                self.cfg, r, max_rows=max(self.scorer.batch_sizes))
        self._httpd: Any = None  # the NativeFront or the FastHTTPServer
        # dynamic batching: concurrent requests coalesce into one dispatch;
        # the adaptive policy adds no latency for a lone sequential client
        self.batcher: DynamicBatcher | None = None
        if self.cfg.dynamic_batching:
            self._c_dispatches = r.counter(
                "serving_batcher_dispatches_total", "coalesced device dispatches"
            )
            self._c_batched_rows = r.counter(
                "serving_batcher_rows_total", "rows through the batcher"
            )
            self.batcher = self._make_batcher()

    def _make_batcher(self) -> DynamicBatcher:
        def on_dispatch(n_rows: int) -> None:
            self._c_dispatches.inc()
            self._c_batched_rows.inc(n_rows)

        return DynamicBatcher(
            self.scorer.score,
            max_batch=max(self.scorer.batch_sizes),
            deadline_ms=self.cfg.batch_deadline_ms,
            on_dispatch=on_dispatch,
            workers=self.cfg.batch_workers,
            profiler=self.profiler,
        )

    # -- scoring ----------------------------------------------------------
    def _score_matrix(self, x: np.ndarray) -> np.ndarray:
        if self.batcher is not None:
            proba = self.batcher.score(x)
        else:
            proba = self.scorer.score(x)
        if x.shape[0]:
            self._g_proba.set(float(proba[-1]))
            self._g_amount.set(float(x[-1, _AMOUNT_COL]))
            self._g_v17.set(float(x[-1, _V17_COL]))
            self._g_v10.set(float(x[-1, _V10_COL]))
        return np.asarray(proba, np.float64)

    @staticmethod
    def _response_dict(proba: np.ndarray, model: str) -> dict:
        return {
            "data": {
                "names": ["proba_0", "proba_1"],
                "ndarray": np.stack([1.0 - proba, proba], axis=1).tolist(),
            },
            "meta": {"model": model},
        }

    def predict_ndarray(self, names: list[str], rows: list[list[float]]) -> dict:
        proba = self._score_matrix(self.rows_matrix(names, rows))
        return self._response_dict(proba, self.scorer.spec.name)

    def rows_matrix(self, names: list[str], rows: list[list[float]]) -> np.ndarray:
        """The request's rows as an (n, F) float32 matrix in canonical
        feature order. Raises ``TypeError``/``ValueError`` for rows that do
        not convert: the client's fault, where a scoring error is not."""
        nf = self.scorer.num_features
        if names and names != list(FEATURE_NAMES):
            idx = {n: j for j, n in enumerate(FEATURE_NAMES)}
            x = np.zeros((len(rows), nf), np.float32)
            for i, row in enumerate(rows):
                for name, v in zip(names, row):
                    j = idx.get(name)
                    if j is not None:
                        x[i, j] = float(v)
        else:
            # uniform canonical-order rows convert in ONE numpy call; the
            # ragged/odd-width fallback keeps the lenient contract
            try:
                x = np.asarray(rows, np.float32)
            except ValueError:
                x = None
            if x is None or x.ndim != 2 or x.shape[1] != nf:
                x = np.zeros((len(rows), nf), np.float32)
                for i, row in enumerate(rows):
                    x[i, : len(row)] = np.asarray(row, np.float32)[:nf]
        return x

    # -- HTTP plumbing (FastHTTPServer handler contract) -------------------
    def _json(self, code: int, obj: Any) -> tuple[int, str, bytes]:
        self._c_requests.inc(labels={"code": str(code)})
        return code, "application/json", json.dumps(obj).encode()

    def _reject_overload(self, retry_after_s: float):
        """429 with the retry-after hint as a header and in the body."""
        self._c_requests.inc(labels={"code": "429"})
        body = json.dumps({"error": "overloaded",
                           "retry_after_s": round(float(retry_after_s), 3)}).encode()
        retry = str(max(1, int(-(-retry_after_s // 1))))  # ceil, >= 1 s
        return 429, "application/json", body, {"Retry-After": retry}

    def _authorized(self, headers: dict) -> bool:
        token = self.cfg.seldon_token
        if not token:
            return True
        auth = headers.get(b"authorization", b"").decode("latin-1")
        return auth == f"Bearer {token}"

    def _http_handler(
        self, method: str, path: str, headers: dict, body: bytes
    ) -> tuple[int, str, bytes]:
        if method == "GET":
            if path in ("/prometheus", "/metrics"):
                self._c_requests.inc(labels={"code": "200"})
                publish_launches(self._g_launches)
                self._g_dispatches.set(self.scorer.dispatch_total())
                self.deadline_counters.sync()
                return 200, "text/plain", self.registry.render().encode()
            if path in ("/health/status", "/health", "/healthz"):
                return self._json(
                    200, {"status": "ok", "model": self.scorer.spec.name}
                )
            return self._json(404, {"error": "not found"})
        if method != "POST":
            return self._json(405, {"error": "method not allowed"})

        t0 = time.perf_counter()
        if not self._authorized(headers):
            return self._json(401, {"error": "unauthorized"})
        path = path.rstrip("/")
        if not (path.endswith("/predictions") or path == "/predict"):
            return self._json(404, {"error": "not found"})
        # the canonical payload parses natively; anything unusual (a names
        # key, ragged or non-numeric rows, bad JSON) takes json.loads
        x = native.decode_ndarray_json(body, self.scorer.num_features)
        if x is None:
            try:
                payload = json.loads(body or b"{}")
            except ValueError:
                return self._json(400, {"error": "malformed JSON body"})
            data = payload.get("data", {}) if isinstance(payload, dict) else {}
            rows = data.get("ndarray") if isinstance(data, dict) else None
            if rows is None or not isinstance(rows, list):
                return self._json(400, {"error": "missing data.ndarray in request"})
            try:
                x = self.rows_matrix(data.get("names") or [], rows)
            except (TypeError, ValueError) as e:
                return self._json(400, {"error": f"bad ndarray: {e}"})
        gate = self.admission
        if gate is not None:
            from ccfd_tpu_torch.runtime.overload import parse_priority

            n_rows = x.shape[0]
            if not gate.try_admit(n_rows, parse_priority(headers.get(b"x-ccfd-priority"))):
                return self._reject_overload(gate.retry_after_s)
        t_sc = time.perf_counter()
        try:
            # a scorer or kernel error propagates: the transport answers 500
            proba = self._score_matrix(x)
        except ScorerTimeout as e:
            # the dispatch deadline expired or the device is wedged: a
            # bounded 503, not a hung request
            return self._json(503, {"error": f"scoring unavailable: {e}"})
        finally:
            if gate is not None:
                gate.release(n_rows)
        if gate is not None:
            gate.observe(time.perf_counter() - t_sc)
        out = self._response_dict(proba, self.scorer.spec.name)
        self._h_latency.observe(time.perf_counter() - t0, labels={"endpoint": path})
        return self._json(200, out)

    @property
    def transport(self) -> str:
        """The transport ``start`` selects: "native-front" or "python"."""
        return "native-front" if self.cfg.native_front else "python"

    def start(self, host: str | None = None, port: int | None = None) -> int:
        """Start serving on background threads; returns the bound port.
        The C++ front when ``cfg.native_front`` is on, else the Python
        server; a front that cannot build or bind raises."""
        if self.cfg.dynamic_batching and self.batcher is None:
            # stop() tears the batcher down; a restarted server needs a
            # fresh one or every predict would fail on the stopped worker
            self.batcher = self._make_batcher()
        host = host if host is not None else self.cfg.serve_host
        port = port if port is not None else self.cfg.serve_port
        if self.cfg.native_front:
            from ccfd_tpu_torch.serving.native_front import NativeFront

            front = NativeFront(self)
            bound = front.start(port, host=host)
            self._httpd = front
            return bound
        self._httpd = FastHTTPServer(
            (host, port), self._http_handler, name="ccfd-serving"
        ).start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.stop()
            self._httpd = None
        if self.batcher is not None:
            self.batcher.stop()
            self.batcher = None
