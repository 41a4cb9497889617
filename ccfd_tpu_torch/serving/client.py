"""HTTP client for a remote prediction server on the Seldon contract.

The port's copy of ccfd_tpu/serving/client.py: the router's remote scorer
when ``SELDON_URL`` is an http:// URL (a ``python -m ccfd_tpu_torch serve``
process, or any Seldon-contract server). ``SELDON_ENDPOINT`` is the path,
``SELDON_TOKEN`` the bearer token, ``SELDON_TIMEOUT`` (ms) the per-attempt
timeout, ``SELDON_POOL_SIZE`` the connection pool and ``CCFD_CLIENT_RETRIES``
the transport retries (exponential backoff with jitter). ``score`` is a
plain ``(B, 30) -> (B,)`` function, interchangeable with ``Scorer.score``.
An optional breaker refuses before dialing while its circuit is open; the
router's degradation ladder keeps its own breaker on this edge. An optional
``FaultInjector`` (``runtime/faults.py``, the router role's ``scorer`` edge
under CCFD_FAULTS) perturbs every attempt: its delay and error draws before
the POST, its corruption after the response, which then fails that attempt
as a transport error.
"""

from __future__ import annotations

import http.client
import json
import queue
import random
import sys
import time
import urllib.parse
from typing import Any

import numpy as np

from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.runtime.breaker import CircuitOpenError, backoff_s
from ccfd_tpu_torch.utils.httpclient import _NodelayHTTPConnection


class SeldonClient:
    def __init__(self, cfg: Config, breaker=None, faults=None, tracer=None):
        self.cfg = cfg
        self._tracer = tracer  # each POST an rpc.scorer span with traceparent
        u = urllib.parse.urlparse(cfg.seldon_url)
        if u.scheme not in ("http", ""):
            raise ValueError(f"unsupported scheme in SELDON_URL: {cfg.seldon_url!r}")
        self._host = u.hostname or "localhost"
        self._port = u.port or 80
        self._path = "/" + cfg.seldon_endpoint.lstrip("/")
        self._timeout = cfg.seldon_timeout_ms / 1000.0
        self._breaker = breaker
        self._faults = faults
        self._rng = random.Random(0)  # deterministic backoff jitter
        self._pool: "queue.Queue[http.client.HTTPConnection]" = queue.Queue()
        for _ in range(max(1, cfg.seldon_pool_size)):
            self._pool.put(self._connect())

    def _connect(self) -> http.client.HTTPConnection:
        return _NodelayHTTPConnection(self._host, self._port, timeout=self._timeout)

    def _request(self, body: dict[str, Any]) -> dict[str, Any]:
        """POST with the per-attempt timeout and bounded retries. Every
        attempt records one breaker outcome (an unrecorded one would leak a
        half-open probe slot)."""
        if self._breaker is not None and not self._breaker.allow():
            if self._tracer is not None:
                from ccfd_tpu_torch.observability.trace import current_context

                # flag the caller's trace, only when one is active
                if current_context() is not None:
                    with self._tracer.span("rpc.scorer", attrs={"breaker_open": True}):
                        pass
            raise CircuitOpenError("circuit open for the prediction server")
        span_cm = (self._tracer.span("rpc.scorer", attrs={"path": self._path})
                   if self._tracer is not None else None)
        span_entered = False
        conn = self._pool.get()
        try:
            payload = json.dumps(body)
            headers = {"Content-Type": "application/json"}
            if self.cfg.seldon_token:
                headers["Authorization"] = f"Bearer {self.cfg.seldon_token}"
            if span_cm is not None:
                from ccfd_tpu_torch.observability.trace import (
                    current_context,
                    format_traceparent,
                )

                span_cm.__enter__()
                span_entered = True
                headers["traceparent"] = format_traceparent(current_context())
            attempts = max(1, self.cfg.client_retries + 1)
            last_exc: Exception | None = None
            for attempt in range(attempts):
                t0 = time.monotonic()
                try:
                    corrupt = self._faults.before() if self._faults is not None else False
                    conn.request("POST", self._path, payload, headers)
                    resp = conn.getresponse()
                    data = resp.read()
                    if resp.status != 200:
                        if self._breaker is not None:
                            self._breaker.record_failure(time.monotonic() - t0)
                        raise RuntimeError(
                            f"prediction server returned {resp.status}: {data[:200]!r}")
                    try:
                        out = json.loads(data)
                        if self._faults is not None:
                            # InjectedFault is an OSError: the transport path
                            out = self._faults.after(out, corrupt)
                    except ValueError:
                        if self._breaker is not None:
                            self._breaker.record_failure(time.monotonic() - t0)
                        raise
                    if self._breaker is not None:
                        self._breaker.record_success(time.monotonic() - t0)
                    return out
                except (http.client.HTTPException, OSError) as e:
                    # a stale pooled connection or a server mid-restart
                    last_exc = e
                    if self._breaker is not None:
                        self._breaker.record_failure(time.monotonic() - t0)
                    conn.close()
                    if attempt < attempts - 1:
                        time.sleep(backoff_s(attempt, rng=self._rng))
                    conn = self._connect()
            raise ConnectionError(
                f"prediction server unreachable after {attempts} attempts") from last_exc
        finally:
            self._pool.put(conn)
            if span_entered:
                span_cm.__exit__(*sys.exc_info())

    def score(self, x: np.ndarray) -> np.ndarray:
        """(B, 30) -> (B,) proba_1 by POST <SELDON_URL>/<SELDON_ENDPOINT>."""
        x = np.asarray(x, np.float32)
        out = self._request({"data": {"names": list(FEATURE_NAMES), "ndarray": x.tolist()}})
        return np.asarray([row[1] for row in out["data"]["ndarray"]], np.float32)

    def close(self) -> None:
        while not self._pool.empty():
            try:
                self._pool.get_nowait().close()
            except queue.Empty:  # pragma: no cover
                break
