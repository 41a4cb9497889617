"""Pooled JSON-over-HTTP client for the port's REST hops (engine REST,
networked bus): the port's copy of ccfd_tpu/utils/httpclient.py.

Retry policy: an idempotent request retries on any transport error. A
non-idempotent one (process start, produce) retries only where the server
cannot have processed it: a refused connection, or an error while sending
the request. A failure while reading the response may mean the request was
processed, so it is not re-sent.

A pooled keep-alive connection whose server went away while it sat idle
(a restarted engine or bus) is found before it is used: a socket that
reads as ready while no request is in flight holds the peer's close, and
the connection is reopened instead of carrying a process start or a
produce into a dead socket, where the reference's copy loses that request
(ROADMAP C6).

An optional per-edge ``CircuitBreaker`` (runtime/breaker.py) gates each
request (an open circuit raises ``CircuitOpenError`` without dialing) and
records transport errors and 5xx answers as failures; retries back off
exponentially with jitter under an optional deadline budget. With a tracer
the call is one ``rpc.<edge>`` client span whose ``traceparent`` rides the
request. Fault injection (``CCFD_FAULTS``) is not ported.
"""

from __future__ import annotations

import http.client
import json
import queue
import random
import select
import socket
import time
import urllib.parse
from typing import Any

from ccfd_tpu_torch.runtime.breaker import CircuitOpenError, backoff_s


class _NodelayHTTPConnection(http.client.HTTPConnection):
    """Nagle off: headers and body go out as separate segments, and a
    delayed ACK would stall the body ~40 ms."""

    def connect(self) -> None:
        super().connect()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover
            pass


def dropped(conn: http.client.HTTPConnection) -> bool:
    """True when an idle pooled connection's peer has closed it: its socket
    is readable with no request in flight (EOF, or bytes nobody asked
    for). A connection not opened yet is not dropped."""
    sock = conn.sock
    if sock is None:
        return False
    try:
        readable, _, _ = select.select([sock], [], [], 0)
    except (OSError, ValueError):
        return True
    return bool(readable)


class PooledHTTPClient:
    def __init__(
        self,
        base_url: str,
        default_port: int,
        pool_size: int = 4,
        timeout_s: float = 5.0,
        retries: int = 2,
        scheme_error: str = "unsupported scheme",
        breaker=None,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        retry_budget_s: float | None = None,
        tracer=None,
        trace_edge: str = "http",
    ):
        u = urllib.parse.urlparse(base_url)
        if u.scheme not in ("http", ""):
            raise ValueError(f"{scheme_error}: {base_url!r}")
        self.host = u.hostname or "localhost"
        self.port = u.port or default_port
        self._timeout = timeout_s
        self._retries = max(0, retries)
        self._breaker = breaker
        self._tracer = tracer
        self._trace_edge = trace_edge
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s
        self._retry_budget_s = retry_budget_s
        self._rng = random.Random(0)  # deterministic backoff jitter
        self._pool: "queue.Queue[http.client.HTTPConnection]" = queue.Queue()
        for _ in range(max(1, pool_size)):
            self._pool.put(self._connect())

    def _connect(self) -> http.client.HTTPConnection:
        return _NodelayHTTPConnection(self.host, self.port, timeout=self._timeout)

    def request(self, method: str, path: str, body: Any = None,
                idempotent: bool = True) -> tuple[int, Any]:
        """-> (status, parsed JSON body or None). Raises ConnectionError
        when the server stays unreachable, ``CircuitOpenError`` when the
        breaker refuses."""
        if self._tracer is None:
            return self._do_request(method, path, body, idempotent, None)
        from ccfd_tpu_torch.observability.trace import format_traceparent

        with self._tracer.span(
            f"rpc.{self._trace_edge}",
            attrs={"method": method, "path": path, "peer": f"{self.host}:{self.port}"},
        ) as sp:
            try:
                status, parsed = self._do_request(
                    method, path, body, idempotent, format_traceparent(sp.context))
            except CircuitOpenError:
                sp.attrs["breaker_open"] = True
                raise
            sp.attrs["status"] = status
            if status >= 500:
                sp.status = "error"  # the sampler's always-keep-errored rule
            return status, parsed

    def _do_request(self, method: str, path: str, body: Any, idempotent: bool,
                    traceparent: str | None) -> tuple[int, Any]:
        # encode before the breaker gate: raising after allow() would leak
        # an admitted half-open probe slot
        payload = json.dumps(body).encode() if body is not None else None
        req_headers = {"Content-Type": "application/json"}
        if traceparent is not None:
            req_headers["traceparent"] = traceparent
        if self._breaker is not None and not self._breaker.allow():
            raise CircuitOpenError(f"circuit open for {self.host}:{self.port}")
        last: Exception | None = None
        deadline = (None if self._retry_budget_s is None
                    else time.monotonic() + self._retry_budget_s)
        for attempt in range(self._retries + 1):
            conn = self._pool.get()
            if dropped(conn):
                conn.close()  # the next request opens a fresh socket
            sent = False
            returned = False
            t0 = time.monotonic()
            try:
                conn.request(method, path, body=payload, headers=req_headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
                self._pool.put(conn)
                returned = True
                parsed = json.loads(data) if data else None
                if self._breaker is not None:
                    lat = time.monotonic() - t0
                    if resp.status >= 500:
                        self._breaker.record_failure(lat)
                    else:
                        self._breaker.record_success(lat)
                return resp.status, parsed
            except ValueError:
                # an undecodable body from a live server propagates, but the
                # gated call still records its outcome
                if self._breaker is not None:
                    self._breaker.record_failure(time.monotonic() - t0)
                raise
            except (OSError, http.client.HTTPException) as e:
                last = e
                if not returned:
                    conn.close()
                    self._pool.put(self._connect())
                if self._breaker is not None:
                    self._breaker.record_failure(time.monotonic() - t0)
                if not idempotent and sent:
                    break
                if attempt < self._retries:
                    pause = backoff_s(attempt, self._backoff_base_s,
                                      self._backoff_max_s, self._rng)
                    if deadline is not None and time.monotonic() + pause > deadline:
                        break
                    time.sleep(pause)
        raise ConnectionError(f"{self.host}:{self.port} unreachable: {last}")

    def close(self) -> None:
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                return
