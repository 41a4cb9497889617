"""Standalone REST load generator for a deployed scorer.

The port's copy of ccfd_tpu/utils/loadgen.py. The reference's users
benchmark their Seldon endpoint with external load tools; this is the
in-tree equivalent, tuned for honest numbers on small hosts: clients are
SUBPROCESSES (threads would share the GIL with whatever else runs on the
box and pollute the p99 with client-side scheduling), each client is a raw
socket with pre-serialized request bytes (an http.client loop burns
hundreds of microseconds a request on header objects), and latency is
measured send-to-full-response per request. ``_CLIENT`` is the reference's
client, byte for byte, so the two packages' ``loadgen`` numbers compare
directly. It handles real-deployment HTTP: Content-Length and chunked
responses, servers or proxies that close the connection per response
(reconnect and retry), and non-200s counted as errors rather than dying.

CLI: ``python -m ccfd_tpu_torch loadgen --url http://host:8000 --clients 8
--rows 16``. The bearer token travels in the child's environment
(CCFD_LOADGEN_TOKEN), never argv: argv is world-readable in /proc.
"""
from __future__ import annotations

import json
import subprocess
import sys
from typing import Any

_CLIENT = r"""
import json, os, socket, sys, time
host, port, path, rows_n, seconds = (
    sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
    float(sys.argv[5]),
)
token = os.environ.get("CCFD_LOADGEN_TOKEN", "")
row = [float(j % 7) for j in range(30)]
payload = json.dumps({"data": {"ndarray": [row] * rows_n}}).encode()
auth = b"Authorization: Bearer " + token.encode() + b"\r\n" if token else b""
req = (b"POST " + path.encode() + b" HTTP/1.1\r\n"
       b"Host: " + host.encode() + b"\r\n"
       b"Content-Type: application/json\r\n" + auth +
       b"Content-Length: " + str(len(payload)).encode() + b"\r\n\r\n" + payload)


def connect():
    s = socket.create_connection((host, port), timeout=10)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def read_response(sock, buf):
    '''Consume one response from sock; returns (status_ok, rest, closed).
    Handles Content-Length, chunked, and close-delimited bodies.'''
    while True:
        head_end = buf.find(b"\r\n\r\n")
        if head_end >= 0:
            break
        chunk = sock.recv(1 << 16)
        if not chunk:
            return None, b"", True  # closed before a full header
        buf += chunk
    head = buf[:head_end].lower()
    ok = buf.startswith(b"HTTP/1.1 200") or buf.startswith(b"HTTP/1.0 200")
    will_close = b"connection: close" in head or buf.startswith(b"HTTP/1.0")
    body_start = head_end + 4
    if b"content-length:" in head:
        cl = int(head.split(b"content-length:", 1)[1].split(b"\r\n", 1)[0])
        while len(buf) < body_start + cl:
            chunk = sock.recv(1 << 16)
            if not chunk:
                return ok, b"", True
            buf += chunk
        return ok, buf[body_start + cl:], will_close
    if b"transfer-encoding:" in head and b"chunked" in head.split(
        b"transfer-encoding:", 1
    )[1].split(b"\r\n", 1)[0]:
        rest = buf[body_start:]
        while True:
            line_end = rest.find(b"\r\n")
            while line_end < 0:
                chunk = sock.recv(1 << 16)
                if not chunk:
                    return ok, b"", True
                rest += chunk
                line_end = rest.find(b"\r\n")
            # chunk extensions ("1a;name=val") are legal; size is the part
            # before any ';'
            size = int(rest[:line_end].split(b";")[0], 16)
            if size == 0:
                # the zero chunk may be followed by trailer headers; the
                # body ends at the blank line either way
                term = rest.find(b"\r\n\r\n", line_end)
                while term < 0:
                    chunk = sock.recv(1 << 16)
                    if not chunk:
                        return ok, b"", True
                    rest += chunk
                    term = rest.find(b"\r\n\r\n", line_end)
                return ok, rest[term + 4:], will_close
            need = line_end + 2 + size + 2
            while len(rest) < need:
                chunk = sock.recv(1 << 16)
                if not chunk:
                    return ok, b"", True
                rest += chunk
            rest = rest[need:]
    # neither: body is delimited by connection close
    while True:
        chunk = sock.recv(1 << 16)
        if not chunk:
            return ok, b"", True
        buf += chunk


sock = connect()
lat, errors, attempts = [], 0, 0
buf = b""
stop_at = time.perf_counter() + seconds
t_loop = time.perf_counter()
while time.perf_counter() < stop_at:
    t1 = time.perf_counter()
    attempts += 1
    try:
        sock.sendall(req)
        ok, buf, closed = read_response(sock, buf)
    except OSError:
        ok, closed = None, True
    if ok is None:
        # connection died mid-request (per-response-close server, proxy
        # recycling): reconnect and retry this request once
        try:
            sock.close()
        except OSError:
            pass
        sock = connect()
        buf = b""
        try:
            sock.sendall(req)
            ok, buf, closed = read_response(sock, buf)
        except OSError:
            ok, closed = False, True
    if ok is False or ok is None:
        # non-200/failed: count it, but keep it OUT of the latency sample
        # — throughput and percentiles describe SUCCESSFUL requests only,
        # so a run with many errors can't report healthy-looking numbers
        errors += 1
    else:
        lat.append((time.perf_counter() - t1) * 1e3)
    if closed:
        try:
            sock.close()
        except OSError:
            pass
        sock = connect()
        buf = b""
print(json.dumps({"lat": lat, "errors": errors, "attempts": attempts,
                  "loop_s": time.perf_counter() - t_loop}))
"""


def run_loadgen(
    url: str,
    clients: int = 8,
    rows_per_request: int = 16,
    seconds: float = 10.0,
    path: str | None = None,
    token: str = "",
) -> dict[str, Any]:
    """Drive ``url`` with ``clients`` subprocess clients; returns the
    aggregate report (requests_s, tx_s, p50/p99 ms, errors). The URL's own
    path is honored when ``path`` is not given; all client subprocesses are
    killed on any error so a wedged endpoint can't leave orphans hammering
    it."""
    import os
    from urllib.parse import urlparse

    import numpy as np

    p = urlparse(url if "//" in url else "//" + url)
    host = p.hostname or "127.0.0.1"
    port = p.port or (443 if p.scheme == "https" else 80)
    if p.scheme == "https":
        raise ValueError("loadgen speaks plain HTTP (the serving contract)")
    if path is None:
        path = p.path if p.path and p.path != "/" else "/api/v0.1/predictions"
    env = dict(os.environ)
    if token:
        env["CCFD_LOADGEN_TOKEN"] = token  # env, not argv: /proc is public
    else:
        env.pop("CCFD_LOADGEN_TOKEN", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CLIENT, host, str(port), path,
             str(rows_per_request), str(seconds)],
            stdout=subprocess.PIPE, text=True, env=env,
        )
        for _ in range(clients)
    ]
    lat: list[float] = []
    errors = 0
    attempts = 0
    loop_s = 0.0
    failed = 0
    try:
        for pr in procs:
            try:
                out, _ = pr.communicate(timeout=seconds + 60)
            except subprocess.TimeoutExpired:
                failed += 1
                continue
            if pr.returncode != 0 or not out.strip():
                failed += 1
                continue
            try:
                rep = json.loads(out.strip().splitlines()[-1])
            except (ValueError, IndexError):
                failed += 1
                continue
            lat.extend(rep["lat"])
            errors += rep["errors"]
            attempts += rep.get("attempts", len(rep["lat"]))
            loop_s = max(loop_s, rep["loop_s"])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    if not lat:
        if attempts:
            # every request errored (e.g. the model answers 500 for all):
            # that is a REPORT, not a client failure — surface the counts
            # that diagnose it instead of a misleading traceback
            return {
                "url": url,
                "clients": clients,
                "rows_per_request": rows_per_request,
                "seconds": round(loop_s, 2),
                "requests_s": 0.0,
                "attempts_s": round(attempts / max(loop_s, 1e-9), 1),
                "tx_s": 0.0,
                "p50_ms": None,
                "p99_ms": None,
                "errors": errors,
                "failed_clients": failed,
            }
        raise RuntimeError(f"no client produced results ({failed} failed)")
    lat_a = np.asarray(lat)
    # successful requests only: the clients exclude errored/retried
    # attempts from the latency sample, so requests_s/tx_s/percentiles
    # can't look healthy while the error counter climbs
    n_req = len(lat)
    return {
        "url": url,
        "clients": clients,
        "rows_per_request": rows_per_request,
        "seconds": round(loop_s, 2),
        "requests_s": round(n_req / loop_s, 1),
        "attempts_s": round(attempts / loop_s, 1),
        "tx_s": round(n_req * rows_per_request / loop_s, 1),
        "p50_ms": round(float(np.percentile(lat_a, 50)), 3),
        "p99_ms": round(float(np.percentile(lat_a, 99)), 3),
        "errors": errors,
        "failed_clients": failed,
    }
