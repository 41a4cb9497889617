"""The closed-loop REST clients, all in one process of their own: one
connection a client, multiplexed by one thread on a selector, so the load
takes one core and not one process a client (the request and reply handling
is copied from the port's ``utils/loadgen.py`` client: a raw socket,
pre-serialized requests, Content-Length, chunked and close-delimited
replies, a reconnect when the peer closes).

    python benchmark/traffic/rest_client.py HOST PORT PATH SEED POOL_ROWS \
        ROWS REQUESTS CLIENTS SECONDS OUTDIR

Client ``c`` builds its ``REQUESTS`` requests of ``ROWS`` rows from its own
slice of the seed's surrogate pool. Once every client is connected the
process prints ``ready`` and reads the window's start ``T0`` (a
``time.monotonic`` reading) from its standard input. Each client then sends
its requests in turn, the next one only once the previous reply is in,
until the monotonic clock reaches ``T0 + SECONDS``; the replies of requests
sent before then are waited for. Every request sent in
``[T0, T0 + SECONDS)`` is recorded: its index, send and last-byte times
(``time.monotonic``, one clock for all processes of the host), the HTTP
status (0 for a timeout or a dropped connection) and the probabilities of
its reply, written to ``OUTDIR/client<c>.npz`` once the window has closed.
"""
from __future__ import annotations

import gc
import json
import os
import selectors
import socket
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.traffic.surrogate import kaggle_surrogate  # noqa: E402

TIMEOUT_S = 10.0


def parse_response(buf: bytes):
    """One whole response at the head of ``buf``: (status or None, body,
    rest, closes), or None while it is incomplete. A response without a
    length runs to the end of the connection: None until then."""
    head_end = buf.find(b"\r\n\r\n")
    if head_end < 0:
        return None
    head = buf[:head_end].lower()
    try:
        status = int(buf[:head_end].split(b" ", 2)[1])
    except (IndexError, ValueError):
        status = None
    closes = b"connection: close" in head or buf.startswith(b"HTTP/1.0")
    body_start = head_end + 4
    if b"content-length:" in head:
        cl = int(head.split(b"content-length:", 1)[1].split(b"\r\n", 1)[0])
        if len(buf) < body_start + cl:
            return None
        return status, buf[body_start:body_start + cl], buf[body_start + cl:], closes
    if b"transfer-encoding:" in head and b"chunked" in head.split(
            b"transfer-encoding:", 1)[1].split(b"\r\n", 1)[0]:
        pos, body = body_start, b""
        while True:
            line_end = buf.find(b"\r\n", pos)
            if line_end < 0:
                return None
            size = int(buf[pos:line_end].split(b";")[0], 16)
            if size == 0:
                term = buf.find(b"\r\n\r\n", line_end)
                if term < 0:
                    return None
                return status, body, buf[term + 4:], closes
            if len(buf) < line_end + 2 + size + 2:
                return None
            body += buf[line_end + 2:line_end + 2 + size]
            pos = line_end + 2 + size + 2
    return None


def requests(host: str, path: str, rows: np.ndarray, n_rows: int, n_req: int,
             first: int) -> list[bytes]:
    out = []
    for k in range(n_req):
        lo = first + k * n_rows
        body = json.dumps({"data": {"ndarray": rows[lo:lo + n_rows].tolist()}}).encode()
        out.append(b"POST " + path.encode() + b" HTTP/1.1\r\nHost: " + host.encode()
                   + b"\r\nContent-Type: application/json\r\nContent-Length: "
                   + str(len(body)).encode() + b"\r\n\r\n" + body)
    return out


def probabilities(body: bytes, n_rows: int) -> np.ndarray:
    """The reply's proba_1 column; NaN where the reply does not hold one
    probability a row."""
    try:
        arr = json.loads(body)["data"]["ndarray"]
        p = np.asarray([row[1] for row in arr], np.float64)
    except (ValueError, KeyError, TypeError, IndexError):
        p = np.zeros(0)
    if p.shape != (n_rows,):
        return np.full(n_rows, np.nan)
    return p


class Client:
    """One closed-loop client: its connection, its requests, its record."""

    def __init__(self, c: int, reqs: list[bytes], addr, sel) -> None:
        self.c, self.reqs, self.addr, self.sel = c, reqs, addr, sel
        self.k = 0
        self.t_send = None  # the outstanding request's send time
        self.buf = b""
        self.log: list[tuple[int, float, float, int, bytes]] = []
        self.sock = None
        self.connect()

    def connect(self) -> None:
        self.sock = socket.create_connection(self.addr, timeout=TIMEOUT_S)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sel.register(self.sock, selectors.EVENT_READ, self)
        self.buf = b""

    def reconnect(self) -> None:
        self.sel.unregister(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass
        self.connect()

    def send(self) -> None:
        self.t_send = time.monotonic()
        try:
            self.sock.sendall(self.reqs[self.k])
        except OSError:
            self.finish(None, b"", True)

    def finish(self, status, body: bytes, closed: bool) -> None:
        """The outstanding request's end: record it, step on."""
        self.log.append((self.k, self.t_send, time.monotonic(), status or 0, body))
        self.t_send = None
        self.k = (self.k + 1) % len(self.reqs)
        if closed or status is None:
            self.reconnect()

    def readable(self) -> None:
        try:
            chunk = self.sock.recv(1 << 16)
        except OSError:
            chunk = b""
        if not chunk:
            # the peer closed: a close-delimited reply ends here
            head_end = self.buf.find(b"\r\n\r\n")
            if self.t_send is None:
                self.reconnect()
            elif head_end >= 0:
                try:
                    status = int(self.buf[:head_end].split(b" ", 2)[1])
                except (IndexError, ValueError):
                    status = None
                self.finish(status, self.buf[head_end + 4:], True)
            else:
                self.finish(None, b"", True)
            return
        self.buf += chunk
        if self.t_send is None:
            return
        r = parse_response(self.buf)
        if r is not None:
            status, body, self.buf, closes = r
            self.finish(status, body, closes)


def run(clients: list[Client], sel, t0: float, seconds: float) -> None:
    end = t0 + seconds
    for cl in clients:
        cl.send()
    while True:
        now = time.monotonic()
        for cl in clients:
            if cl.t_send is None and now < end:
                cl.send()
            elif cl.t_send is not None and now - cl.t_send > TIMEOUT_S:
                cl.finish(None, b"", True)
                if now < end:
                    cl.send()
        if now >= end and all(cl.t_send is None for cl in clients):
            return
        for key, _ in sel.select(timeout=0.05):
            key.data.readable()


def main(argv: list[str]) -> int:
    host, port, path, seed, pool_rows, n_rows, n_req, n_clients, seconds, outdir = argv
    port, seed, pool_rows = int(port), int(seed), int(pool_rows)
    n_rows, n_req, n_clients = int(n_rows), int(n_req), int(n_clients)
    seconds = float(seconds)
    rows = kaggle_surrogate(pool_rows, seed)[0]
    sel = selectors.DefaultSelector()
    clients = [Client(c, requests(host, path, rows, n_rows, n_req, c * n_req * n_rows),
                      (host, port), sel) for c in range(n_clients)]
    # what is built is kept for the whole run: out of the collector's way
    gc.collect()
    gc.freeze()
    print("ready", flush=True)
    t0 = float(sys.stdin.readline())
    run(clients, sel, t0, seconds)
    for cl in clients:
        sel.unregister(cl.sock)
        cl.sock.close()
        log = [e for e in cl.log if e[1] >= t0]
        p = np.full((len(log), n_rows), np.nan)
        for j, (_, _, _, status, body) in enumerate(log):
            if status == 200:
                p[j] = probabilities(body, n_rows)
        np.savez(os.path.join(outdir, f"client{cl.c}.npz"),
                 req=np.asarray([e[0] for e in log], np.int64),
                 t_send=np.asarray([e[1] for e in log], np.float64),
                 t_done=np.asarray([e[2] for e in log], np.float64),
                 status=np.asarray([e[3] for e in log], np.int32), proba=p)
    print(json.dumps({"clients": n_clients, "requests": sum(len(cl.log) for cl in clients)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
