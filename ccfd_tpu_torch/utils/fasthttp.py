"""Minimal HTTP/1.1 server for the serving hot path (the port's copy of
ccfd_tpu/utils/fasthttp.py, standard library only).

``BaseHTTPRequestHandler`` parses each request with ``readline`` and an
``email``-module header parse, a large part of a REST request's host time
once scoring is fast. This server keeps the same threading model (one
daemon thread per connection, keep-alive) but parses requests directly off
the socket buffer: request line + headers in one ``partition``/``split``
pass.

Deliberately NOT a general web server: no chunked transfer encoding, no
multipart, no TLS, no pipelining guarantees beyond sequential keep-alive —
the serving routes need none of those. Anything unparseable gets 400 and the
connection closed.

Handler contract: ``handler(method: str, path: str, headers:
dict[bytes, bytes], body: bytes) -> (status: int, content_type: str,
body: bytes)``, or a 4-tuple whose last item is a ``{header: value}`` dict
of extra response headers (the overload gate's 429 carries
``Retry-After`` this way). Header names arrive lowercased.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable

Handler = Callable[[str, str, dict, bytes], tuple[int, str, bytes]]

_REASONS = {
    200: b"OK", 201: b"Created", 400: b"Bad Request", 401: b"Unauthorized",
    404: b"Not Found", 405: b"Method Not Allowed", 413: b"Payload Too Large",
    429: b"Too Many Requests", 500: b"Internal Server Error",
    503: b"Service Unavailable",
}
_MAX_HEAD = 64 * 1024
_MAX_BODY = 256 * 1024 * 1024


class FastHTTPServer:
    def __init__(
        self,
        address: tuple[str, int],
        handler: Handler,
        name: str = "ccfd-fasthttp",
        backlog: int = 256,
    ):
        self._handler = handler
        self._name = name
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(address)
        self._sock.listen(backlog)
        self.server_address = self._sock.getsockname()
        self._stopping = threading.Event()
        self._accept_thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FastHTTPServer":
        t = threading.Thread(target=self._accept_loop, daemon=True, name=self._name)
        t.start()
        self._accept_thread = t
        return self

    def shutdown(self) -> None:
        self._stopping.set()
        try:
            # poke the accept loop awake so it observes the stop flag
            with socket.create_connection(
                ("127.0.0.1", self.server_address[1]), timeout=1.0
            ):
                pass
        except OSError:
            pass

    def server_close(self) -> None:
        self._stopping.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    # -- internals ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed
            if self._stopping.is_set():
                try:
                    conn.close()
                except OSError:
                    pass
                return
            threading.Thread(
                target=self._serve_connection, args=(conn,), daemon=True,
                name=f"{self._name}-conn",
            ).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        buf = b""
        try:
            while not self._stopping.is_set():
                # --- read the request head ---
                while b"\r\n\r\n" not in buf:
                    if len(buf) > _MAX_HEAD:
                        self._respond(conn, 400, "text/plain", b"head too large")
                        return
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                head, _, buf = buf.partition(b"\r\n\r\n")
                lines = head.split(b"\r\n")
                parts = lines[0].split(b" ")
                if len(parts) < 2:
                    self._respond(conn, 400, "text/plain", b"bad request line")
                    return
                method = parts[0].decode("latin-1")
                path = parts[1].decode("latin-1")
                headers: dict[bytes, bytes] = {}
                for ln in lines[1:]:
                    k, sep, v = ln.partition(b":")
                    if sep:
                        headers[k.strip().lower()] = v.strip()
                # --- read the body ---
                try:
                    clen = int(headers.get(b"content-length", b"0") or b"0")
                except ValueError:
                    self._respond(conn, 400, "text/plain", b"bad content-length")
                    return
                if clen > _MAX_BODY:
                    self._respond(conn, 413, "text/plain", b"body too large")
                    return
                while len(buf) < clen:
                    chunk = conn.recv(min(1 << 20, clen - len(buf) + 65536))
                    if not chunk:
                        return
                    buf += chunk
                body, buf = buf[:clen], buf[clen:]
                # --- dispatch ---
                extra = None
                try:
                    res = self._handler(method, path, headers, body)
                    status, ctype, resp = res[0], res[1], res[2]
                    if len(res) > 3:  # optional extra response headers
                        extra = res[3]
                except Exception:  # noqa: BLE001 - a handler bug 500s the
                    # request; it must not kill the connection thread silently
                    status, ctype, resp = 500, "text/plain", b"internal error"
                close = headers.get(b"connection", b"").lower() == b"close"
                self._respond(conn, status, ctype, resp, close=close, extra=extra)
                if close:
                    return
        except OSError:
            return  # peer went away mid-request: nothing to answer
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _respond(
        conn: socket.socket, status: int, ctype: str, body: bytes,
        close: bool = False, extra: dict | None = None,
    ) -> None:
        more = b"".join(b"\r\n%s: %s" % (str(k).encode("latin-1"), str(v).encode("latin-1"))
                        for k, v in (extra or {}).items())
        head = b"HTTP/1.1 %d %s\r\nContent-Type: %s\r\nContent-Length: %d%s%s\r\n\r\n" % (
            status,
            _REASONS.get(status, b"OK"),
            ctype.encode("latin-1"),
            len(body),
            more,
            b"\r\nConnection: close" if close else b"",
        )
        conn.sendall(head + body)
