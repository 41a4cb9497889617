"""Shared HTTP server base for the port's service surfaces (bus, engine
REST, metrics exporter): the port's copy of ccfd_tpu/utils/httpserver.py.

The socketserver default listen backlog of 5 resets connections under a
burst of clients, so the backlog is 256; and TCP_NODELAY is set on every
accepted connection, because Nagle's algorithm with delayed ACKs stalls a
small keep-alive JSON round trip by ~40 ms.
"""

from __future__ import annotations

import socket
from http.server import ThreadingHTTPServer


class FrameworkHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 256

    def process_request(self, request, client_address):
        try:
            request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover - non-TCP transports
            pass
        super().process_request(request, client_address)
