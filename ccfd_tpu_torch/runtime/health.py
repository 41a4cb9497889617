"""Liveness/readiness HTTP probes over a Supervisor.

The port's copy of ccfd_tpu/runtime/health.py.

The reference relies on OpenShift pod readiness as the gate between
run-book steps (reference README.md:81-85,187-201) and on `restartPolicy`
for liveness. This server is the kubelet-probe analog for in-process or
bare-host deployments:

    GET /healthz  -> 200 while the supervisor monitor is alive
    GET /readyz   -> 200 when every service is Running+ready, else 503
    GET /status   -> JSON per-service state/restarts/last_error
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler

from ccfd_tpu_torch.utils.httpserver import FrameworkHTTPServer

from ccfd_tpu_torch.runtime.supervisor import Supervisor


class _Handler(BaseHTTPRequestHandler):
    supervisor: Supervisor
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:
        pass

    def _reply(self, status: int, body: bytes, ctype: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        path = self.path.split("?")[0]
        if path == "/healthz":
            ok = self.supervisor.alive()
            self._reply(200 if ok else 503, json.dumps({"ok": ok}).encode())
        elif path == "/readyz":
            ok = self.supervisor.ready()
            self._reply(200 if ok else 503, json.dumps({"ready": ok}).encode())
        elif path == "/status":
            self._reply(200, json.dumps(self.supervisor.status()).encode())
        else:
            self._reply(404, b'{"error": "not found"}')


class HealthServer:
    def __init__(self, supervisor: Supervisor, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHealth", (_Handler,), {"supervisor": supervisor})
        self._httpd = FrameworkHTTPServer((host, port), handler)
        self._thread: threading.Thread | None = None

    @property
    def endpoint(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "HealthServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="ccfd-health"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
