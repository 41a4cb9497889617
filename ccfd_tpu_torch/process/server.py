"""KIE-server-shaped REST surface for the process engine.

The port's copy of ccfd_tpu/process/server.py: ``python -m ccfd_tpu_torch
engine`` serves the engine on :8090, as the reference's KIE server, so the
router (``KIE_SERVER_URL``), investigators and scrapers live in other
processes. Same paths and JSON shapes as the reference:

    POST /rest/processes/{def_id}/instances        {variables} -> {process_id}
    POST /rest/processes/{def_id}/instances/batch  {variables_list}
                                                           -> {process_ids}
    POST /rest/instances/{pid}/signal/{name}       {payload}   -> {consumed}
    GET  /rest/instances/{pid}                                 -> instance view
    GET  /rest/instances?status=active                         -> [instance view]
    GET  /rest/tasks?status=open                               -> [task view]
    POST /rest/tasks/{tid}/complete                {outcome}   -> {}
    GET  /rest/metrics | /metrics | /prometheus    Prometheus scrape
    GET  /health/status                            readiness

Mutating requests join the caller's trace (``engine.rest`` span), so the
notification records the engine produces inside them carry it on.
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler
from typing import Any

from ccfd_tpu_torch.process.engine import Engine, Instance, Task
from ccfd_tpu_torch.utils.httpserver import FrameworkHTTPServer

_INSTANCES = re.compile(r"^/rest/processes/([\w.-]+)/instances$")
_INSTANCES_BATCH = re.compile(r"^/rest/processes/([\w.-]+)/instances/batch$")
_SIGNAL = re.compile(r"^/rest/instances/(\d+)/signal/([\w.-]+)$")
_INSTANCE = re.compile(r"^/rest/instances/(\d+)$")
_COMPLETE = re.compile(r"^/rest/tasks/(\d+)/complete$")


def instance_view(i: Instance) -> dict[str, Any]:
    # vars copied under the caller-held lock: json.dumps runs after release
    return {"process_id": i.pid, "definition": i.definition.id, "status": i.status,
            "node": i.node, "vars": dict(i.vars)}


def task_view(t: Task) -> dict[str, Any]:
    return {"task_id": t.task_id, "process_id": t.pid, "name": t.name,
            "status": t.status, "suggested_outcome": t.suggested_outcome,
            "prediction_confidence": t.prediction_confidence, "outcome": t.outcome,
            "vars": dict(t.vars)}


def _param(query: str, name: str) -> str | None:
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k == name and v:
            return v
    return None


class EngineServer:
    def __init__(self, engine: Engine, tracer=None):
        self.engine = engine
        self.tracer = tracer
        self._httpd: FrameworkHTTPServer | None = None

    def _get(self, path: str, query: str) -> tuple[int, Any]:
        eng = self.engine
        # views serialize live vars dicts: hold the engine lock
        m = _INSTANCE.match(path)
        if m:
            with eng.state_lock:
                try:
                    view = instance_view(eng.instance(int(m.group(1))))
                except KeyError:
                    return 404, {"error": "no such instance"}
            return 200, view
        if path == "/rest/instances":
            with eng.state_lock:
                return 200, [instance_view(i) for i in eng.instances(_param(query, "status"))]
        if path == "/rest/tasks":
            with eng.state_lock:
                return 200, [task_view(t)
                             for t in eng.tasks(_param(query, "status") or "open")]
        return 404, {"error": "not found"}

    def _post(self, path: str, payload: dict) -> tuple[int, Any]:
        eng = self.engine
        m = _INSTANCES_BATCH.match(path)
        if m:
            vlist = payload.get("variables_list")
            if not isinstance(vlist, list):
                return 400, {"error": "variables_list must be a list"}
            try:
                return 201, {"process_ids": eng.start_process_batch(m.group(1), vlist)}
            except KeyError:
                return 404, {"error": f"no process {m.group(1)!r}"}
        m = _INSTANCES.match(path)
        if m:
            try:
                pid = eng.start_process(m.group(1), payload.get("variables", payload) or {})
            except KeyError:
                return 404, {"error": f"no process {m.group(1)!r}"}
            return 201, {"process_id": pid}
        m = _SIGNAL.match(path)
        if m:
            consumed = eng.signal(int(m.group(1)), m.group(2),
                                  payload.get("payload", payload))
            return 200, {"consumed": consumed}
        m = _COMPLETE.match(path)
        if m:
            try:
                eng.complete_task(int(m.group(1)), payload.get("outcome"))
            except KeyError:
                return 404, {"error": "no such task"}
            except ValueError as e:
                return 409, {"error": str(e)}
            return 200, {}
        return 404, {"error": "not found"}

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                path = path.rstrip("/") or "/"
                if path in ("/rest/metrics", "/metrics", "/prometheus"):
                    self._send(200, "text/plain",
                               server.engine.registry.render().encode())
                    return
                if path in ("/health/status", "/health", "/healthz"):
                    code, obj = 200, {"status": "ok",
                                      "definitions": list(server.engine.definitions())}
                else:
                    code, obj = server._get(path, query)
                self._send(code, "application/json", json.dumps(obj).encode())

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    length = 0
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    payload = json.loads(raw or b"{}")
                except ValueError:
                    code, obj = 400, {"error": "malformed JSON body"}
                else:
                    if not isinstance(payload, dict):
                        code, obj = 400, {"error": "JSON body must be an object"}
                    else:
                        span_cm: Any = contextlib.nullcontext()
                        if server.tracer is not None:
                            from ccfd_tpu_torch.observability.trace import extract_context

                            span_cm = server.tracer.span(
                                "engine.rest", parent=extract_context(self.headers),
                                attrs={"path": self.path.split("?")[0]})
                        with span_cm:
                            code, obj = server._post(self.path.rstrip("/"), payload)
                self._send(code, "application/json", json.dumps(obj).encode())

        return Handler

    def start(self, host: str = "0.0.0.0", port: int = 8090) -> int:
        self._httpd = FrameworkHTTPServer((host, port), self._handler_class())
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="ccfd-kie").start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
