"""Prometheus scrape endpoint over a role's metric registries.

The port's copy of ccfd_tpu/metrics/exporter.py, for the standalone roles:
the router on :8091 (reference README.md:503-507) and notify on :8080.

    GET /prometheus | /metrics  every registry, merged family-wise
    GET /prometheus/<name>      one registry (router, notify, tracing, ...)
    GET /rest/metrics           the "kie" registry (the reference KIE path)
    GET /traces                 retained-trace summaries (JSON)
    GET /traces/<id>            one retained trace's spans (JSON)
    GET /memory                 memory evidence (JSON); ?trace=1 arms
                                tracemalloc

Metric paths answer ``text/plain; version=0.0.4``; unknown paths 404; HEAD
mirrors GET with no body. Every scrape refreshes the ``process`` registry's
``ccfd_process_rss_bytes`` and ``ccfd_component_objects{component}`` gauges,
and first calls each ``collectors`` callable (the router role publishes its
kernel launches and scorer dispatches this way). Not ported: OpenMetrics
negotiation, and the /profile, /incidents, /decisions, /capacity, /healthz
and /debug planes.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler
from typing import Callable

from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.observability.memory import memory_report, rss_bytes
from ccfd_tpu_torch.utils.httpserver import FrameworkHTTPServer

_TEXT_CTYPE = "text/plain; version=0.0.4"


def _merge_renders(bodies: list[str]) -> str:
    """Per-registry expositions -> one valid exposition: each family's HELP
    and TYPE once (the first registry's), every registry's samples grouped
    under it, and an identical series from two registries combined
    (counters and histograms sum, gauges last-write-wins)."""
    order: list[str] = []
    meta: dict[str, list[str]] = {}
    kind_of: dict[str, str] = {}
    series: dict[str, dict[str, list]] = {}
    seen_meta: set[tuple[str, str]] = set()

    def family_of(name: str) -> dict[str, list]:
        if name not in meta:
            meta[name] = []
            series[name] = {}
            order.append(name)
        return series[name]

    for body in bodies:
        family = ""
        family_of("")
        for line in body.splitlines():
            if line == "# EOF" or not line:
                continue
            if line.startswith(("# HELP ", "# TYPE ")):
                kind, name = line.split(" ", 3)[1:3]
                family_of(name)
                family = name
                if line.startswith("# TYPE "):
                    kind_of.setdefault(name, line.rsplit(" ", 1)[1])
                if (name, kind) not in seen_meta:
                    seen_meta.add((name, kind))
                    meta[name].append(line)
            else:
                fam = family_of(family)
                head, _, trailer = line.partition(" # ")
                key, _, val = head.rpartition(" ")
                prev = fam.get(key)
                if prev is None:
                    fam[key] = [val, trailer]
                    continue
                try:
                    if kind_of.get(family) == "gauge":
                        prev[0] = val
                    else:
                        total = float(prev[0]) + float(val)
                        prev[0] = (str(int(total)) if prev[0].isdigit() and val.isdigit()
                                   else repr(total))
                except ValueError:
                    prev[0] = val
                if not prev[1]:
                    prev[1] = trailer
    out: list[str] = []
    for name in order:
        out.extend(meta.get(name, ()))
        for key, (val, trailer) in series.get(name, {}).items():
            out.append(f"{key} {val}" + (f" # {trailer}" if trailer else ""))
    return "\n".join(out) + "\n"


class MetricsExporter:
    def __init__(self, registries: dict[str, Registry], host: str = "127.0.0.1",
                 port: int = 0, sink=None,
                 memory_probes: dict[str, Callable[[], float]] | None = None,
                 collectors: list[Callable[[], None]] | None = None):
        self._registries = dict(registries)
        self._sink = sink  # observability.trace.SpanSink (or None)
        self._collectors = list(collectors or ())
        self._memory_probes = dict(memory_probes or {})
        self._process_registry = Registry()
        self._g_rss = self._process_registry.gauge(
            "ccfd_process_rss_bytes", "process resident set size")
        self._g_objects = self._process_registry.gauge(
            "ccfd_component_objects",
            "live objects held per component container (memory probes)")
        self._registries.setdefault("process", self._process_registry)
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _answer(self, head_only: bool) -> None:
                path = self.path.split("?")[0].rstrip("/")
                body, ctype = exporter.respond(path, self.path.partition("?")[2])
                if body is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if not head_only:
                    self.wfile.write(data)

            def do_GET(self) -> None:
                self._answer(head_only=False)

            def do_HEAD(self) -> None:
                self._answer(head_only=True)

        self._httpd = FrameworkHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    def _refresh(self) -> None:
        self._g_rss.set(rss_bytes())
        for name, fn in self._memory_probes.items():
            try:
                self._g_objects.set(float(fn()), labels={"component": name})
            except Exception:  # noqa: BLE001 - a dead probe reads -1, not a 500
                self._g_objects.set(-1.0, labels={"component": name})
        for fn in self._collectors:
            fn()

    def respond(self, path: str, query: str = "") -> tuple[str | None, str]:
        """-> (body or None for 404, content type)."""
        if path == "/traces" or path.startswith("/traces/"):
            return self._traces(path), "application/json"
        if path == "/memory":
            from urllib.parse import parse_qs

            from ccfd_tpu_torch.observability.memory import ensure_tracemalloc

            if parse_qs(query or "").get("trace") == ["1"]:
                ensure_tracemalloc()
            return json.dumps(memory_report(self._memory_probes)), "application/json"
        return self.render_path(path), _TEXT_CTYPE

    def render_path(self, path: str) -> str | None:
        self._refresh()
        regs = self._registries
        if path in ("", "/prometheus", "/metrics"):
            return _merge_renders([r.render() for r in regs.values()])
        if path == "/rest/metrics":
            kie = regs.get("kie")
            return kie.render() if kie else None
        if path.startswith("/prometheus/"):
            r = regs.get(path[len("/prometheus/"):])
            return r.render() if r else None
        return None

    def _traces(self, path: str) -> str | None:
        if self._sink is None:
            return None
        if path == "/traces":
            return json.dumps({"traces": self._sink.traces()})
        trace_id = path[len("/traces/"):]
        spans = self._sink.trace(trace_id)
        if spans is None:
            return None
        return json.dumps({"trace_id": trace_id, "spans": spans})

    @property
    def endpoint(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MetricsExporter":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                        name="ccfd-metrics")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
