"""Prometheus scrape endpoint over the port's metric registries.

The port's copy of ccfd_tpu/metrics/exporter.py: the standalone roles (the
router on :8091, reference README.md:503-507, and notify on :8080) and the
platform operator, which serves every component registry from one port.

    GET /prometheus | /metrics  every registry, merged family-wise
    GET /prometheus/<name>      one registry (router, notify, slo, ...)
    GET /rest/metrics           the "kie" registry (the reference KIE path)
    GET /traces                 retained-trace summaries (JSON)
    GET /traces/<id>            one retained trace's spans (JSON)
    GET /profile                the live StageProfile document (JSON,
                                observability/profile.py)
    GET /memory                 memory evidence (JSON); ?trace=1 arms
                                tracemalloc
    GET /healthz                the readiness verdict (strict JSON): 200
                                healthy / 503 degraded, from the ``health``
                                composer (the operator's); 404 without one
    GET /debug/device           the device-telemetry snapshot (JSON):
                                torch.cuda memory, H2D accounting, the
                                executable inventory (observability/device.py)
    GET /debug/profile?seconds=N   an on-demand torch.profiler capture of N
                                seconds (clamped to 60): {"trace_dir",
                                "seconds", "device_us"}; one capture at a
                                time ({"error": ...} while busy)
    GET /decisions              decision-record summaries (JSON), newest
                                first; ?since=<unix_ts>&until=<unix_ts>
                                bracket decide time, ?limit=N bounds the
                                page (observability/audit.py)
    GET /decisions/<tx_id>      one full decision record by transaction id
                                (or "partition:offset" uid); unknown ids
                                404, and both endpoints 404 when the audit
                                plane is off (CCFD_AUDIT=0)
    GET /incidents              incident-bundle summaries (JSON), newest
                                first (observability/incident.py)
    GET /incidents/<id>         one full incident bundle (JSON); unknown ids
                                404, and both endpoints 404 when the plane
                                is off (CCFD_INCIDENT=0)
    GET /capacity               the fitted capacity-model document (JSON,
                                schema ccfd.capacity.v1): per-stage
                                utilization, headroom and knee, predicted
                                against observed p50/p99, the bottleneck
                                (observability/capacity.py)
    GET /capacity/whatif?workers=&batch=&deadline_ms=&max_inflight=
                                the same document re-evaluated under the
                                requested actuator overrides, with a
                                ``whatif`` section carrying the predicted-p99
                                delta; nothing live is touched. Both 404
                                when the plane is off (CCFD_CAPACITY=0)

Metric paths answer ``text/plain; version=0.0.4``; unknown paths 404; HEAD
mirrors GET with no body. Every scrape refreshes the ``process`` registry's
``ccfd_process_rss_bytes`` and ``ccfd_component_objects{component}`` gauges,
the profiler's stage gauges and the telemetry's memory gauges, and first
calls each ``collectors`` callable (the router role and the operator
publish kernel launches and scorer dispatches this way). Not ported:
OpenMetrics negotiation.
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
                 collectors: list[Callable[[], None]] | None = None,
                 profiler=None, telemetry=None,
                 health: Callable[[], dict] | None = None, audit=None,
                 recorder=None, capacity=None):
        self._registries = dict(registries)
        self._audit = audit  # observability.audit.AuditLog (or None)
        self._recorder = recorder  # observability.incident.FlightRecorder
        self._capacity = capacity  # observability.capacity.CapacityModel
        self._sink = sink  # observability.trace.SpanSink (or None)
        self._profiler = profiler  # observability.profile.StageProfiler
        self._telemetry = telemetry  # observability.device.DeviceTelemetry
        self._health = health  # callable -> readiness doc (healthz())
        self._capture_lock = threading.Lock()  # one device capture at a time
        self._lock = threading.Lock()
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
                if path == "/healthz":
                    # the one path whose status code is the verdict
                    body, status = exporter.healthz()
                    ctype = "application/json"
                else:
                    body, ctype = exporter.respond(path, self.path.partition("?")[2])
                    status = 200
                if body is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                data = body.encode()
                self.send_response(status)
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

    def add(self, name: str, registry: Registry) -> None:
        with self._lock:
            self._registries[name] = registry

    def add_probe(self, component: str, count_fn: Callable[[], float]) -> None:
        """Register a live-object-count callable for the memory surface."""
        with self._lock:
            self._memory_probes[component] = count_fn

    def refresh(self) -> None:
        """What every scrape does first: the RSS and object-count gauges, the
        collectors, the profiler's and the telemetry's gauges."""
        self._g_rss.set(rss_bytes())
        with self._lock:
            probes = dict(self._memory_probes)
            collectors = list(self._collectors)
        for name, fn in probes.items():
            try:
                self._g_objects.set(float(fn()), labels={"component": name})
            except Exception:  # noqa: BLE001 - a dead probe reads -1, not a 500
                self._g_objects.set(-1.0, labels={"component": name})
        for fn in collectors:
            fn()
        if self._profiler is not None:
            try:
                self._profiler.refresh_gauges()
            except Exception:  # noqa: BLE001 - a profiler bug must not 500
                pass
        if self._telemetry is not None:
            try:
                self._telemetry.refresh()
            except Exception:  # noqa: BLE001 - telemetry must not 500
                pass

    def respond(self, path: str, query: str = "") -> tuple[str | None, str]:
        """-> (body or None for 404, content type)."""
        if path == "/traces" or path.startswith("/traces/"):
            return self._traces(path), "application/json"
        if path == "/profile":
            if self._profiler is None:
                return None, "application/json"
            return json.dumps(self._profiler.snapshot()), "application/json"
        if path == "/debug/device":
            if self._telemetry is None:
                return None, "application/json"
            return json.dumps(self._telemetry.snapshot()), "application/json"
        if path == "/debug/profile":
            return self._device_capture(query), "application/json"
        if path == "/decisions" or path.startswith("/decisions/"):
            return self._decisions(path, query), "application/json"
        if path == "/incidents" or path.startswith("/incidents/"):
            return self._incidents(path), "application/json"
        if path in ("/capacity", "/capacity/whatif"):
            return self._capacity_doc(path, query), "application/json"
        if path == "/memory":
            from urllib.parse import parse_qs

            from ccfd_tpu_torch.observability.memory import ensure_tracemalloc

            if parse_qs(query or "").get("trace") == ["1"]:
                ensure_tracemalloc()
            with self._lock:
                probes = dict(self._memory_probes)
            return json.dumps(memory_report(probes)), "application/json"
        return self.render_path(path), _TEXT_CTYPE

    def _incidents(self, path: str) -> str | None:
        """Incident bundles (observability/incident.py); None (404) with
        the plane off or for an unknown id."""
        if self._recorder is None:
            return None
        if path.rstrip("/") == "/incidents":
            return json.dumps({"incidents": self._recorder.incidents()})
        doc = self._recorder.incident_doc(path[len("/incidents/"):])
        return None if doc is None else json.dumps(doc)

    def _capacity_doc(self, path: str, query: str) -> str | None:
        """Capacity-model documents (observability/capacity.py). With the
        plane off (CCFD_CAPACITY=0: no model wired) BOTH endpoints 404."""
        if self._capacity is None:
            return None
        if path == "/capacity":
            return json.dumps(self._capacity.snapshot())
        from urllib.parse import parse_qs

        q = parse_qs(query or "")

        def num(name: str, kind: type):
            try:
                return kind(q[name][0]) if q.get(name) else None
            except ValueError:
                return None

        return json.dumps(self._capacity.whatif(
            workers=num("workers", int), batch=num("batch", int),
            deadline_ms=num("deadline_ms", float), max_inflight=num("max_inflight", int)))

    def _decisions(self, path: str, query: str) -> str | None:
        """Decision-provenance queries (observability/audit.py). With the
        plane off (CCFD_AUDIT=0: no AuditLog wired) BOTH endpoints 404, the
        kill-switch contract."""
        if self._audit is None:
            return None
        if path.rstrip("/") == "/decisions":
            from urllib.parse import parse_qs

            q = parse_qs(query or "")
            since = until = None
            try:
                if q.get("since"):
                    since = float(q["since"][0])
            except ValueError:
                since = None
            try:
                if q.get("until"):
                    until = float(q["until"][0])
            except ValueError:
                until = None
            try:
                limit = int((q.get("limit") or ["256"])[0])
            except ValueError:
                limit = 256
            return json.dumps(
                {"decisions": self._audit.list(since=since, until=until, limit=limit)})
        rec = self._audit.get(path[len("/decisions/"):])
        if rec is None:
            return None
        return json.dumps(rec)

    def healthz(self) -> tuple[str | None, int]:
        """The /healthz verdict -> (body, status): None/404 without a
        health composer, else its document with 200 healthy / 503
        degraded."""
        if self._health is None:
            return None, 404
        try:
            doc = self._health()
        except Exception as e:  # noqa: BLE001 - a probe bug reads degraded
            doc = {"healthy": False, "sources": {},
                   "causes": [f"health composer error: {e!r}"[:200]]}
        return json.dumps(doc), (200 if doc.get("healthy") else 503)

    def _device_capture(self, query: str) -> str | None:
        """/debug/profile?seconds=N: a torch.profiler capture of ~N seconds
        (clamped to [0.05, 60]) into a new temp dir; one at a time. 404s
        (None) unless both the profiler and the device plane are armed, as
        in the reference."""
        if self._profiler is None or self._telemetry is None:
            return None
        import tempfile
        import time as _time
        from urllib.parse import parse_qs

        q = parse_qs(query or "")
        try:
            seconds = float((q.get("seconds") or ["3"])[0])
        except ValueError:
            seconds = 3.0
        seconds = min(max(seconds, 0.05), 60.0)
        if not self._capture_lock.acquire(blocking=False):
            return json.dumps({"error": "device capture already in progress"})
        try:
            logdir = tempfile.mkdtemp(prefix="ccfd_device_trace_")
            with self._profiler.profile_device(logdir):
                _time.sleep(seconds)
            with open(f"{logdir}/device_time.json") as f:
                device_us = json.load(f)["device_us"]
            return json.dumps({"trace_dir": logdir, "seconds": seconds,
                               "device_us": device_us})
        except Exception as e:  # noqa: BLE001 - a debug endpoint must not 500
            return json.dumps({"error": repr(e)[:200]})
        finally:
            self._capture_lock.release()

    def render_path(self, path: str) -> str | None:
        self.refresh()
        with self._lock:
            regs = dict(self._registries)
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
