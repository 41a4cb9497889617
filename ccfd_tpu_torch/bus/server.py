"""Networked broker: the bus as its own service, as the reference's Kafka.

The port's copy of ccfd_tpu/bus/server.py: ``python -m ccfd_tpu_torch bus``
serves an in-memory ``Broker`` over HTTP, and every other role connects
with ``BROKER_URL=http://host:port`` through ``RemoteBroker``
(bus/client.py). Same paths and JSON shapes as the reference, so either
package's client talks to either package's server.

Contract (JSON bodies; bytes values ride base64 under ``{"__b64__": ...}``):

    POST /topics/{topic}/produce     {records: [{value, key?, partition?}],
                                      headers?}               -> {metas}
    GET  /topics/{topic}/offsets                              -> [int]
    GET  /topics/{topic}/offsets/begin                        -> [int]
    GET  /groups/{group}/topics/{topic}/offsets               -> [int]
    POST /groups/{group}/topics/{topic}/offsets  {offsets}    -> {committed}
    POST /consumers                  {group, topics[], auto_commit?}
                                            -> {consumer_id, epoch}
    POST /consumers/{id}/poll        {max_records, timeout_s, seq?, epoch?}
                                            -> {records, epoch, assignment}
    POST /consumers/{id}/commit      {offsets?, epoch?}
                                            -> {committed, epoch} | 409 fenced
    POST /consumers/{id}/close                                    -> {}
    GET  /groups/{group}/epoch                                -> {epoch}
    POST /groups/{group}/fence       {idle_s}                 -> {closed, epoch}
    GET  /metrics | /prometheus | /health/status

A poll carries the client's sequence number: a retry after a lost response
re-sends the same seq and gets the same batch (at-least-once). Long polls
park the handler thread on the broker's condition variable. Consumers that
stop polling for ``consumer_ttl_s`` are reaped and their partitions
rebalance (Kafka's session timeout). Manual-commit consumers are fenced by
the group epoch (409 on a stale commit).
"""

from __future__ import annotations

import base64
import contextlib
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any

from ccfd_tpu_torch.bus.broker import Broker, Consumer, Record, StaleEpochError
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.utils.httpserver import FrameworkHTTPServer

_PRODUCE = re.compile(r"^/topics/([\w.-]+)/produce$")
_OFFSETS = re.compile(r"^/topics/([\w.-]+)/offsets$")
_BEGIN = re.compile(r"^/topics/([\w.-]+)/offsets/begin$")
_GROUP_OFFSETS = re.compile(r"^/groups/([\w.-]+)/topics/([\w.-]+)/offsets$")
_GROUP_EPOCH = re.compile(r"^/groups/([\w.-]+)/epoch$")
_GROUP_FENCE = re.compile(r"^/groups/([\w.-]+)/fence$")
_POLL = re.compile(r"^/consumers/(\d+)/poll$")
_COMMIT = re.compile(r"^/consumers/(\d+)/commit$")
_CLOSE = re.compile(r"^/consumers/(\d+)/close$")


def encode_value(v: Any) -> Any:
    """JSON-safe wire form; bytes ride base64 (CSV lines stay byte-exact)."""
    if isinstance(v, bytes):
        return {"__b64__": base64.b64encode(v).decode()}
    return v


def decode_value(v: Any) -> Any:
    if isinstance(v, dict) and set(v) == {"__b64__"}:
        return base64.b64decode(v["__b64__"])
    return v


def record_view(r: Record) -> dict[str, Any]:
    view = {
        "topic": r.topic,
        "partition": r.partition,
        "offset": r.offset,
        "key": encode_value(r.key),
        "value": encode_value(r.value),
        "timestamp": r.timestamp,
    }
    if r.headers:  # trace context; absent stays off the wire
        view["headers"] = dict(r.headers)
    return view


class BrokerServer:
    def __init__(self, broker: Broker | None = None, registry: Registry | None = None,
                 consumer_ttl_s: float = 60.0, tracer=None):
        self.broker = broker or Broker()
        self.registry = registry or Registry()
        self.consumer_ttl_s = consumer_ttl_s
        # produce requests join the caller's trace with a bus.produce span
        self.tracer = tracer
        self._consumers: dict[int, Consumer] = {}
        self._last_poll: dict[int, float] = {}
        # last delivered batch per consumer, keyed by the client's poll seq
        self._delivered: dict[int, tuple[int, list[dict[str, Any]], int]] = {}
        self._cid = 0
        self._lock = threading.Lock()
        self._httpd: FrameworkHTTPServer | None = None
        r = self.registry
        self._c_produced = r.counter("bus_records_produced_total", "records in")
        self._c_delivered = r.counter("bus_records_delivered_total", "records out")
        self._g_consumers = r.gauge("bus_consumers", "live remote consumers")
        self._c_topic_in = r.counter("bus_topic_records_in_total", "records in by topic")
        self._g_end_offset = r.gauge("bus_topic_end_offset",
                                     "log end offset by topic/partition")
        self._g_backlog = r.gauge("bus_topic_backlog", "unconsumed records by group/topic")
        self._g_start_offset = r.gauge("bus_topic_log_start_offset",
                                       "log start offset by topic/partition")
        self._g_retained = r.gauge("bus_topic_retained_records",
                                   "retained records by topic/partition")
        # counters published as deltas of the broker's lifetime tallies at
        # scrape time, so a crash_restart reads as a flat spot, not a reset
        self._c_trimmed = r.counter("bus_records_trimmed_total",
                                    "records deleted by retention")
        self._c_oor = r.counter("bus_offset_out_of_range_resets_total",
                                "fetches/rewinds clamped to the log start")
        self._last_trimmed = 0
        self._last_oor = 0

    def refresh_health_gauges(self) -> None:
        """Per-topic end and start offsets, per-group backlog and the
        retention counters, at scrape time."""
        snap = self.broker.health_snapshot()
        topics, groups, all_begins = snap["topics"], snap["groups"], snap["begins"]
        # the delta fold under the server lock: two scrapes racing the
        # read-inc-update would count a delta twice
        with self._lock:
            cur = int(self.broker.records_trimmed)
            self._c_trimmed.inc(max(0, cur - self._last_trimmed))
            self._last_trimmed = cur
            cur = int(self.broker.oor_resets)
            self._c_oor.inc(max(0, cur - self._last_oor))
            self._last_oor = cur
        for name, ends in topics.items():
            begins = all_begins.get(name)
            for p, end in enumerate(ends):
                labels = {"topic": name, "partition": str(p)}
                self._g_end_offset.set(end, labels=labels)
                if begins is not None:
                    self._g_start_offset.set(begins[p], labels=labels)
                    self._g_retained.set(end - begins[p], labels=labels)
        for g, tps in groups.items():
            lag_by_topic: dict[str, int] = {}
            for (tname, p), committed in tps.items():
                ends = topics.get(tname)
                if ends is not None and p < len(ends):
                    lag_by_topic[tname] = lag_by_topic.get(tname, 0) + max(
                        0, ends[p] - committed)
            for tname, lag in lag_by_topic.items():
                self._g_backlog.set(lag, labels={"group": g, "topic": tname})

    # -- consumer registry -------------------------------------------------
    def _register(self, group: str, topics: list[str], auto_commit: bool = True) -> int:
        with self._lock:
            self._reap_locked()
            self._cid += 1
            cid = self._cid
            self._consumers[cid] = self.broker.consumer(
                group, tuple(topics), auto_commit=auto_commit)
            self._last_poll[cid] = time.monotonic()
            self._g_consumers.set(len(self._consumers))
            return cid

    def fence_group(self, group: str, idle_s: float = 0.0) -> int:
        """Close every consumer of ``group`` idle for ``idle_s`` now: its
        partitions rebalance and the group epoch bumps. Returns how many."""
        now = time.monotonic()
        closed: list[Consumer] = []
        with self._lock:
            dead = [cid for cid, c in self._consumers.items()
                    if c.group_id == group and now - self._last_poll.get(cid, 0.0) >= idle_s]
            for cid in dead:
                c = self._consumers.pop(cid, None)
                self._last_poll.pop(cid, None)
                self._delivered.pop(cid, None)
                if c is not None:
                    closed.append(c)
            self._g_consumers.set(len(self._consumers))
        for c in closed:
            c.close()
        return len(closed)

    def _consumer(self, cid: int) -> Consumer | None:
        with self._lock:
            self._reap_locked(keep=cid)
            self._last_poll[cid] = time.monotonic()
            return self._consumers.get(cid)

    def _close_consumer(self, cid: int) -> bool:
        with self._lock:
            c = self._consumers.pop(cid, None)
            self._last_poll.pop(cid, None)
            self._delivered.pop(cid, None)
            self._g_consumers.set(len(self._consumers))
        if c is None:
            return False
        c.close()
        return True

    def _reap_locked(self, keep: int | None = None) -> None:
        now = time.monotonic()
        dead = [cid for cid, t in self._last_poll.items()
                if cid != keep and now - t > self.consumer_ttl_s]
        for cid in dead:
            c = self._consumers.pop(cid, None)
            self._last_poll.pop(cid, None)
            self._delivered.pop(cid, None)
            if c is not None:
                c.close()
        if dead:
            self._g_consumers.set(len(self._consumers))

    # -- HTTP ----------------------------------------------------------------
    def _produce(self, topic: str, payload: dict, headers) -> tuple[int, dict]:
        records = payload.get("records")
        if not isinstance(records, list):
            return 400, {"error": "need records: [...]"}
        # the producing client's traceparent stamps every record of the
        # batch; an explicit "headers" body field wins
        rec_headers = payload.get("headers")
        if rec_headers is not None and not isinstance(rec_headers, dict):
            rec_headers = None
        span_cm: Any = contextlib.nullcontext()
        if self.tracer is not None:
            from ccfd_tpu_torch.observability import trace as _trace

            parent = _trace.extract_context(headers)
            span_cm = self.tracer.span("bus.produce", parent=parent,
                                       attrs={"topic": topic, "records": len(records)})
            if rec_headers is None and parent is not None:
                rec_headers = {_trace.TRACEPARENT: _trace.format_traceparent(parent)}
        elif rec_headers is None:
            tp = headers.get("traceparent")
            if tp:
                rec_headers = {"traceparent": tp}
        # validate the whole batch first: a mid-batch reject would leave a
        # prefix in the log the counters never saw (JSON true is no int)
        for r in records:
            part = r.get("partition")
            if part is not None and (isinstance(part, bool) or not isinstance(part, int)):
                return 400, {"error": "partition must be an int"}
        metas = []
        try:
            with span_cm:
                for r in records:
                    rec = self.broker.produce(
                        topic, decode_value(r.get("value")), key=decode_value(r.get("key")),
                        partition=r.get("partition"), headers=rec_headers)
                    metas.append({"partition": rec.partition, "offset": rec.offset})
        except ValueError as e:
            # out-of-range partition: records 0..k-1 are in the log
            if metas:
                self._c_produced.inc(len(metas))
                self._c_topic_in.inc(len(metas), labels={"topic": topic})
            return 400, {"error": str(e), "produced": len(metas)}
        self._c_produced.inc(len(metas))
        self._c_topic_in.inc(len(metas), labels={"topic": topic})
        return 200, {"metas": metas}

    def _poll(self, cid: int, payload: dict) -> tuple[int, dict]:
        c = self._consumer(cid)
        if c is None:
            return 404, {"error": "no such consumer"}
        # a manual-commit client declares its epoch: a rebalance under it
        # answers 409 with the new epoch and assignment before it consumes
        want_epoch = payload.get("epoch")
        if want_epoch is not None:
            cur = self.broker.group_epoch(c.group_id)
            if int(want_epoch) != cur:
                return 409, {"error": "stale epoch", "epoch": cur,
                             "assignment": [list(tp) for tp in c.assignment()]}
        seq = payload.get("seq")
        if seq is not None:
            with self._lock:
                cached = self._delivered.get(cid)
            if cached is not None and cached[0] == seq:
                # the response to this seq was lost: redeliver the batch
                return 200, {"records": cached[1], "epoch": cached[2]}
        timeout = min(float(payload.get("timeout_s", 0.0)), 30.0)
        recs = c.poll(max_records=int(payload.get("max_records", 500)), timeout_s=timeout)
        views = [record_view(r) for r in recs]
        poll_epoch = c._poll_epoch  # the commit fence for this batch
        if seq is not None and recs:
            with self._lock:
                self._delivered[cid] = (seq, views, poll_epoch)
        self._c_delivered.inc(len(recs))
        return 200, {"records": views, "epoch": poll_epoch,
                     "assignment": [list(tp) for tp in c.assignment()]}

    def _commit(self, cid: int, payload: dict) -> tuple[int, dict]:
        c = self._consumer(cid)
        if c is None:
            # a reaped consumer cannot commit: the client maps this to
            # StaleEpochError
            return 404, {"error": "no such consumer"}
        offsets = payload.get("offsets")
        conv = None
        if offsets is not None:
            if not isinstance(offsets, dict):
                return 400, {"error": "offsets must be an object"}
            try:
                conv = {(str(t), int(p)): int(off)
                        for t, parts in offsets.items() for p, off in parts.items()}
            except (TypeError, ValueError, AttributeError):
                return 400, {"error": "offsets must be {topic: {partition: offset}}"}
        try:
            done = c.commit(conv, epoch=payload.get("epoch"))
        except StaleEpochError as e:
            return 409, {"error": "stale epoch", "epoch": e.current_epoch, "detail": str(e)}
        return 200, {"committed": [[t, p, off] for (t, p), off in done.items()],
                     "epoch": self.broker.group_epoch(c.group_id)}

    def _handle_post(self, path: str, payload: dict, headers) -> tuple[int, Any]:
        m = _PRODUCE.match(path)
        if m:
            return self._produce(m.group(1), payload, headers)
        if path == "/consumers":
            group, topics = payload.get("group"), payload.get("topics")
            if not group or not isinstance(topics, list) or not topics:
                return 400, {"error": "need group and topics[]"}
            cid = self._register(str(group), [str(t) for t in topics],
                                 auto_commit=bool(payload.get("auto_commit", True)))
            return 201, {"consumer_id": cid, "epoch": self.broker.group_epoch(str(group))}
        m = _POLL.match(path)
        if m:
            return self._poll(int(m.group(1)), payload)
        m = _COMMIT.match(path)
        if m:
            return self._commit(int(m.group(1)), payload)
        m = _GROUP_FENCE.match(path)
        if m:
            n = self.fence_group(m.group(1), idle_s=float(payload.get("idle_s", 0.0)))
            return 200, {"closed": n, "epoch": self.broker.group_epoch(m.group(1))}
        m = _CLOSE.match(path)
        if m:
            return (200 if self._close_consumer(int(m.group(1))) else 404), {}
        m = _GROUP_OFFSETS.match(path)
        if m:
            offs = payload.get("offsets")
            if (not isinstance(offs, list)
                    or not all(isinstance(o, int) and not isinstance(o, bool) for o in offs)):
                return 400, {"error": "need offsets: [int]"}
            try:
                self.broker.reset_offsets(m.group(1), m.group(2), offs)
            except ValueError as e:
                return 400, {"error": str(e)}
            return 200, {"committed": self.broker.committed_offsets(m.group(1), m.group(2))}
        return 404, {"error": "not found"}

    def _handle_get(self, path: str) -> tuple[int, Any]:
        m = _BEGIN.match(path)
        if m:
            return 200, self.broker.beginning_offsets(m.group(1))
        m = _OFFSETS.match(path)
        if m:
            return 200, self.broker.end_offsets(m.group(1))
        m = _GROUP_OFFSETS.match(path)
        if m:
            return 200, self.broker.committed_offsets(m.group(1), m.group(2))
        m = _GROUP_EPOCH.match(path)
        if m:
            return 200, {"epoch": self.broker.group_epoch(m.group(1))}
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

            def _send_json(self, code: int, obj: Any) -> None:
                self._send(code, "application/json", json.dumps(obj).encode())

            def do_GET(self):
                path = self.path.rstrip("/")
                if path in ("/metrics", "/prometheus"):
                    server.refresh_health_gauges()
                    self._send(200, "text/plain", server.registry.render().encode())
                elif path in ("/health/status", "/health", "/healthz"):
                    self._send_json(200, {"status": "ok"})
                else:
                    self._send_json(*server._handle_get(path))

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    length = 0
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    payload = json.loads(raw or b"{}")
                except ValueError:
                    self._send_json(400, {"error": "malformed JSON body"})
                    return
                if not isinstance(payload, dict):
                    self._send_json(400, {"error": "JSON body must be an object"})
                    return
                self._send_json(*server._handle_post(self.path.rstrip("/"), payload,
                                                     self.headers))

        return Handler

    def start(self, host: str = "0.0.0.0", port: int = 9092) -> int:
        self._httpd = FrameworkHTTPServer((host, port), self._handler_class())
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="ccfd-bus").start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        with self._lock:
            consumers = list(self._consumers.values())
            self._consumers.clear()
            self._last_poll.clear()
        for c in consumers:
            c.close()
        self.broker.close()
