"""Python half of the native REST front (``native/httpfront.cpp``): the
port of ccfd_tpu/serving/native_front.py.

The C++ side owns the sockets, HTTP parsing, auth, the canonical payload's
decode and the response's format; this module runs the parts that need
Python:

- N scorer threads (``cfg.batch_workers``): ``ccfd_front_take`` hands over
  MANY requests as ONE concatenated float32 row block (the C++ queue is the
  dynamic batcher on this transport, so each block counts in
  ``serving_batcher_dispatches_total`` and its rows in
  ``serving_batcher_rows_total``); one ``Scorer.score`` a block;
  ``ccfd_front_respond`` fans the probabilities back out per request.
- one misc thread: GET /prometheus, health, and the payloads the native
  decoder bailed on (a names key, ragged rows, bad JSON, more than 8,192
  rows) go through the same ``PredictionServer._http_handler`` as on the
  Python transport: the same contract, another fast path.

Metrics match serving/server.py: per-request latency in the seldon
histogram from the C++ enqueue time (CLOCK_MONOTONIC, the clock of
``time.monotonic``), requests by code, the ModelPrediction gauges from the
last scored row; the C++ side's 401s fold into the registry at scrape
time, as do the requests it queued by queue
(``ccfd_front_requests_total{queue="predict"|"misc"}``: decoded in C++, or
the Python route). With the server's stage ``profiler`` each take feeds
``rest.batcher`` (the C++ queue's sojourn), ``rest.dispatch`` (the score
call) and each request ``rest`` (end to end in the front), the stages the
reference's batcher and spans fill on its Python transport.

Every canonical request goes to the takers and the Scorer: the reference's
in-IO-thread host model (small requests scored in C++ on a host copy of
the params, CCFD_INLINE_ROWS) is not carried over, since it would let a
request skip the kernel, and the port's ``httpfront.cpp`` leaves it out.
"""

from __future__ import annotations

import ctypes
import json
import logging
import threading
import time

import numpy as np

from ccfd_tpu_torch import native
from ccfd_tpu_torch.serving.dispatch import ScorerTimeout

MAX_BATCH_ROWS = 16384  # a taker's row block: >= the C++ side's 8,192-row cap
MAX_REQS_PER_TAKE = 1024
_FP = ctypes.POINTER(ctypes.c_float)


class NativeFront:
    def __init__(self, server):
        self._server = server  # the PredictionServer
        self._lib = native.lib()  # builds at first use; raises when it cannot
        self._handle = None
        self._threads: list[threading.Thread] = []
        self._stopping = threading.Event()
        self._stats_synced = [0, 0, 0, 0]  # ccfd_front_stats: all, predict, misc, 401
        self.server_address = ("0.0.0.0", 0)
        srv = server
        r = srv.registry
        self._c_queued = r.counter(
            "ccfd_front_requests_total",
            "requests the native front queued: predict (decoded in C++) or misc "
            "(the Python route)")
        self._on_dispatch = None
        if srv.cfg.dynamic_batching:
            def on_dispatch(n_rows: int) -> None:
                srv._c_dispatches.inc()
                srv._c_batched_rows.inc(n_rows)
            self._on_dispatch = on_dispatch

    # -- lifecycle ---------------------------------------------------------
    def start(self, port: int = 0, host: str = "0.0.0.0") -> int:
        srv = self._server
        port_out = ctypes.c_int(0)
        handle = self._lib.ccfd_front_create(
            (host or "0.0.0.0").encode(), int(port), srv.scorer.num_features,
            (srv.cfg.seldon_token or "").encode(), ctypes.byref(port_out))
        if not handle:
            raise OSError(f"native front failed to bind {host}:{port}")
        self._handle = handle
        self.server_address = (host or "0.0.0.0", int(port_out.value))
        for i in range(max(1, srv.cfg.batch_workers)):
            t = threading.Thread(target=self._score_loop, daemon=True,
                                 name=f"ccfd-front-score-{i}")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._misc_loop, daemon=True, name="ccfd-front-misc")
        t.start()
        self._threads.append(t)
        return int(port_out.value)

    def stop(self) -> None:
        if self._handle is None:
            return
        self._stopping.set()
        # stop wakes the takers (-1) and joins the C++ IO thread; the handle
        # stays valid until every Python thread that may be inside a take
        # has joined, and only then destroy frees it
        self._lib.ccfd_front_stop(self._handle)
        for t in self._threads:
            t.join(timeout=10.0)
        still_alive = [t for t in self._threads if t.is_alive()]
        self._threads = []
        if not still_alive:
            self._lib.ccfd_front_destroy(self._handle)
        # else a worker is stuck inside a device dispatch and may still touch
        # the handle: leak the Front rather than free memory a thread will use
        self._handle = None

    # -- the predict hot path -----------------------------------------------
    def _score_loop(self) -> None:
        from ccfd_tpu_torch.serving.server import _AMOUNT_COL, _V10_COL, _V17_COL

        srv = self._server
        nf = srv.scorer.num_features
        rows_buf = np.empty((MAX_BATCH_ROWS, nf), np.float32)
        rows_ptr = rows_buf.ctypes.data_as(_FP)
        meta = (ctypes.c_int * (3 * MAX_REQS_PER_TAKE))()
        enq = (ctypes.c_double * MAX_REQS_PER_TAKE)()
        model = srv.scorer.spec.name.encode()
        while not self._stopping.is_set():
            handle = self._handle
            if handle is None:
                return
            n_reqs = self._lib.ccfd_front_take(handle, rows_ptr, MAX_BATCH_ROWS, meta, enq,
                                               MAX_REQS_PER_TAKE, 200)
            if n_reqs <= 0:
                if n_reqs < 0:
                    return  # stopping
                continue
            ids = (ctypes.c_int * n_reqs)()
            counts = (ctypes.c_int * n_reqs)()
            tags = [0] * n_reqs
            total = 0
            for i in range(n_reqs):
                ids[i] = meta[3 * i]
                counts[i] = meta[3 * i + 1]
                tags[i] = meta[3 * i + 2]
                total += meta[3 * i + 1]
            # overload admission: the C++ queue forwards no headers, so these
            # requests admit at normal priority, request by request from the
            # front of the block; the refused tail gets 429 with the hint
            gate = srv.admission
            if gate is not None:
                n_admit, admitted = 0, 0
                for i in range(n_reqs):
                    if not gate.try_admit(counts[i]):
                        break
                    admitted += counts[i]
                    n_admit += 1
                if n_admit < n_reqs:
                    rej = json.dumps({"error": "overloaded",
                                      "retry_after_s": round(gate.retry_after_s, 3)}).encode()
                    for i in range(n_admit, n_reqs):
                        self._lib.ccfd_front_respond_misc(handle, ids[i], 429,
                                                          b"application/json", rej, len(rej))
                        srv._c_requests.inc(labels={"code": "429"})
                    n_reqs, total = n_admit, admitted
                    if n_reqs == 0:
                        continue
            x = rows_buf[:total]
            t_sc = time.monotonic()
            prof = srv.profiler
            if prof is not None:
                # the take's queue sojourn (enqueue in C++ to the take),
                # row-weighted: the rest.batcher stage of the reference's
                # batcher, which this front replaces
                t_ms = t_sc * 1e3
                wait = sum((t_ms - enq[i]) * counts[i] for i in range(n_reqs))
                prof.observe("rest.batcher", queue_s=max(0.0, wait / 1e3 / max(1, total)),
                             rows=total)
            status, err = 200, b""
            try:
                proba = np.ascontiguousarray(srv.scorer.score(x), np.float32)
            except ScorerTimeout as e:
                # the dispatch deadline expired or the device is wedged: 503
                status = 503
                err = json.dumps({"error": f"scoring unavailable: {e}"}).encode()
            except Exception:  # noqa: BLE001 - fail the requests, not the loop
                logging.getLogger(__name__).warning("scoring a taken block raised",
                                                    exc_info=True)
                status, err = 500, b'{"error": "scoring failed"}'
            if gate is not None:
                gate.release(total)
            if status != 200:
                for i in range(n_reqs):
                    self._lib.ccfd_front_respond_misc(handle, ids[i], status,
                                                      b"application/json", err, len(err))
                srv._c_requests.inc(n_reqs, labels={"code": str(status)})
                continue
            if gate is not None:
                gate.observe(time.monotonic() - t_sc)
            if prof is not None:
                prof.observe("rest.dispatch", dispatch_s=time.monotonic() - t_sc,
                             batch=total, rows=total)
            self._lib.ccfd_front_respond(handle, ids, counts, n_reqs,
                                         proba.ctypes.data_as(_FP), model)
            if self._on_dispatch is not None:
                self._on_dispatch(total)
            now_ms = time.monotonic() * 1e3
            for i in range(n_reqs):
                lat_s = max(0.0, (now_ms - enq[i]) / 1e3)
                srv._h_latency.observe(
                    lat_s,
                    labels={"endpoint": "/predict" if tags[i] else "/api/v0.1/predictions"})
                if prof is not None:
                    # the request end to end in the front: the "rest"
                    # stage the reference fills from its serving.predict
                    # spans, which the C++ front never opens
                    prof.observe("rest", service_s=lat_s)
            srv._c_requests.inc(n_reqs, labels={"code": "200"})
            if total:
                srv._g_proba.set(float(proba[total - 1]))
                srv._g_amount.set(float(x[total - 1, _AMOUNT_COL]))
                srv._g_v17.set(float(x[total - 1, _V17_COL]))
                srv._g_v10.set(float(x[total - 1, _V10_COL]))

    # -- everything else ------------------------------------------------------
    def _misc_loop(self) -> None:
        srv = self._server
        method_buf = ctypes.create_string_buffer(16)
        path_buf = ctypes.create_string_buffer(512)
        body_ptr = ctypes.c_void_p()
        body_len = ctypes.c_int(0)
        # the C++ side checked the bearer token before queueing but forwards
        # no headers: re-synthesize what the Python routing re-checks
        auth_hdr = {}
        if srv.cfg.seldon_token:
            auth_hdr = {b"authorization": f"Bearer {srv.cfg.seldon_token}".encode()}
        while not self._stopping.is_set():
            handle = self._handle
            if handle is None:
                return
            req_id = self._lib.ccfd_front_take_misc(handle, method_buf, 16, path_buf, 512,
                                                    ctypes.byref(body_ptr),
                                                    ctypes.byref(body_len), 200)
            if req_id < 0:
                return
            if req_id == 0:
                continue
            body = ctypes.string_at(body_ptr, body_len.value)
            self._lib.ccfd_front_free(body_ptr)
            method = method_buf.value.decode("latin-1")
            path = path_buf.value.decode("latin-1")
            if path in ("/prometheus", "/metrics"):
                self._sync_native_counters(handle)
            try:
                # a 4-tuple's extra headers (429 Retry-After) have no channel
                # through the C++ responder; the hint rides in the JSON body
                status, ctype, resp = srv._http_handler(method, path, auth_hdr, body)[:3]
            except Exception:  # noqa: BLE001 - fail the request, not the loop
                logging.getLogger(__name__).warning(
                    "misc handler raised for %s %s; answered 500", method, path,
                    exc_info=True)
                status, ctype, resp = 500, "text/plain", b"internal error"
            self._lib.ccfd_front_respond_misc(handle, req_id, status, ctype.encode(), resp,
                                              len(resp))

    def _sync_native_counters(self, handle) -> None:
        """Fold the C++ side's counts into the registry before a scrape: the
        401s it answered and the requests it queued, by queue."""
        srv = self._server
        stats = (ctypes.c_long * 4)()
        self._lib.ccfd_front_stats(handle, stats)
        d = [int(stats[i]) - self._stats_synced[i] for i in range(4)]
        self._stats_synced = [int(v) for v in stats]
        if d[3] > 0:
            srv._c_requests.inc(d[3], labels={"code": "401"})
        for i, queue in ((1, "predict"), (2, "misc")):
            if d[i] > 0:
                self._c_queued.inc(d[i], labels={"queue": queue})
