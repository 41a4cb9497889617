"""The keyed stream's producer: one process, one thread, open loop.

    python3 stream_producer.py HOST PORT TOPIC MIX_JSON SEED SECONDS STATE

Draws the run's records from the mix (its JSON, as the harness resolved it)
and the seed (``generator.keyed_stream``), encodes each as the bus's JSON
record (the transaction's 30 features, its ``id``, which is its index in
produce order, and its ``customer_id``; the record's key is the customer, so
a customer's records share a partition and keep their order), connects to
the bus's HTTP contract (``POST /topics/{topic}/produce``), prints
``ready``, and reads the window's start (``time.monotonic``) from stdin.
Record ``i`` is due at the start less the warm-up plus its arrival; every
``TICK_S`` the records due are sent in one request, paced by
``time.monotonic`` and never by the replies. Writes ``STATE/producer.npz``:
``t_send``, the monotonic time each record's request went out (NaN for one
never sent).
"""
from __future__ import annotations

import http.client
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.traffic import generator  # noqa: E402
from benchmark.traffic.surrogate import FEATURE_NAMES  # noqa: E402

TICK_S = 0.002  # the least time between two produce requests


def encode(rows: np.ndarray, keys: np.ndarray) -> list[str]:
    """Each record as the JSON the produce body carries."""
    out = []
    for i, (row, key) in enumerate(zip(rows.tolist(), keys.tolist())):
        value = dict(zip(FEATURE_NAMES, row))
        value["id"] = i
        value["customer_id"] = key
        out.append(json.dumps({"value": value, "key": key}))
    return out


def main(argv: list[str]) -> int:
    host, port, topic, mix_json, seed, seconds, state = argv
    mix = json.loads(mix_json)
    traffic = generator.keyed_stream(mix, int(seed), float(seconds))
    records = encode(traffic["rows"], traffic["keys"])
    arrival = traffic["arrival_s"]
    n = len(records)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    path = f"/topics/{topic}/produce"

    def post(body: str) -> None:
        conn.request("POST", path, body=body.encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"produce answered {resp.status}: {data[:200]!r}")

    conn.request("GET", f"/topics/{topic}/offsets")
    conn.getresponse().read()
    print("ready", flush=True)
    start = float(sys.stdin.readline()) - float(mix["warmup_s"])
    due_at = start + arrival
    t_send = np.full(n, np.nan)
    i, last = 0, -1.0
    try:
        while i < n:
            now = time.monotonic()
            wake = max(due_at[i], last + TICK_S)
            if now < wake:
                time.sleep(wake - now)
                now = time.monotonic()
            j = int(np.searchsorted(due_at, now, side="right"))
            if j <= i:
                continue
            post('{"records":[' + ",".join(records[i:j]) + "]}")
            t_send[i:j] = now
            last, i = now, j
    finally:
        np.savez(os.path.join(state, "producer.npz"), t_send=t_send)
        conn.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
