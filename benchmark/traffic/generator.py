"""The one general traffic generator. A mix is a data file
(``benchmark/mixes/<name>.json``) of parameters; everything a cell sends is
drawn from the mix and ``--seed``:

- ``pool_rows`` rows of the frozen Kaggle-shaped surrogate, generated from
  the seed;
- ``kind: closed_loop_rest``: ``clients`` closed-loop clients, all in one
  process (``benchmark/traffic/rest_client.py``), each cycling through
  ``requests_per_client`` requests of ``rows_per_request`` consecutive
  rows of the pool;
- ``kind: keyed_stream`` (``keyed_stream``): ``rate_per_s`` Poisson
  arrivals over the warm-up and the window, each a record of one row of
  the surrogate keyed by a customer drawn Zipf(``zipf_s``) from
  ``customers``, produced in arrival order by one process
  (``benchmark/traffic/stream_producer.py``).

Every seed gets the same sizes and arrivals; only the rows differ (and, for
a stream, which customer sends each record and the order of the gaps).
"""
from __future__ import annotations

import numpy as np

from benchmark.traffic.surrogate import kaggle_surrogate

# the one draw of a stream's exponential gaps that every seed permutes
ARRIVAL_SEED = 0


def pool(mix: dict, seed: int) -> np.ndarray:
    """The (pool_rows, 30) float32 rows this seed's requests carry."""
    return kaggle_surrogate(int(mix["pool_rows"]), seed)[0]


def keyed_stream(mix: dict, seed: int, seconds: float) -> dict:
    """A stream's records in produce order: ``rows`` (n, 30) float32,
    ``keys`` (n,) int64 customer ids and ``arrival_s`` (n,) float64 seconds
    from the start of the warm-up. ``n`` is ``rate_per_s`` times the
    warm-up and the window; the gaps are one fixed draw of exponential gaps
    (``ARRIVAL_SEED``), scaled to span them, in the order the seed draws."""
    rate, span = float(mix["rate_per_s"]), float(mix["warmup_s"]) + float(seconds)
    n = int(round(rate * span))
    gaps = np.random.default_rng(ARRIVAL_SEED).exponential(1.0, n + 1)
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    gaps = rng.permutation(gaps) * (span / gaps.sum())
    k = int(mix["customers"])
    p = 1.0 / np.arange(1, k + 1, dtype=np.float64) ** float(mix["zipf_s"])
    ranks = rng.choice(k, size=n, p=p / p.sum())
    keys = rng.permutation(k).astype(np.int64)[ranks]
    rows = kaggle_surrogate(n, seed)[0] if n else np.zeros((0, 30), np.float32)
    return {"rows": rows, "keys": keys, "arrival_s": np.cumsum(gaps)[:n]}
