"""The one general traffic generator. A mix is a data file
(``benchmark/mixes/<name>.json``) of parameters; everything a cell sends is
drawn from the mix and ``--seed``:

- ``pool_rows`` rows of the frozen Kaggle-shaped surrogate, generated from
  the seed;
- ``kind: closed_loop_rest``: ``clients`` closed-loop clients, all in one
  process (``benchmark/traffic/rest_client.py``), each cycling through
  ``requests_per_client`` requests of ``rows_per_request`` consecutive
  rows of the pool.

Every seed gets the same sizes and arrivals; only the rows differ.
"""
from __future__ import annotations

import numpy as np

from benchmark.traffic.surrogate import kaggle_surrogate


def pool(mix: dict, seed: int) -> np.ndarray:
    """The (pool_rows, 30) float32 rows this seed's requests carry."""
    return kaggle_surrogate(int(mix["pool_rows"]), seed)[0]
