"""Operations and bytes of the seq family's forward (``models/seq.py``'s
readout, what the seq scorer launches), and its least time on the chip.

Counted from the configuration's widths (F features, D model width, H
heads, the MLP's width M = ``intermediate_size``, the blocks), each
launch's L bucket and the rows it really scored, never from a launch's
padded rows, so the count reads the same work whatever implements it.
Operations are the dense and attention products, two a multiply-add:

- the embedding, ``2 L F D``;
- each block but the last over all L tokens: ``2 L (3 D^2 + D^2 + 2 M D)``
  and the attention's two products, ``4 L^2 D``;
- the last block (the readout): K and V over all L, ``2 L (2 D^2)``, then
  for the last token only Q, the attention, proj and the MLP,
  ``2 (D^2 + 2 L D + D^2 + 2 M D)``;
- the head, ``2 D``.

Bytes: the weights once a launch (each dense weight at the configuration's
width, every bias and norm vector in float32), then each row's history in
float32 (``L F`` values) and its float32 probability.

A window's launches in one L bucket, ``n`` of them scoring ``R`` rows, take
at least ``max(R ops(L) / peak, (n weights + R row bytes(L)) / bandwidth)``:
no more than the sum of each launch's own least time, so the share of it in
the kernels' time never reads high. Peaks: ``roofline.py``'s.
"""
from __future__ import annotations

from benchmark.roofline import HBM_BYTES_PER_S, PEAK_OPS_PER_S


def _widths(config: dict) -> tuple[int, int, int, int]:
    return (int(config["num_features"]), int(config["hidden_size"]),
            int(config["intermediate_size"]), int(config["num_hidden_layers"]))


def ops_per_row(config: dict, length: int) -> int:
    f, d, m, blocks = _widths(config)
    L = int(length)
    full = 2 * L * (3 * d * d + d * d + 2 * m * d) + 4 * L * L * d
    readout = 2 * L * 2 * d * d + 2 * (d * d + 2 * L * d + d * d + 2 * m * d)
    return 2 * L * f * d + (blocks - 1) * full + readout + 2 * d


def weight_bytes(config: dict) -> int:
    f, d, m, blocks = _widths(config)
    r = config["roofline"]
    weights = f * d + blocks * (3 * d * d + d * d + 2 * m * d) + d
    vectors = d + blocks * (3 * d + d + m + d + 4 * d) + 2 * d + 1 + 2 * f
    return weights * int(r["weight_bytes"]) + vectors * int(r["channel_bytes"])


def row_bytes(config: dict, length: int) -> int:
    return int(length) * int(config["num_features"]) * 4 + 4


def bucket_bound_s(config: dict, length: int, launches: int, rows: int) -> float:
    peak = PEAK_OPS_PER_S[config["roofline"]["peak"]]
    return max(rows * ops_per_row(config, length) / peak,
               (launches * weight_bytes(config) + rows * row_bytes(config, length))
               / HBM_BYTES_PER_S)


def bound_s(config: dict, seq_launches: dict) -> float:
    """The least time of a window's launches, ``{L: {"launches", "rows"}}``."""
    return sum(bucket_bound_s(config, lb, v["launches"], v["rows"])
               for lb, v in seq_launches.items())


def mfu(config: dict, rows: int, length: int, seconds: float) -> float:
    """The model operations of ``rows`` decisions at history ``length`` over
    ``seconds`` at the peak."""
    peak = PEAK_OPS_PER_S[config["roofline"]["peak"]]
    return rows * ops_per_row(config, length) / (seconds * peak)
