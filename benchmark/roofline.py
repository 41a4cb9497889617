"""Operations and bytes of the MLP family's kernels, and the chip's peaks.

Counted from the rows each launch really scored and the model's own widths
(F=30 features, H=256 hidden), never from a kernel's padded tiles, so the
count reads the same work whatever implements it:

- operations: ``2 * rows * (F*H + H*H + H)``, 146,944 a row;
- bytes: the weights once a launch (each weight at the configuration's
  width, plus its per-channel vectors in float32: the biases, and the int8
  scales), then each row's input on its wire and its float32 output.

A launch's least time is the larger of its operations over the peak of the
configuration's dtype and its bytes over the memory's bandwidth. Peaks:
NVIDIA's data sheet for one H100 SXM, dense, at its 700 W limit.
"""
from __future__ import annotations

PEAK_OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def ops_per_row(config: dict) -> int:
    f, h = int(config["num_features"]), int(config["hidden_size"])
    return 2 * (f * h + h * h + h)


def weight_bytes(config: dict) -> int:
    f, h = int(config["num_features"]), int(config["hidden_size"])
    r = config["roofline"]
    return (f * h + h * h + h) * int(r["weight_bytes"]) + (2 * h + 1) * int(r["channel_bytes"])


def launch_bytes(config: dict, rows: int) -> int:
    r = config["roofline"]
    return weight_bytes(config) + rows * (int(r["row_in_bytes"]) + int(r["row_out_bytes"]))


def peak(config: dict) -> float:
    return PEAK_OPS_PER_S[config["roofline"]["peak"]]


def launch_bound_s(config: dict, rows: int) -> float:
    return max(rows * ops_per_row(config) / peak(config),
               launch_bytes(config, rows) / HBM_BYTES_PER_S)


def bound_s(config: dict, launch_rows: list[int]) -> float:
    """The least time of a run of launches of ``launch_rows`` rows each."""
    return sum(launch_bound_s(config, n) for n in launch_rows)


def mfu(config: dict, rows: int, seconds: float) -> float:
    """The model operations of ``rows`` over ``seconds`` at the peak."""
    return rows * ops_per_row(config) / (seconds * peak(config))
