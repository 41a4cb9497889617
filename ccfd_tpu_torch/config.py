"""Serving configuration for the port, from the reference's environment.

Only the knobs the port's REST scorer reads, parsed from the same
environment variables as ccfd_tpu/config.py, with the same defaults:

    CCFD_MODEL, CCFD_DTYPE, CCFD_BATCH_SIZES            scorer
    CCFD_Q8_WIRE                                        mlp_q8 rows on the
                                                        wire: int8 (default,
                                                        kernel B3) or f32
                                                        (kernel B2); read by
                                                        the reference's Scorer
    CCFD_BATCH_DEADLINE_MS, CCFD_BATCH_WORKERS,
    CCFD_DYNAMIC_BATCHING                               request coalescing
    SELDON_TOKEN, CCFD_SERVE_HOST, CCFD_SERVE_PORT      REST front
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Sequence


@dataclass(frozen=True)
class Config:
    seldon_token: str = ""  # bearer token; empty = no auth
    model_name: str = "mlp"
    compute_dtype: str = "bfloat16"
    batch_sizes: Sequence[int] = (16, 128, 1024, 4096, 16384)
    q8_wire: str = "int8"  # "f32" opts out of the host-prequantized wire
    batch_deadline_ms: float = 2.0
    batch_workers: int = 4  # overlapped dispatches
    dynamic_batching: bool = True  # serving-side request coalescing
    serve_host: str = "0.0.0.0"
    serve_port: int = 8000

    @staticmethod
    def from_env(env: Mapping[str, str] | None = None) -> "Config":
        e = dict(os.environ if env is None else env)
        sizes = e.get("CCFD_BATCH_SIZES", "")
        return Config(
            seldon_token=e.get("SELDON_TOKEN", Config.seldon_token),
            model_name=e.get("CCFD_MODEL", Config.model_name),
            compute_dtype=e.get("CCFD_DTYPE", Config.compute_dtype),
            batch_sizes=tuple(int(s) for s in sizes.split(",")) if sizes else Config.batch_sizes,
            # as the reference: any value but "f32" keeps the int8 wire
            q8_wire="f32" if e.get("CCFD_Q8_WIRE", "int8") == "f32" else "int8",
            batch_deadline_ms=float(
                e.get("CCFD_BATCH_DEADLINE_MS", str(Config.batch_deadline_ms))
            ),
            batch_workers=int(
                e.get("CCFD_BATCH_WORKERS", str(Config.batch_workers))
            ),
            dynamic_batching=e.get("CCFD_DYNAMIC_BATCHING", "1").strip().lower()
            not in ("0", "false", "no", "off"),
            serve_host=e.get("CCFD_SERVE_HOST", Config.serve_host),
            serve_port=int(e.get("CCFD_SERVE_PORT", str(Config.serve_port))),
        )
