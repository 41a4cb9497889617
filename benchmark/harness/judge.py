"""From a run's records to its rows answered a second and its checks.

Each check is a number beside its limit; the run is correct when none
exceeds its limit:

- ``p_gap``: the widest gap between a served probability and the plain
  reference's for the same row;
- ``failed_share``: the share of the requests sent in the window that were
  answered with anything but a well-formed 200 (none sent reads 1). Only
  well-formed replies are held against the reference, so a run whose card
  served little or nothing fails here and not on ``p_gap``;
- ``malformed``: 200 replies that do not hold one probability a row
  (exact, limit 0).

The limits of ``p_gap`` and ``failed_share`` are the configuration's, set
from the readings in PERF.md.
"""
from __future__ import annotations

import numpy as np


def rest(out: dict, mix: dict, ref: np.ndarray, seconds: float, limits: dict) -> dict:
    n_rows, n_req = int(mix["rows_per_request"]), int(mix["requests_per_client"])
    t0m = out["t0_mono"]
    t1m = t0m + seconds
    gaps, malformed = [], 0
    attempted = failed = answered = trace_rows = 0
    w0, w1 = out["t0"] - out["mono_to_wall"], out["t1"] - out["mono_to_wall"]
    for c, r in enumerate(out["requests"]):
        win = (r["t_send"] >= t0m) & (r["t_send"] < t1m)
        status, proba = r["status"][win], r["proba"][win]
        finite = np.all(np.isfinite(proba), axis=1) if len(proba) else np.zeros(0, bool)
        ok = (status == 200) & finite
        malformed += int(((status == 200) & ~finite).sum())
        attempted += int(win.sum())
        failed += int((~ok).sum())
        td = r["t_done"][win]
        answered += int((ok & (td < t1m)).sum()) * n_rows
        trace_rows += int((ok & (td >= w0) & (td < w1)).sum()) * n_rows
        if ok.any():
            first = (c * n_req + r["req"][win][ok]) * n_rows
            idx = first[:, None] + np.arange(n_rows)[None, :]
            gaps.append(float(np.max(np.abs(proba[ok] - ref[idx]))))
    checks = {"malformed": (malformed, 0),
              "failed_share": (failed / attempted if attempted else 1.0,
                               float(limits["failed_share"])),
              "p_gap": (max(gaps) if gaps else 0.0, float(limits["p_gap"]))}
    return {"checks": checks, "attempted": attempted, "failed": failed, "rows": trace_rows,
            "judged": attempted - failed, "rows_per_s": answered / seconds}
