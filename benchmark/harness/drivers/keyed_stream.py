"""Mix kind ``keyed_stream``: the platform as ``up`` builds it, fed keyed
records on its bus by a producer of the benchmark's own.

The platform is the program's operator (``platform/operator.py``) on the CR
it ships (``ccfd_tpu_torch/assets/platform_cr.yaml``), each block updated by
the configuration's ``cr`` block, with the platform's own producer off and
every path the CR gives relative (``./...``) put under the run's state
directory. Its bus is served over the bus's HTTP contract
(``bus/server.py``) on a port the OS picks, and one producer process
(``benchmark/traffic/stream_producer.py``) produces the run's records there,
open loop, each keyed by its customer. The router scores each record on its
customer's history (``SeqScorer.score_with_ids``) and stamps one decision
record (``observability/audit.py``) for each; those records are the answers.

What the reference sees (``traffic``): every record produced, in produce
order, with its customer's key, and the indices of the answers judged. The
driver also hands over host copies of the params the platform served.

The judge (``judge``) holds, for the records due in the window (by the
producer's schedule, whenever the bus took them):

- ``p_gap``: the widest gap between a decision's probability and the
  reference's, over the decisions scored on the device;
- ``failed_share``: the share of the records due in the window with no
  device-tier decision once the grace period closed (none due reads 1);
- ``malformed``: decisions whose probability is not finite (limit 0).
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

from benchmark.harness import spec
from benchmark.traffic import generator

PRODUCER = spec.BENCH_DIR / "traffic" / "stream_producer.py"
CR_FILE = spec.ROOT / "ccfd_tpu_torch" / "assets" / "platform_cr.yaml"
GRACE_S = 60.0  # past the window's close, for the backlog to be decided
TIERS = ("device", "host", "rules")  # a decision's tier, 1-based in ``out["tier"]``


def platform_cr(config: dict, state: str) -> dict:
    """The shipped CR, each block updated by the configuration's ``cr``,
    the producer off, and its relative paths under ``state``."""
    import yaml

    with open(CR_FILE) as f:
        cr = yaml.safe_load(f)
    blocks = cr["spec"]
    for name, opts in config.get("cr", {}).items():
        blocks.setdefault(name, {}).update(copy.deepcopy(opts))
    blocks["producer"] = {**blocks.get("producer", {}), "enabled": False}

    def reroot(v):
        if isinstance(v, dict):
            return {k: reroot(x) for k, x in v.items()}
        if isinstance(v, str) and v.startswith("./"):
            return os.path.join(state, v[2:])
        return v

    cr["spec"] = reroot(blocks)
    return cr


def _window_counters(plat) -> dict:
    """The seq scorer's counters now: launches by (L, B) bucket, rows by L
    bucket, the history assembly's histogram, the dispatches."""
    reg = plat.registries["seldon"]
    h = reg.histogram("seq_assembly_seconds")
    return {"launches": dict(reg.counter("seq_bucket_dispatch_total").items()),
            "rows": dict(reg.counter("seq_bucket_rows_total").items()),
            "assembly": (h.count(), h.sum()),
            "dispatches": plat.scorer.dispatch_total()}


def _delta(a: dict, b: dict) -> dict:
    """The window's readings from the counters at its two ends."""
    launches: dict = {}
    for key, v in b["launches"].items():
        labels = dict(key)
        n = v - a["launches"].get(key, 0.0)
        if n:
            lb = int(labels["l_bucket"])
            launches.setdefault(lb, {"launches": 0, "rows": 0, "b_buckets": {}})
            launches[lb]["launches"] += int(n)
            launches[lb]["b_buckets"][int(labels["b_bucket"])] = int(n)
    for key, v in b["rows"].items():
        lb = int(dict(key)["l_bucket"])
        if lb in launches:
            launches[lb]["rows"] = int(v - a["rows"].get(key, 0.0))
    return {"seq_launches": launches,
            "assembly_batches": b["assembly"][0] - a["assembly"][0],
            "assembly_s": b["assembly"][1] - a["assembly"][1]}


def run(cell, seed: int, seconds: float, trace: bool, device, state: str,
        record: bool) -> dict:
    """One run; ``record`` takes the device's trace of the window."""
    from ccfd_tpu_torch.bus.server import BrokerServer
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.params import flatten
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec
    from ccfd_tpu_torch.utils.gctune import tune_for_service

    config, mix = cell.config, cell.mix
    traffic = generator.keyed_stream(mix, seed, seconds)
    n = len(traffic["keys"])
    dev = None
    if record:
        # started before anything else: the profiler's start takes seconds
        from benchmark.harness.devtrace import DeviceTrace

        dev = DeviceTrace(cuda=str(device).startswith("cuda"))
        dev.start()
    plat = Platform(PlatformSpec.from_cr(platform_cr(config, state), cfg=Config.from_env()),
                    device=device)
    bus = proc = None
    out: dict = {}
    try:
        plat.up(wait_ready_s=120.0)
        tune_for_service()
        if plat.audit is None or plat.audit.max_records < n:
            raise ValueError(f"the run produces {n} records: the audit ring must hold them all")
        bus = BrokerServer(plat.broker)
        port = bus.start("127.0.0.1", 0)
        env = {k: v for k, v in os.environ.items() if not k.startswith("CCFD_")}
        proc = subprocess.Popen(
            [sys.executable, str(PRODUCER), "127.0.0.1", str(port), plat.cfg.producer_topic,
             json.dumps(mix), str(seed), repr(float(seconds)), state],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=str(spec.ROOT))
        if proc.stdout.readline().strip() != b"ready":
            raise RuntimeError("the producer did not start: "
                               + proc.communicate(timeout=30)[1].decode(errors="replace"))
        t0_mono = time.monotonic() + float(mix["warmup_s"])
        proc.stdin.write(f"{t0_mono!r}\n".encode())
        proc.stdin.flush()
        time.sleep(max(0.0, t0_mono - time.monotonic()))
        t0 = time.time()
        out["setup_end"] = time.perf_counter()
        out["mono_to_wall"] = t0 - time.monotonic()
        c0 = _window_counters(plat)
        cpu0 = _cpu_s()
        time.sleep(max(0.0, t0 + seconds - time.time()))
        t1 = time.time()
        c1 = _window_counters(plat)
        out["host_cpu"] = (f"CPU in the window: this process "
                           f"{(_cpu_s() - cpu0) / (t1 - t0):.2f} cores")
        if dev is not None:
            dev.stop()
            dev.clip(t0, t1)
        _, err = proc.communicate(timeout=seconds + 120)
        if proc.returncode != 0:
            raise RuntimeError(f"the producer failed: {err.decode(errors='replace')[-2000:]}")
        ru = resource.getrusage(resource.RUSAGE_CHILDREN)
        out["host_cpu"] += f", the producer {ru.ru_utime + ru.ru_stime:.2f} s in all"
        t_grace = time.monotonic()
        drained = plat.wait_routed(GRACE_S)
        # the router counts a batch as routed before it stamps the batch's
        # decision records: wait for each record's, to the same deadline
        missing = [i for i in range(n) if plat.audit.get(i) is None]
        while missing and time.monotonic() < t_grace + GRACE_S:
            time.sleep(0.02)
            missing = [i for i in missing if plat.audit.get(i) is None]
        out["notes"] = [f"the backlog was {'routed' if drained else 'NOT routed'}, and "
                        f"{n - len(missing)} of {n} records had a decision record, "
                        f"{time.monotonic() - t_grace:.3f} s after the window closed"]
        out["memory_peak_bytes"] = _memory_peak(plat.scorer)
        proba, tier, decided = np.full(n, np.nan), np.zeros(n, np.int8), np.full(n, np.nan)
        for i in range(n):
            rec = plat.audit.get(i)
            if rec is not None:
                p = rec.get("proba")
                proba[i] = p if isinstance(p, (int, float)) else np.nan
                tier[i] = TIERS.index(rec["tier"]) + 1 if rec.get("tier") in TIERS else 4
                decided[i] = rec.get("decided_ts", np.nan)
        reg = plat.registries.get("router")
        if reg is not None:
            counts = {n: int(reg.counter(n).total()) for n in (
                "transaction_incoming_total", "router_shed_total", "router_score_errors_total",
                "router_process_start_errors_total")}
            out["notes"].append(f"the router over the run: {counts}")
        served = {k: np.array(v) for k, v in flatten(plat.scorer.params).items()}
        dispatches = c1["dispatches"] - c0["dispatches"]
        out.update(t0=t0, t1=t1, t0_mono=t0_mono, dispatches=dispatches, trace=dev,
                   launches=[], counters=_delta(c0, c1), served=served,
                   proba=proba, tier=tier, decided=decided)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        plat.down()
        if bus is not None:
            bus.stop()
    with np.load(os.path.join(state, "producer.npz")) as z:
        out["t_send"] = z["t_send"]
    # each record is due at its arrival in the producer's schedule: the
    # window's records are those due in it, whenever the bus took them
    out["t_due"] = t0_mono - float(mix["warmup_s"]) + traffic["arrival_s"]
    backlog = n - int(np.sum(out["decided"] < out["t1"]))
    late = int(np.sum(out["t_send"] - out["t_due"] > 0.1))
    out["notes"].append(f"backlog when the window closed: {backlog} records due and not "
                        f"decided, {backlog / float(mix['rate_per_s']):.3f} s of arrivals; "
                        f"{late} records went out over 0.1 s after they were due")
    # what the reference sees: every record in produce order, and which
    # answers are judged (those due in the window, decided on the device)
    win = (out["t_due"] >= t0_mono) & (out["t_due"] < t0_mono + seconds)
    out["judged"] = np.nonzero(win & (out["tier"] == 1) & np.isfinite(out["proba"]))[0]
    out["traffic"] = {"rows": traffic["rows"], "keys": traffic["keys"],
                      "index": out["judged"]}
    by_tier = {name: int(np.sum(win & (out["tier"] == i))) for i, name in
               enumerate(("none",) + TIERS)}
    out["notes"].append(f"the window's records by the tier of their decision: {by_tier}")
    lat = out["decided"][out["judged"]] - (out["t_due"][out["judged"]] + out["mono_to_wall"])
    if len(lat):
        q = np.percentile(lat, [50, 95, 99]) * 1e3
        out["notes"].append(f"decision latency from due, ms: p50 {q[0]:.1f}, p95 {q[1]:.1f}, "
                            f"p99 {q[2]:.1f}")
    return out


def judge(out: dict, mix: dict, ref: np.ndarray, seconds: float, limits: dict) -> dict:
    t0m = out["t0_mono"]
    win = (out["t_due"] >= t0m) & (out["t_due"] < t0m + seconds)
    attempted = int(win.sum())
    decided = win & (out["tier"] > 0)
    malformed = int(np.sum(decided & ~np.isfinite(out["proba"])))
    idx = out["judged"]
    failed = attempted - len(idx)
    gap = float(np.max(np.abs(out["proba"][idx] - ref))) if len(idx) else 0.0
    rows = int(np.sum((out["tier"] == 1) & (out["decided"] >= out["t0"])
                      & (out["decided"] < out["t1"])))
    checks = {"malformed": (malformed, 0),
              "failed_share": (failed / attempted if attempted else 1.0,
                               float(limits["failed_share"])),
              "p_gap": (gap, float(limits["p_gap"]))}
    return {"checks": checks, "attempted": attempted, "failed": failed, "rows": rows,
            "judged": len(idx), "rows_per_s": rows / seconds}


@contextlib.contextmanager
def in_place(config: dict):
    """While open, every probability a seq launch hands back is the
    reference's control over the histories the launch was handed; the
    launch still runs."""
    import torch

    from ccfd_tpu_torch.serving.history import SeqScorer

    ref = spec.reference(config["name"])
    state = ref.load(config)
    launch = SeqScorer._launch

    def control_launch(self, apply_fn, params, sub, m):
        ev, _, tok = launch(self, apply_fn, params, sub, m)
        p = ref.control_histories(state, np.asarray(sub[:m], np.float32))
        return ev, torch.from_numpy(np.asarray(p, np.float32)), tok

    SeqScorer._launch = control_launch
    try:
        yield
    finally:
        SeqScorer._launch = launch


def _cpu_s() -> float:
    t = os.times()
    return t.user + t.system


def _memory_peak(scorer) -> int:
    import torch

    if scorer.device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(scorer.device))
    return 0
