"""The REST cells: what ``serve`` runs (``cli.build_server``: the
``PredictionServer`` on the native front, the configuration's model on its
checkpoint), on a port the OS picks, driven by ``clients`` closed-loop
clients posting ``rows_per_request``-row requests in the Seldon contract,
all in one client process (``benchmark/traffic/rest_client.py``).
"""
from __future__ import annotations

import dataclasses
import os
import resource
import subprocess
import sys
import time

import numpy as np

from benchmark.harness.spec import BENCH_DIR, ROOT
from benchmark.traffic import generator

CLIENT = BENCH_DIR / "traffic" / "rest_client.py"


class LaunchLog:
    """(wall time, rows, bucket) of each of the scorer's launches."""

    def __init__(self, scorer) -> None:
        self.items: list[tuple[float, int, int]] = []
        orig = scorer._launch

        def launch(live, chunk, b):
            self.items.append((time.time(), int(chunk.shape[0]), int(b)))
            return orig(live, chunk, b)

        scorer._launch = launch

    def between(self, t0: float, t1: float) -> list:
        return [x for x in self.items if t0 <= x[0] < t1]


def run(cell, seed: int, seconds: float, trace: bool, device, state: str,
        record: bool) -> dict:
    """One run; ``record`` takes the device's trace of the window, ``trace``
    also the scorer's launches."""
    from ccfd_tpu_torch.cli import build_server
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.utils.gctune import tune_for_service

    config, mix = cell.config, cell.mix
    n_rows, n_req = int(mix["rows_per_request"]), int(mix["requests_per_client"])
    clients = int(mix["clients"])
    if clients * n_req * n_rows > int(mix["pool_rows"]):
        raise ValueError("the clients' requests need more rows than the pool holds")
    dev = None
    if record:
        # started before anything else: the profiler's start takes seconds
        # and would otherwise fall into the traffic
        from benchmark.harness.devtrace import DeviceTrace

        dev = DeviceTrace(cuda=str(device).startswith("cuda"))
        dev.start()
    cfg = dataclasses.replace(Config(), model_name=config["model"],
                              compute_dtype=config["dtype"])
    srv = build_server(cfg, device=device, params_path=str(ROOT / config["params"]))
    tune_for_service()
    port = srv.start("127.0.0.1", 0)
    out: dict = {}
    proc = None
    try:
        launches = LaunchLog(srv.scorer) if trace else None
        files = [os.path.join(state, f"client{c}.npz") for c in range(clients)]
        env = {k: v for k, v in os.environ.items() if not k.startswith("CCFD_")}
        proc = subprocess.Popen(
            [sys.executable, str(CLIENT), "127.0.0.1", str(port), mix["path"], str(seed),
             str(mix["pool_rows"]), str(n_rows), str(n_req), str(clients),
             repr(float(seconds)), state],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=str(ROOT))
        if proc.stdout.readline().strip() != b"ready":
            raise RuntimeError("the REST clients did not start: "
                               + proc.communicate(timeout=30)[1].decode(errors="replace"))
        # every client connected: the warm-up, then the window
        t0_mono = time.monotonic() + float(mix.get("warmup_s", 2.0))
        proc.stdin.write(f"{t0_mono!r}\n".encode())
        proc.stdin.flush()
        time.sleep(max(0.0, t0_mono - time.monotonic()))
        # the window in wall time, for the device trace and the launches
        t0 = time.time()
        out["setup_end"] = time.perf_counter()
        out["mono_to_wall"] = t0 - time.monotonic()
        d0 = srv.scorer.dispatch_total()
        cpu0 = _cpu_s()
        time.sleep(max(0.0, t0 + seconds - time.time()))
        t1 = time.time()
        d1 = srv.scorer.dispatch_total()
        out["host_cpu"] = (f"CPU in the window: this process "
                           f"{(_cpu_s() - cpu0) / (t1 - t0):.2f} cores")
        if dev is not None:
            dev.stop()
            dev.clip(t0, t1)
        _, err = proc.communicate(timeout=seconds + 120)
        if proc.returncode != 0:
            raise RuntimeError(f"the REST clients failed: {err.decode(errors='replace')[-2000:]}")
        ru = resource.getrusage(resource.RUSAGE_CHILDREN)
        out["host_cpu"] += f", the client process {ru.ru_utime + ru.ru_stime:.2f} s in all"
        out.update(t0=t0, t1=t1, t0_mono=t0_mono, dispatches=d1 - d0, trace=dev,
                   launches=launches.between(t0, t1) if launches else [],
                   memory_peak_bytes=_memory_peak(srv.scorer), kernel=srv.scorer.kernel_name)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        srv.stop()
    reqs = [dict(np.load(f)) for f in files]
    out["requests"] = reqs
    out["pool"] = generator.pool(mix, seed)
    return out


def _cpu_s() -> float:
    t = os.times()
    return t.user + t.system


def _memory_peak(scorer) -> int:
    import torch

    if scorer.device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(scorer.device))
    return 0
