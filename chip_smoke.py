#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's serving path on the card and holds its CUDA kernel
against the kernel's plain PyTorch version:

  device   the card's name and count, and nvidia-smi's name and power limit
  build    nvcc builds every kernel from ccfd_tpu_torch/ops/csrc (what
           -Xptxas -v reports is printed)
  parity   kernel vs plain version on the card, H=256, on the committed
           checkpoint and on seeded random params, B in {1,16,100,1024,16384}
  serve    the port's Seldon REST server on the card (the code path of
           `python -m ccfd_tpu_torch serve`): POSTs of 1, 16, 300 and 5,000
           surrogate rows, a concurrent burst, and 5,000 rows after
           swap_params to seeded random params; each answer held against
           the plain version in p and in the logit recovered from p; the
           kernel's launches over this REST traffic alone must equal the
           scorer's dispatches; then the per-layer split of a request and a
           /prometheus scrape
  timing   the kernel and its plain version at B=16 and B=16384 (CUDA
           events over warm launches), beside the roofline bound

Run from the repository root:  python3 chip_smoke.py
It exits non-zero on any failure. On success its last two lines are a JSON
object describing each kernel and then
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

PHASES = ("device", "build", "parity", "serve", "timing")
SEED = 7
PARITY_BATCHES = (1, 16, 100, 1024, 16384)
REST_ROWS = (1, 16, 300, 5000)
TOL_P = 1e-3  # summation order differs, and a bf16 rounding of h may flip one ulp
# a flipped bf16 rounding of one h element moves z by 2^-8 of that element's
# term; the bar allows a few such flips relative to the logit's scale
TOL_Z_REL = 1e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self) -> None:
        import torch

        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

        self.torch = torch
        self.dev = torch.device("cuda:0")
        self.rows = kaggle_surrogate(n=20_000).X  # what the checkpoint saw
        self.card = ""
        self.report: dict = {
            "name": "fused_mlp_bf16", "route": "cuda",
            "source": "ccfd_tpu_torch/ops/csrc/fused_mlp.cu",
            "replaces": "ccfd_tpu/ops/fused_mlp.py:83",
            "launches": None, "max_abs_err": None, "ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None,
        }

    # -- helpers ---------------------------------------------------------
    def params(self, which: str) -> dict:
        from ccfd_tpu_torch.models import mlp
        from ccfd_tpu_torch.params import load_params

        if which == "checkpoint":
            return load_params()
        # seeded random params whose probabilities spread over (0, 1)
        g = self.torch.Generator().manual_seed(SEED)
        return mlp.set_normalizer(mlp.init(g, hidden=256),
                                  self.rows.mean(0), self.rows.std(0))

    def kernel_params(self, which: str) -> dict:
        from ccfd_tpu_torch.ops.fused_mlp import fold_for_kernel, pack_for_kernel

        return pack_for_kernel(fold_for_kernel(self.params(which)), self.dev)

    def x_rows(self, b: int):
        """The first ``b`` surrogate rows (b <= 20,000) as bf16 on the card."""
        return self.torch.from_numpy(self.rows[:b]).to(self.torch.bfloat16).to(self.dev)

    def device_ms(self, fn, n: int = 50) -> float | None:
        """Mean device time of the kernel per launch from a torch.profiler
        trace, or None when the trace holds no device events for it."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "fused_mlp_bf16_kernel" in ev.key and ev.count:
                total = getattr(ev, "device_time_total", None)
                if total is None:
                    total = getattr(ev, "cuda_time_total", 0.0)
                return total / ev.count / 1e3 if total else None
        return None

    # -- phases ----------------------------------------------------------
    def device(self) -> None:
        torch = self.torch
        self.card = nvidia_smi_line()
        log("device", f"{torch.cuda.get_device_name(0)} count="
            f"{torch.cuda.device_count()} torch={torch.__version__} "
            f"cuda={torch.version.cuda}")
        print(self.card, flush=True)

    def build(self) -> None:
        from ccfd_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load("fused_mlp")
        log("build", f"fused_mlp built and loaded in {time.perf_counter() - t0:.3f} s")
        for line in _build.ptxas_log.get("fused_mlp", "").splitlines():
            if line.strip():
                log("build", f"ptxas: {line.strip()}")

    def parity(self) -> None:
        from ccfd_tpu_torch.ops.fused_mlp import fused_mlp_reference, fused_mlp_score

        torch = self.torch
        worst = 0.0
        for which in ("checkpoint", "random"):
            kp = self.kernel_params(which)
            for b in PARITY_BATCHES:
                x = self.x_rows(b)
                p, z = fused_mlp_score(kp, x, with_logits=True)
                p_ref, z_ref = fused_mlp_reference(kp, x)
                torch.cuda.synchronize()
                dp = (p - p_ref).abs().max().item()
                dz = (z - z_ref).abs().max().item()
                zscale = max(1.0, z_ref.abs().max().item())
                flips = int(((p >= 0.5) != (p_ref >= 0.5)).sum().item())
                spread = (p_ref.min().item(), p_ref.median().item(), p_ref.max().item())
                log("parity", f"{which} B={b}: max|dp|={dp:.3e} max|dz|={dz:.3e} "
                    f"flips@0.5={flips} p[min,med,max]=({spread[0]:.3e},"
                    f"{spread[1]:.3e},{spread[2]:.3e})")
                if not (torch.isfinite(p).all() and torch.isfinite(z).all()):
                    raise AssertionError(f"non-finite kernel output ({which}, B={b})")
                if dp > TOL_P or dz > TOL_Z_REL * zscale or flips:
                    raise AssertionError(
                        f"kernel disagrees with its plain version ({which}, B={b}): "
                        f"|dp|={dp} (tol {TOL_P}), |dz|={dz} "
                        f"(tol {TOL_Z_REL * zscale}), flips={flips}")
                worst = max(worst, dp)
        self.report["max_abs_err"] = worst
        log("parity", f"ok: max|dp|={worst:.3e} <= {TOL_P}")

    def serve(self) -> None:
        import http.client

        import numpy as np

        from ccfd_tpu_torch.cli import build_server
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.ops import fused_mlp

        torch = self.torch
        # the plain version's weights: the checkpoint the server loads, and
        # the random params swapped in for the last REST check
        kps = {w: self.kernel_params(w) for w in ("checkpoint", "random")}

        def post(conn, x: np.ndarray) -> tuple[np.ndarray, float]:
            body = json.dumps({"data": {"names": [], "ndarray": x.tolist()}})
            t0 = time.perf_counter()
            conn.request("POST", "/api/v0.1/predictions", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            dt = time.perf_counter() - t0
            if resp.status != 200:
                raise AssertionError(f"POST {len(x)} rows -> HTTP {resp.status}: {out}")
            data = out["data"]
            if data["names"] != ["proba_0", "proba_1"] or len(data["ndarray"]) != len(x):
                raise AssertionError(f"bad Seldon response shape: {str(out)[:200]}")
            arr = np.asarray(data["ndarray"], np.float64)
            if not np.allclose(arr.sum(1), 1.0, atol=1e-6):
                raise AssertionError("proba_0 + proba_1 != 1")
            return arr[:, 1], dt

        def check(x: np.ndarray, p: np.ndarray, what: str,
                  which: str = "checkpoint") -> tuple[float, float, int]:
            """max |dp| and max |dz| against the plain version. The checkpoint
            saturates the sigmoid (median p ~ 3.5e-5), so |dp| alone says
            little: the logit is recovered from p wherever p is not
            saturated (float32 p holds log(p/(1-p)) to ~1e-3 there)."""
            xd = torch.from_numpy(x).to(torch.bfloat16).to(self.dev)
            p_ref, z_ref = (t.double().cpu().numpy()
                            for t in fused_mlp.fused_mlp_reference(kps[which], xd))
            dp = float(np.abs(p - p_ref).max())
            live = (p_ref > 1e-6) & (p_ref < 1 - 1e-4) & (p > 0) & (p < 1)
            z = np.log(p[live]) - np.log1p(-p[live])
            dz = float(np.abs(z - z_ref[live]).max()) if live.any() else 0.0
            tol_z = TOL_Z_REL * max(1.0, float(np.abs(z_ref).max()))
            if not np.isfinite(p).all() or dp > TOL_P or dz > tol_z:
                raise AssertionError(
                    f"{what}: |dp|={dp} (tol {TOL_P}), |dz|={dz} (tol {tol_z}) "
                    f"over {int(live.sum())} unsaturated rows, vs plain")
            return dp, dz, int(live.sum())

        cfg = Config.from_env()  # the defaults: mlp, bf16, buckets 16..16384
        t0 = time.perf_counter()
        srv = build_server(cfg, device="cuda")  # what `serve` runs
        scorer = srv.scorer
        if not scorer.fused:
            raise AssertionError("the scorer is not on the kernel path")
        log("serve", f"server built and warmed ({len(scorer.batch_sizes)} buckets) "
            f"in {time.perf_counter() - t0:.3f} s")
        port = srv.start("127.0.0.1", 0)
        try:
            fused_mlp.launches.reset()
            d0 = scorer.dispatch_total()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            for n in REST_ROWS:
                x = self.rows[:n]
                p, dt = post(conn, x)
                dp, dz, live = check(x, p, f"POST {n} rows")
                log("serve", f"POST {n} rows: {dt * 1e3:.3f} ms, vs plain max|dp| "
                    f"{dp:.3e}, max|dz| {dz:.3e} over {live} unsaturated rows")
            # concurrent clients: the batcher's workers score at once
            errs: list = []

            def client(i: int) -> None:
                try:
                    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                    for j in range(8):
                        x = self.rows[(i * 8 + j) * 16:(i * 8 + j + 1) * 16]
                        check(x, post(c, x)[0], f"client {i} request {j}")
                    c.close()
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errs.append(e)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            if errs or any(t.is_alive() for t in threads):
                raise AssertionError(f"concurrent clients failed: {errs[:3]}")
            log("serve", "8 concurrent clients x 8 requests of 16 rows: all agree with plain")
            # sequential latency of a small request, the REST front's common case
            lat = []
            for i in range(200):
                x = self.rows[i * 16:(i + 1) * 16]
                lat.append(post(conn, x)[1])
            lat_ms = np.sort(np.asarray(lat)) * 1e3
            log("serve", f"200 sequential POSTs of 16 rows: p50 {lat_ms[99]:.3f} ms, "
                f"p99 {lat_ms[197]:.3f} ms, max {lat_ms[-1]:.3f} ms on {self.card}")
            # a publish, then REST answers whose probabilities spread over (0, 1)
            scorer.swap_params(self.params("random"))
            x = self.rows[:5000]
            p, dt = post(conn, x)
            dp, dz, live = check(x, p, "POST 5000 rows, random params", "random")
            log("serve", f"swap_params to seeded random params, POST 5000 rows: "
                f"{dt * 1e3:.3f} ms, vs plain max|dp| {dp:.3e}, max|dz| {dz:.3e} "
                f"over {live} unsaturated rows, p[min,med,max]=({p.min():.3e},"
                f"{np.median(p):.3e},{p.max():.3e})")
            # the counts of the REST traffic alone, read before the direct
            # Scorer.score calls below
            launched = fused_mlp.launches.value
            dispatched = scorer.dispatch_total() - d0
            # where a request's time goes: the scorer alone (pad, host cast,
            # H2D, kernel, D2H) against the JSON work of the REST front
            for n in (16, 5000):
                x = self.rows[:n]
                body = json.dumps({"data": {"ndarray": x.tolist()}}).encode()
                t_score, t_parse, t_reply = [], [], []
                for _ in range(30):
                    t1 = time.perf_counter()
                    rows = np.asarray(json.loads(body)["data"]["ndarray"], np.float32)
                    t2 = time.perf_counter()
                    p = scorer.score(rows)
                    t3 = time.perf_counter()
                    json.dumps(srv._response_dict(np.asarray(p, np.float64), "mlp")).encode()
                    t4 = time.perf_counter()
                    t_parse.append(t2 - t1)
                    t_score.append(t3 - t2)
                    t_reply.append(t4 - t3)
                med = {k: float(np.median(v)) * 1e3 for k, v in
                       (("parse", t_parse), ("score", t_score), ("reply", t_reply))}
                log("serve", f"{n} rows, median of 30: JSON decode {med['parse']:.3f} ms, "
                    f"Scorer.score {med['score']:.3f} ms, JSON reply {med['reply']:.3f} ms "
                    f"on {self.card}")
            conn.request("GET", "/prometheus")
            resp = conn.getresponse()
            scrape = resp.read().decode()
            conn.close()
        finally:
            srv.stop()
        for series in ('seldon_api_executor_client_requests_seconds_count{endpoint="/api/v0.1/predictions"}',
                       "proba_1 ", 'ccfd_kernel_launches{kernel="fused_mlp_bf16"}'):
            if resp.status != 200 or series not in scrape:
                raise AssertionError(f"/prometheus lacks {series!r}")
        log("serve", f"REST traffic: kernel launches {launched}, scorer dispatches "
            f"{dispatched}; grid after the split timing "
            f"{scorer.executable_grid()['dispatches']}")
        if launched <= 0 or launched != dispatched:
            raise AssertionError(
                f"REST path did not go through the kernel: {launched} launches "
                f"for {dispatched} dispatches")
        self.report["launches"] = launched

    def timing(self) -> None:
        from ccfd_tpu_torch.ops.fused_mlp import fused_mlp_reference, fused_mlp_score

        torch = self.torch
        kp = self.kernel_params("checkpoint")
        hidden, feats = kp["w2"].shape[0], self.rows.shape[1]

        def time_ms(fn, n: int) -> float:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n

        for b in (16, 16384):
            x = self.x_rows(b)
            n = 1000 if b <= 1024 else 300
            ms = time_ms(lambda: fused_mlp_score(kp, x), n)
            plain_ms = time_ms(lambda: fused_mlp_reference(kp, x), n)
            ms2 = time_ms(lambda: fused_mlp_score(kp, x), n)
            ops = 2.0 * b * (feats * hidden + hidden * hidden + hidden)
            weight_bytes = sum(t.numel() * t.element_size() for t in kp.values())
            nbytes = b * feats * 2 + weight_bytes + b * 4
            t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms = max(t_ops, t_bytes)
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            kernel_ms = min(ms, ms2)
            log("timing", f"B={b}: kernel {ms:.6f} / {ms2:.6f} ms, plain {plain_ms:.6f} ms, "
                f"bound {bound_ms:.6f} ms ({bound_by}: {ops:.4e} op, {nbytes} B), "
                f"roofline share {bound_ms / kernel_ms:.4f}, over {n} launches "
                f"on {self.card}")
            dev_ms = self.device_ms(lambda: fused_mlp_score(kp, x))
            log("timing", f"B={b}: kernel device time (torch.profiler) "
                + (f"{dev_ms:.6f} ms, roofline share {bound_ms / dev_ms:.4f}"
                   if dev_ms else "not measured (no device events)")
                + f" on {self.card}")
            if b == 16384:
                self.report.update(ms=kernel_ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on the card",
              file=sys.stderr)
        return 1
    smoke = Smoke()
    for p in PHASES:
        getattr(smoke, p)()
    print(json.dumps({"kernels": [smoke.report]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
