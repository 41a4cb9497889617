"""A real multi-process run of the port's mesh: 2 processes x 4 CPU shards.

The port's counterpart of tools/multihost_drill.py. Each process joins a
gloo process group over a real TCP socket (``parallel/multihost.py``),
builds the global (data, model) mesh with the data axis spanning the two
processes and the model axis inside each, and then:

- runs the sharded train step (``make_train_step(tc, mesh=)``, the
  megatron layout over the model axis) on its OWN rows, its gradients
  all-reduced over the process group;
- scores its rows with the trained params and reduces the global mean;
- runs ring attention with the sequence sharded over the process-spanning
  data axis (two of the ring's edges cross the process boundary every
  rotation) and compares it with dense attention on the same inputs.

Each process prints one JSON report; the parent holds them to
``ccfd_tpu_torch/fleet/protocol.py::check_multihost_reports``: losses
finite and bit-identical across processes although each fed different
rows, the score means equal, the global batch, and ring parity within
1e-4 with the same delta everywhere.

    python tools/torch_multihost_drill.py [--topologies 2x4,4x2] [--timeout 120]

Prints one JSON line per topology and a summary; exit 0 iff every check
held. The children run on the CPU (``torch.distributed``'s gloo backend).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

N_PROCESSES = 2
LOCAL_DEVICES = 4
MODEL_PARALLEL = 2
LOCAL_ROWS = 64
STEPS = 3


def child() -> None:
    """One process of the job (its rank and the job from the environment)."""
    t0 = time.time()
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from ccfd_tpu_torch.models import mlp
    from ccfd_tpu_torch.ops.ring_attention import reference_attention, ring_attention
    from ccfd_tpu_torch.parallel import multihost
    from ccfd_tpu_torch.parallel.mesh import DATA_AXIS
    from ccfd_tpu_torch.parallel.train import TrainConfig, detached, init_state, make_train_step

    assert multihost.initialize(device="cpu") is True, "distributed init did not engage"
    pid, world = multihost.process_index(), multihost.process_count()
    assert world == int(os.environ["NUM_PROCESSES"])
    local_devices = int(os.environ["CCFD_LOCAL_DEVICES"])
    mesh = multihost.make_global_mesh(model_parallel=int(os.environ["CCFD_MODEL_PARALLEL"]),
                                      devices=[torch.device("cpu")] * local_devices)
    # the data axis spans the processes; the model axis stays inside one
    assert len(set(mesh.process_of[:, 0].tolist())) == world, "data axis does not span"
    assert all(len(set(row.tolist())) == 1 for row in mesh.process_of), "model axis spans"

    local_rows = int(os.environ["CCFD_LOCAL_ROWS"])
    rng = np.random.default_rng(1000 + pid)  # DIFFERENT rows per process
    x_local = rng.normal(size=(local_rows, 30)).astype(np.float32)
    y_local = (rng.random(local_rows) < 0.5).astype(np.float32)
    fingerprint = float(np.abs(x_local).sum())
    batch = multihost.process_local_batch_to_global(mesh, x_local)

    params = mlp.init(torch.Generator().manual_seed(0))  # the same on every process
    tc = TrainConfig()
    state = init_state(params, tc)
    step = make_train_step(tc, mesh=mesh)
    losses = []
    for _ in range(int(os.environ["CCFD_STEPS"])):
        state, loss = step(state, batch.rows, y_local)
        losses.append(float(loss))

    # the global score mean: each process scores its rows, the sums meet
    trained = detached(state["params"])
    with torch.no_grad():
        local_sum = torch.sigmoid(mlp.logits(trained, batch.rows.float(),
                                             torch.float32)).double().sum()
    dist.all_reduce(local_sum)
    score_mean = float(local_sum) / batch.global_shape[0]

    # ring attention with L sharded over the process-spanning data axis
    B, H, L, D = 4, 2, 64, 16
    ring_n = mesh.shape[DATA_AXIS]
    assert L % ring_n == 0
    rng_seq = np.random.default_rng(2000)  # the SAME inputs on every process
    q, k, v = (torch.from_numpy(rng_seq.normal(size=(B, H, L, D)).astype(np.float32))
               for _ in range(3))
    part = slice(pid * (L // world), (pid + 1) * (L // world))
    ring = ring_attention(q[:, :, part], k[:, :, part], v[:, :, part], mesh, DATA_AXIS)
    dense = reference_attention(q, k, v)[:, :, part]
    delta = (ring - dense).abs().max().reshape(1)
    dist.all_reduce(delta, op=dist.ReduceOp.MAX)

    print(json.dumps({
        "process_id": pid,
        "process_count": world,
        "global_devices": world * local_devices,
        "local_devices": local_devices,
        "mesh_shape": list(mesh.devices.shape),
        "input_fingerprint": fingerprint,
        "losses": losses,
        "score_mean": score_mean,
        "global_batch": int(batch.global_shape[0]),
        "ring_positions": ring_n,
        "ring_vs_dense_max_delta": float(delta),
        "wall_s": round(time.time() - t0, 1),
    }), flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_topology(n_processes: int, local_devices: int, model_parallel: int,
                 timeout_s: float) -> dict:
    """Run one job of ``n_processes`` x ``local_devices`` CPU shards and
    check its reports; every child is killed by the deadline."""
    port = free_port()
    procs = []
    for pid in range(n_processes):
        env = dict(os.environ)
        env.update({
            "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "NUM_PROCESSES": str(n_processes),
            "PROCESS_ID": str(pid),
            "PYTHONPATH": REPO,
            "CCFD_LOCAL_DEVICES": str(local_devices),
            "CCFD_MODEL_PARALLEL": str(model_parallel),
            "CCFD_LOCAL_ROWS": str(LOCAL_ROWS),
            "CCFD_STEPS": str(STEPS),
        })
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO))
    reports, errors = [], []
    # one budget for the job: the children run together, and a hung rank
    # hangs them all
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            p.communicate()
            errors.append("timeout")
            continue
        if p.returncode != 0:
            errors.append(err.strip()[-800:])
            continue
        reports.append(json.loads(out.strip().splitlines()[-1]))
    ok = len(reports) == n_processes and not errors
    checks: dict = {}
    if ok:
        from ccfd_tpu_torch.fleet.protocol import check_multihost_reports

        checks = check_multihost_reports(reports, n_processes, local_devices, model_parallel,
                                         local_rows=LOCAL_ROWS)
        ok = all(checks.values())
    return {"ok": ok, "processes": n_processes, "local_devices": local_devices,
            "model_parallel": model_parallel, "checks": checks, "reports": reports,
            "errors": errors}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--topologies", default=f"{N_PROCESSES}x{LOCAL_DEVICES}",
                    help="comma-separated PROCxSHARDS pairs")
    ap.add_argument("--timeout", type=float, default=120.0, help="seconds a topology")
    args = ap.parse_args(argv)
    if args.child:
        child()
        return 0
    topologies = []
    for topo in args.topologies.split(","):
        try:
            n_proc, n_dev = (int(v) for v in topo.strip().split("x"))
        except ValueError:
            ap.error(f"malformed topology {topo!r} (want PROCxSHARDS)")
        if n_proc < 2:
            ap.error(f"topology {topo!r}: the drill proves cross-process behaviour; "
                     "need >= 2 processes")
        if n_dev % MODEL_PARALLEL:
            ap.error(f"topology {topo!r}: {MODEL_PARALLEL} must divide the shards a process")
        topologies.append((n_proc, n_dev))
    runs = []
    for n_proc, n_dev in topologies:
        runs.append(run_topology(n_proc, n_dev, MODEL_PARALLEL, args.timeout))
        print(json.dumps({"topology": f"{n_proc}x{n_dev}", "ok": runs[-1]["ok"],
                          "checks": runs[-1]["checks"], "errors": runs[-1]["errors"]}),
              flush=True)
    ok = all(r["ok"] for r in runs)
    print(json.dumps({"ok": ok, "topologies": [f"{r['processes']}x{r['local_devices']}"
                                               for r in runs]}))
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
