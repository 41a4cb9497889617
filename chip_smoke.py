#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's paths on the card (training and the checkpoint round
trip into serving, the REST scorer, the decision plane, the decision
pipeline of ``python -m ccfd_tpu_torch demo`` with and without its online
trainer, the service roles as separate processes, and the reference's
other Seldon models: logreg/modelfull, the tree family, the inference
graph and the ``score`` command) and holds each CUDA kernel against its
plain PyTorch version. Each kernel's ``launches`` in the
kernels line sum the runs of the paths through it (train, serve, demo and
services; in each role process, its dispatches, read off its scrape). The
kernels: B1
``fused_mlp_bf16`` (model ``mlp``), B2 ``fused_mlp_q8`` (``mlp_q8`` on the
f32 wire) and B3 ``fused_mlp_q8_preq`` (``mlp_q8`` on the default int8
wire).

  device   the card's name and count, and nvidia-smi's name and power limit
  build    nvcc builds every kernel library from ccfd_tpu_torch/ops/csrc,
           one nvcc per source, all at once (what -Xptxas -v reports is
           printed: registers, shared memory, spills), while g++ builds the
           native host library (ccfd_tpu_torch/native: the CSV and payload
           decoders and the REST front; its time is printed); each kernel
           library's layout plan is held against its Python mirror
  parity   each kernel vs its plain version on the card (B1 within
           b1_tol_p, no flip at p = 0.5; in its wide layout also within the
           bar of an f64 evaluation with its rounding points, and a flip at
           0.5 is excused only on a row whose f64 p lies within the bar of
           0.5, where the bar cannot tell the sides apart), B in
           {1,16,100,1024,16384}: at H=256 on the committed checkpoint
           (quantized for B2/B3) and on seeded random params, and on seeded
           random params at the lifted widths (F=30 with H=1024, 2048 and
           4096 for B1, the last two in its wide layout, and H=1040 for
           B2/B3; F=128 with H=256); B3 also vs B2 on the same rows. B2 and
           B3 must equal their plain versions and each other bit for bit
  train    (a) `python -m ccfd_tpu_torch train --steps 500` on the card on the
           full Kaggle-shaped surrogate (284,807 rows): its JSON (the
           reference's keys, auc_sklearn_logreg null), wall time and
           steps/s, and the held-out AUC of its checkpoint within 0.01 of
           the committed checkpoint's on the same split, both served by the
           port; the train step's time at batch 1,024 (CUDA events around
           100 steps, and the card's busy time from a device-only trace),
           f32 and bf16, with TF32 off; (b) the same step on the card and
           on the CPU from one init over the same 20 batches, params within
           TRAIN_TOL; (c) `serve --checkpoint-dir` of that checkpoint
           through B1, `quantize --checkpoint-dir` and CCFD_MODEL=mlp_q8
           `serve` of its output through B3 and, with CCFD_Q8_WIRE=f32, B2:
           200 sequential 16-row POSTs each, every answer held against the
           plain version, launches = dispatches; (d) the demo's trained
           path (cli.build_demo: the MLP trained on the card, then served)
           with its online trainer, staged and with CCFD_FUSED_DECISION=1,
           CCFD_RETRAIN_MIN_LABELS=8: two bursts of 10,000 of its own rows,
           each followed by the trainer's next hot swap; every transaction
           routed, at least two swaps, the Scorer serving exactly the
           trainer's last params, B1 on them against its plain version at
           B=16 and 16,384, and B1's launches = scorer dispatches + plane
           dispatches + the swaps' prepublish launches; tx/s per burst, the
           router's score-stage p99, retrain_steps_total, retrain_last_loss
           and the card's idle share over the second burst (device-only
           trace)
  serve    the port's Seldon REST server on the card through its default
           transport, the C++ REST front, one path after the other, each
           with every launch count set to 0 just before it and read just
           after:
           - bf16 (`python -m ccfd_tpu_torch serve`, kernel B1);
           - int8 (`CCFD_MODEL=mlp_q8 ... serve`, kernel B3);
           - f32 wire (`CCFD_MODEL=mlp_q8 CCFD_Q8_WIRE=f32 ... serve`, B2).
           POSTs of 1, 16, 300 and 5,000 surrogate rows, a concurrent burst,
           200 sequential 16-row POSTs (p50/p99), and 5,000 rows after
           swap_params to seeded random params; each answer held against the
           plain version in p and in the logit recovered from p; the path's
           kernel launches must equal the scorer's dispatches, the other
           kernels must not launch, and the dispatch deadline's counters
           (ccfd_dispatch_timeouts_total, ccfd_device_wedged) read 0; then
           the per-layer split of a request (native and JSON decode, host
           prequantize on the int8 wire, Scorer.score, JSON reply) and a
           /prometheus scrape. Each path is served twice more on the same
           200 sequential requests, launches = dispatches each time: with
           CCFD_NATIVE_FRONT=0 (the Python transport), and with
           CCFD_DISPATCH_DEADLINE_MS=1000, where every request's dispatch
           runs on the deadline's dispatcher thread and none times out
  decision the decision plane (serving/fused.py FusedDecisionScorer) over
           a Scorer on each kernel (B1; B3 on the int8 wire; B2 on the f32
           wire) with two rule bases (the FRAUD_THRESHOLD default and a JSON
           base reading feature columns, with == and salience ties), B in
           {1,16,100,1024,16384}: proba bit-equal to the staged
           Scorer.score of the same rows, fired equal to RuleSet.evaluate on
           every row, the kernel's launches equal to the plane's
           dispatches, no staged fallback; decide against staged (score +
           host rules) a call
  demo     the decision pipeline of `python -m ccfd_tpu_torch demo`
           (cli.build_pipeline) on the card at full width (the committed
           checkpoint, 30 -> 256 -> 256 -> 1, buckets 16..16384, router
           micro-batches of up to 4,096), once staged and once with
           CCFD_FUSED_DECISION=1, each with every launch count set to 0 just
           before it: 20,000 surrogate transactions on the dict wire, then
           5,000 on the CSV wire, then a swap_params to seeded random params
           (the checkpoint routes 26 of these rows to fraud, too few to
           reach every branch of the fraud process) and 5,000 more, without
           the online trainer (the train phase runs it), as fast
           as the bus takes them (the last part under a device-only
           torch.profiler trace: the card's busy time and idle share), 2 s
           reply timeout. Every transaction must
           be routed, with no score or start error, into both processes and
           both DMN outcomes; B1's launches must equal the scorer's
           dispatches (router and prediction service) plus the plane's;
           transactions/s, the router's decision and score-stage p50/p99 and
           the dispatches per bucket are printed; and the router's CSV
           decode (decode_records, the router.decode span's work) of a
           4,096-row batch through the native decoder against the plain one
  services the reference's service roles as processes, `python -m
           ccfd_tpu_torch bus|engine|router|notify|producer` on free
           loopback ports (BROKER_URL, KIE_SERVER_URL), the router with its
           production wiring (degradation ladder, overload control, tracing
           at 2%), every figure read off the roles' /prometheus and the
           engine's /rest/metrics; the producer streams the checkpoint's
           surrogate rows on its default CSV wire:
           (a) one router worker on the card, 20,000 rows: every row
               routed once and started in the engine, no score error,
               degraded row or shed; B1's launches in the router process =
               its Scorer's dispatches + one warmup launch per bucket;
               tx/s, decision and score-stage p50/p99 and the tracer's
               router.batch/decode/score/route span quantiles;
           (b) the same with CCFD_ROUTER_WORKERS=0 (a worker per
               partition, coalescing on): every worker made batches and
               the coalesced dispatches are no more than the batches;
           (c) the ladder: the router on SELDON_URL -> a `serve` process
               on the card (its C++ REST front); 4,000 rows, then the serve
               process is killed, 4,000 rows more at 2,000/s, then it is
               restarted and 6,000 rows stream at 2,000/s: the rows the
               serve processes scored plus the rules tier's equal the rows
               produced, the rules tier took every row produced while serve
               was down and the host tier none (the reference's role has no
               host tier on SELDON_URL), the breaker opened and closed, and
               each serve process's B1 launches = its dispatches + its warmup;
           (d) the durable roles' crash drill: `bus --dir D`, `engine
               --state-file S --save-interval-s 1` (2 s reply timeout), the
               router on the card (one worker, a rule base that also sends
               amounts of 500 and more to the fraud process, so the engine
               holds open processes and investigator tasks) and notify;
               4,000 rows; the bus SIGKILLed and restarted on the same port
               and D: the topic's end offsets and the router group's
               committed offsets equal to theirs before the kill, the router
               and notify having exited on the dead bus as the reference's
               roles do (their restart policy brings them back: the drill
               restarts them); 4,000 rows; the engine SIGTERMed and
               restarted on S: its active instances and open tasks (REST)
               equal to theirs before the stop; 4,000 rows; then the bus
               killed once more and restarted with CCFD_BUS_FSYNC=1 for a
               last 4,000-row burst. Every row routed once and started once
               (summed over the processes' lifetimes), no score error,
               degraded row or shed, each router process's B1 launches = its
               dispatches + its warmup; the bus's reopen time (to its health
               answer, and the replay its start-up line reports), the
               engine's save and load ms and snapshot bytes, and tx/s of
               each burst, with fsync and without, against part (a)'s
               memory bus;
           (e) the router's edges under CCFD_FAULTS="scorer:error=0.1,
               corrupt=0.05;engine:latency=1,jitter=2" (and
               CCFD_CLIENT_RETRIES=0, so every injected fault reaches the
               ladder): the router on SELDON_URL -> a `serve` process on the
               card, 10,000 rows at 2,000/s: every row routed once and started once,
               the rules tier took exactly the rows whose scorer call failed
               or was refused, the host tier none (the reference's role has
               none on SELDON_URL; a local Scorer's router would send them
               to its host tier), the rows the card scored lie between the
               rows routed on its answers and those plus the failed calls'
               (an injected error fires before the POST; a corruption after
               the kernel ran), faults_injected_total > 0 for scorer/error,
               scorer/corrupt and engine/latency, every probability the
               engine holds finite, serve's B1 launches = its dispatches +
               its warmup, and the breaker's transitions printed;
           (f) three `router` processes on the card (one worker each) in
               one consumer group over the bus's partitions, 20,000 rows:
               every row routed and started once, each process took rows,
               each process's B1 launches = its dispatches + its warmup;
               tx/s against part (a)'s one worker and part (b)'s three
               threads (the fan-out);
           every role's start-up line shows its gen-0 GC threshold (the
           reference's service tuning), printed per role
  platform the platform operator (platform/operator.py, platform/k8s.py):
           (1) `manifests`: the port's documents for its CR against the
               reference's (deploy/k8s, its own `manifests` output for
               deploy/platform_cr.yaml): the same files, every document
               equal but for the container command, the image and the
               scorer's nvidia.com/gpu limit;
           (2) `python -m ccfd_tpu_torch up -f <the port's CR>
               --exit-after-producer` as a process on the card (free
               ports, the store seeding the dataset, bus log and recovery
               cut in a temp dir, scorer mlp trained 200 steps on the card
               and on REST, engine crash recovery, 20,000 transactions):
               while it runs, 50 16-row POSTs within b1_tol_p of B1's plain
               version on the served params (retrained here from the same
               seed; the params' sha256 equal to the one `up` prints),
               /healthz 200 and healthy, /profile with the bus, router.*
               and REST stages (queue, service and dispatch parts each),
               /debug/device with cuda:0's memory, H2D bytes and copies and
               B1's bucket inventory, the SLO burn-rate gauges; after it
               exits 0, from its final registries: incoming = routed =
               engine starts = 20,000, B1 launches = dispatches + warmup,
               and no build while serving;
           (3) an in-process Platform on the card (the port's CR, REST on):
               an engine failure injected mid-stream (supervisor.
               inject_failure) restores the last cut and re-drives the gap,
               then down() and up() again on the same log dir and cut file
               restore the saved cut at bring-up: every one of 30,000
               transactions started exactly once (the engine's next_pid),
               the restored cut equal to the saved one; the restore ms and
               the cut's bytes; REST answers against the plain version on
               the live kernel params; B1 launches = dispatches + warmup;
           (4) the operator pipeline with the producer at 2,000/s and at
               8,000/s for 10 s each (memory bus, the seeded MLP on B1):
               decision p50/p99 against the 10 ms limit, the profiler's bus
               queue, decode and route service and score dispatch, the H2D
               copies' device time apart from host work, and the card's
               busy share from a device-only torch.profiler trace
  models   the reference's other Seldon models, torch code on the card (no
           hand kernel: the reference leaves them to XLA):
           (a) card against CPU, the same port function, B=16 and 16,384:
               logreg (bf16 and f32, the IRLS fit of the surrogate rows) and
               graph_ensemble.json (bf16 and f32) within 1e-5 in p; gbt and
               gbt_mxu on the committed ensemble (checkpoints_gbt) and a
               seeded depth-8 one (quantile thresholds, dead slots), on rows
               1% of which hold a NaN or +/-inf cell: every leaf index equal
               to the CPU's, z within 1e-5 a tree, gbt_mxu within 1e-6 of
               gbt on the card; a hash_split ROUTER graph: the card's arms
               against the numpy mirror and the CPU, a differing row
               excused only within 4 float32 ulps of |h| of a boundary (the
               count and each margin printed), p on the rows routed alike;
           (b) CCFD_MODEL=gbt (what `serve` builds) on the reference's
               held-out split of the full surrogate: AUC within 1e-4 of the
               reference's recorded auc_hgb_served;
           (c) `serve` with CCFD_MODEL=modelfull, gbt and CCFD_GRAPH_CR on
               the C++ front, 200 sequential 16-row POSTs each against the
               CPU (1e-5), p50/p99, no hand-kernel launch;
           (d) `score` with CCFD_MODEL=gbt over 20,000 rows on the card and
               the CPU: rows, tx/s, the proba files within 1e-5;
           (e) device ms a call at B=16 and 16,384 (a CUDA graph of
               back-to-back calls: each function captures) for logreg,
               gbt, gbt_mxu, the ensemble graph and its mlp node, beside a
               bound from bytes and operations; gbt_mxu's peak memory; and
               B1 on the ensemble's mlp node params, the yardstick for
               that node
  timing   each kernel and its plain version at B=16 and B=16384 at the
           served H=256, beside the roofline bound: the kernel's device
           time from CUDA events around a CUDA graph of back-to-back
           launches (and torch.profiler's by the kernel's own name), its
           time a call through the Python wrapper, and the plain version's
           a call; and at B=16384 B1 at H=1,024, 2,048 and 4,096 and B2/B3
           at their widest H (1,040)

Run from the repository root:  python3 chip_smoke.py
It exits non-zero on any failure. On success its last two lines are a JSON
object describing each kernel and then
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

PHASES = ("device", "build", "parity", "train", "serve", "decision", "demo", "services",
          "platform", "models", "timing")
REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 7
PARITY_BATCHES = (1, 16, 100, 1024, 16384)
# (name, features, hidden): random-params parity cases beyond the served H=256
WIDE_B1 = (("F=30 H=1024", 30, 1024), ("F=30 H=2048", 30, 2048),
           ("F=30 H=4096", 30, 4096), ("F=128 H=256", 128, 256))
B1_TIMED_WIDTHS = (1024, 2048, 4096)
WIDE_Q8 = (("F=30 H=1040", 30, 1040), ("F=128 H=256", 128, 256))
REST_ROWS = (1, 16, 300, 5000)
# the decision phase's second rule base: feature columns (a between over
# Amount, a V14 compare, an == on an Amount the rows hold), salience ties
# (two rules at 10, kept in authoring order) and a default rule
JSON_RULES = [
    {"name": "small_sure", "process": "standard", "salience": 20,
     "when": [{"field": "Amount", "op": "between", "value": [0.0, 50.0]},
              {"field": "proba", "op": "<", "value": 0.9}]},
    {"name": "v14_low", "process": "fraud", "salience": 10,
     "when": [{"field": "V14", "op": "<", "value": -1.5},
              {"field": "proba", "op": ">=", "value": 0.3}]},
    {"name": "fraud", "process": "fraud", "salience": 10,
     "when": [{"field": "proba", "op": ">=", "value": 0.5}]},
    {"name": "amount_eq", "process": "fraud", "salience": 25,
     "when": [{"field": "Amount", "op": "==", "value": None}]},  # set from the rows
    {"name": "standard", "process": "standard"},
]
DEMO_PARTS = (("dict", 20_000), ("csv", 5_000))  # then the swap and 5,000 dict rows
DEMO_AFTER_SWAP = 5_000
DEMO_REPLY_TIMEOUT_S = 2.0
SERVICES_ROWS = 20_000  # the producer role's default dataset, on its default CSV wire
TX_TOPIC = "odh-demo"  # the producer's and the router's topic (Config's default)
# rows before the serve process dies, then paced rows while it is down (many
# small batches, so the breaker's window sees the failures) and after its
# restart (until the breaker has closed)
LADDER_PARTS = (4_000, 4_000)
LADDER_RATE_ROWS, LADDER_RATE = 6_000, 2_000.0
# part (d): each burst's rows; the engine's reply timeout, so a silent
# customer's case reaches the DMN and an investigator task within a burst's
# quiet time; the rule base (the default threshold rule, and amounts of 500
# and more to the fraud process as well: an issuer's large-amount rule)
DURABLE_ROWS = 4_000
DURABLE_REPLY_TIMEOUT_S = 2.0
DURABLE_RULES = [
    {"name": "fraud", "process": "fraud", "salience": 10,
     "when": [{"field": "proba", "op": ">=", "value": 0.5}]},
    {"name": "large_amount", "process": "fraud", "salience": 10,
     "when": [{"field": "Amount", "op": ">=", "value": 500.0}]},
    {"name": "standard", "process": "standard"},
]
# part (e): rows, paced (many small batches, so the plan draws on many
# scorer calls), and the router's standing fault plan
FAULT_ROWS, FAULT_RATE = 10_000, 2_000.0
FAULT_PLAN = "scorer:error=0.1,corrupt=0.05;engine:latency=1,jitter=2"
# the platform phase: the port's CR, `up -f` of it, its crash drill and
# its fixed-rate runs
PORT_CR = "ccfd_tpu_torch/assets/platform_cr.yaml"
PLATFORM_ROWS = 20_000
PLATFORM_TRAIN_STEPS = 200
PLATFORM_POSTS = 50  # 16-row POSTs while `up` serves
RECOVERY_ROWS = (20_000, 10_000)  # before and after the engine failure
FIXED_RATES = (2_000, 8_000)  # producer rows/s
FIXED_SECONDS = 10
# the train phase: `train`'s default steps and fit_mlp's batch; the steps
# timed on the card; the steps run on the card and on the CPU from one init
TRAIN_STEPS = 500
TRAIN_BATCH = 1024
TIMED_TRAIN_STEPS = 100
COMPARE_STEPS = 20
# card against CPU after COMPARE_STEPS steps, max |d param|: the two sides
# sum in different orders (cuBLAS with TF32 off against the CPU's BLAS),
# and in bf16 a gradient element may round to the other side of a bf16
# boundary (2^-8 of it); a step moves a weight by lr (1e-3) times its
# momentum trace, so each such flip moves it by ~1e-6 or less
TRAIN_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
AUC_BAR = 0.01  # |held-out AUC of `train`'s step - the committed checkpoint's|
TRAIN_KEYS = {"checkpoint", "rows", "steps", "source", "test_rows", "auc_mlp",
              "auc_sklearn_logreg"}  # what the reference's `train` prints
# the demo with online retrain: two bursts of the demo's own rows, each
# followed by the trainer's next swap; the trainer's bar, lowered so that a
# burst's labels (the fraud cases the customers answer) clear it
RETRAIN_PARTS = (10_000, 10_000)
RETRAIN_MIN_LABELS = 8
TIMING_BATCHES = (16, 16384)
SEQ_POSTS = 200  # sequential 16-row POSTs a serving run times
DEADLINE_MS = 1000  # the serve phase's run with the dispatch deadline armed
DEADLINE_SERIES = ("ccfd_dispatch_timeouts_total", "ccfd_device_wedged")
# the models phase (the reference's other Seldon models): card against CPU
# on the same port function. logreg and graphs sum 30 (or the mlp node's)
# products in another order: 1e-5 in p. A tree ensemble reaches the same
# leaves on both devices and sums T float32 leaf values in another order:
# 1e-5 of z a tree; the gather-free evaluation sums like the gather form on
# one device (models/trees.py): 1e-6.
MODEL_BATCHES = (16, 16384)
MODEL_TOL_P = 1e-5
TREE_TOL_Z = 1e-5  # times the number of trees
MXU_TOL_Z = 1e-6
NONFINITE_ROWS = 0.01  # share of the tree rows given a NaN or +/-inf cell
SEEDED_TREES = 64  # the seeded depth-8 ensemble (data-quantile thresholds)
DEAD_SLOTS = 0.25  # share of its internal slots left dead (threshold +inf)
# `python -m ccfd_tpu train --family hgb` (the reference, full surrogate,
# depth 8) printed auc_hgb_served 0.9641 for checkpoints_gbt/params.npz
RECORDED_AUC_HGB = 0.9641
AUC_HGB_BAR = 1e-4
SCORE_ROWS = 20_000
GRAPH_CR = "deploy/model/graph_ensemble.json"
# a hash_split ROUTER over the committed ensemble and a clipped logreg
ROUTED_CR = {"metadata": {"name": "smoke-routed"}, "spec": {"predictors": [{"graph": {
    "name": "ab", "type": "ROUTER", "implementation": "hash_split",
    "parameters": [{"name": "weights", "value": "[0.7, 0.3]", "type": "JSON"}],
    "children": [
        {"name": "trees", "type": "MODEL", "implementation": "gbt"},
        {"name": "clipped", "type": "TRANSFORMER", "implementation": "clip",
         "parameters": [{"name": "lo", "value": "-50", "type": "FLOAT"},
                        {"name": "hi", "value": "500", "type": "FLOAT"}],
         "children": [{"name": "modelfull", "type": "MODEL"}]}]}}]}}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # float32 outside the tensor cores, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet
INT8_OPS = 1979e12  # dense int8 tensor-core peak, NVIDIA data sheet
# the CUDA cores: 132 SMs x 128 f32 lanes at the 1.98 GHz boost clock
CUDA_CORE_INSTR_PER_S = 132 * 128 * 1.98e9
# an IEEE f32 division (div.rn) is a reciprocal estimate plus Newton and
# fix-up steps on the CUDA cores: taken as 10 instructions (an estimate)
DIV_INSTR = 10


KERNELS = {
    "fused_mlp_bf16": {
        "source": "ccfd_tpu_torch/ops/csrc/fused_mlp.cu",
        "replaces": "ccfd_tpu/ops/fused_mlp.py:83",
        # summation order differs, and a bf16 rounding of h may flip one
        # ulp; a flipped rounding of one h element moves z by 2^-8 of its
        # term, so z's bar allows a few flips relative to the logit's scale.
        # tol_p holds up to H=256; wider, see b1_tol_p
        "tol_p": 1e-3, "tol_z_rel": 1e-2,
    },
    "fused_mlp_q8": {
        "source": "ccfd_tpu_torch/ops/csrc/fused_mlp_q8.cu",
        "replaces": "ccfd_tpu/ops/fused_mlp_q8.py:124",
        # kernel and plain version round at the same points and sum
        # integers exactly: parity is bit for bit. Over REST, the reference's
        # own bar (tests/test_fused_q8.py:33) on p; z recovered from a
        # float32 p carries ~6e-4 near p = 1 - 1e-4
        "exact": True, "tol_p": 1e-5, "tol_z_rel": 1e-3,
    },
    "fused_mlp_q8_preq": {
        "source": "ccfd_tpu_torch/ops/csrc/fused_mlp_q8.cu",
        "replaces": "ccfd_tpu/ops/fused_mlp_q8.py:275",
        "exact": True, "tol_p": 1e-5, "tol_z_rel": 1e-3,
    },
}
# B3 runs B2's body from layer 1 on: bit for bit (the reference's bar,
# tests/test_fused_q8.py:93, is 1e-6)
# the device kernel each wrapper launches, as torch.profiler names it
DEVICE_NAMES = {"fused_mlp_bf16": "fused_mlp_bf16_kernel",
                "fused_mlp_q8": "fused_mlp_q8_kernel",
                "fused_mlp_q8_preq": "fused_mlp_q8_preq_kernel"}


def b1_tol_p(hidden: int) -> float:
    """B1's bar in p against its plain version: 1e-3 up to H=256. Each row
    rounds 2H values of h to bf16; the roundings that the two sides' f32
    summation orders flip grow with H and add to z like a random walk, so
    wider the bar grows as sqrt(H / 256). The parity phase logs how far
    each side lies from an f64 evaluation with the same rounding points."""
    return KERNELS["fused_mlp_bf16"]["tol_p"] * max(1.0, hidden / 256) ** 0.5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def scrape(url: str) -> dict:
    """A Prometheus text scrape as {"name{labels}": value}."""
    with urllib.request.urlopen(url, timeout=10) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def hist_quantile(m: dict, name: str, q: float, labels: str = "") -> float:
    """Bucket-interpolated quantile of a scraped histogram (what
    histogram_quantile computes), over the series whose labels hold
    ``labels``."""
    cells = []
    for key, v in m.items():
        if key.startswith(name + "_bucket{") and labels in key:
            le = key.split('le="', 1)[1].split('"', 1)[0]
            cells.append((float("inf") if le == "+Inf" else float(le), v))
    cells.sort()
    if not cells or cells[-1][1] == 0:
        return float("nan")
    rank = q * cells[-1][1]
    prev_ub, prev_c = 0.0, 0.0
    for ub, c in cells:
        if c >= rank:
            if ub == float("inf"):
                return prev_ub
            return prev_ub + (ub - prev_ub) * ((rank - prev_c) / (c - prev_c) if c > prev_c
                                               else 1.0)
        prev_ub, prev_c = ub, c
    return prev_ub


def post(conn, x) -> tuple:
    """One Seldon POST of the rows ``x``: (proba_1, seconds)."""
    import numpy as np

    # the canonical Seldon payload, which the native front decodes in C++ (a
    # names key, even an empty one, takes the Python route)
    body = json.dumps({"data": {"ndarray": x.tolist()}})
    t0 = time.perf_counter()
    conn.request("POST", "/api/v0.1/predictions", body, {"Content-Type": "application/json"})
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


def rest_check(kernel: str, plain, x, p, what: str) -> tuple:
    """max |dp| and max |dz| of REST answers ``p`` against the plain version
    ``plain(x)`` -> (p, z), and the rows compared in z. A checkpoint
    saturates the sigmoid (median p ~ 3e-5), so |dp| alone says little:
    the logit is recovered from p wherever p is not saturated (float32 p
    holds log(p/(1-p)) to ~1e-3 there)."""
    import numpy as np

    tol_p, tol_z_rel = KERNELS[kernel]["tol_p"], KERNELS[kernel]["tol_z_rel"]
    p_ref, z_ref = (t.double().cpu().numpy() for t in plain(x))
    dp = float(np.abs(p - p_ref).max())
    live = (p_ref > 1e-6) & (p_ref < 1 - 1e-4) & (p > 0) & (p < 1)
    z = np.log(p[live]) - np.log1p(-p[live])
    dz = float(np.abs(z - z_ref[live]).max()) if live.any() else 0.0
    tol_z = tol_z_rel * max(1.0, float(np.abs(z_ref).max()))
    if not np.isfinite(p).all() or dp > tol_p or dz > tol_z:
        raise AssertionError(
            f"{what}: |dp|={dp} (tol {tol_p}), |dz|={dz} (tol {tol_z}) "
            f"over {int(live.sum())} unsaturated rows, vs plain")
    return dp, dz, int(live.sum())


def sequential_posts(conn, rows, n: int) -> tuple:
    """``n`` sequential 16-row POSTs of ``rows``: (answers, sorted
    latencies ms)."""
    import numpy as np

    got, lat = [], []
    for i in range(n):
        x = rows[i * 16:(i + 1) * 16]
        p, dt = post(conn, x)
        got.append((x, p))
        lat.append(dt)
    return got, np.sort(np.asarray(lat)) * 1e3


def quantiles(lat_ms) -> str:
    import numpy as np

    return (f"p50 {np.percentile(lat_ms, 50):.3f} ms, p99 "
            f"{np.percentile(lat_ms, 99):.3f} ms, max {lat_ms[-1]:.3f} ms")


def same_params(a: dict, b: dict) -> bool:
    """Two MLP param trees hold the same values, bit for bit, wherever their
    tensors lie."""
    def leaves(t: dict) -> list:
        return [t["norm"][k] for k in sorted(t["norm"])] + [
            layer[k] for layer in t["layers"] for k in sorted(layer)]

    return len(a["layers"]) == len(b["layers"]) and all(
        x.shape == y.shape and bool((x.cpu() == y.cpu()).all())
        for x, y in zip(leaves(a), leaves(b)))


def pipe_settled(pipe, n: int, what: str) -> float:
    """Seconds until the in-process pipeline has consumed ``n`` transactions
    and disposed of each (routed, or a score or start error)."""
    rr = pipe.reg_router
    incoming = rr.counter("transaction_incoming_total")
    out = rr.counter("transaction_outgoing_total")
    score_err = rr.counter("router_score_errors_total")
    start_err = rr.counter("router_process_start_errors_total")
    t0 = time.perf_counter()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        done = out.total() + score_err.value() + start_err.total()
        if incoming.value() >= n and done >= n:
            return time.perf_counter() - t0
        time.sleep(0.002)
    raise AssertionError(f"{what}: {incoming.value()} of {n} consumed, {out.total()} routed "
                         f"after 120 s")


def launches_of(m: dict) -> float:
    return m.get('ccfd_kernel_launches{kernel="fused_mlp_bf16"}', 0.0)


def check_conservation(tag: str, m: dict, kie: dict, produced: int,
                       healthy: bool = True) -> None:
    """Every produced row consumed and started in exactly one process, the
    engine's starts equal to the router's; on a healthy run no score error,
    degraded row or shed."""
    incoming = m.get("transaction_incoming_total", 0.0)
    fraud = m.get('transaction_outgoing_total{type="fraud"}', 0.0)
    standard = m.get('transaction_outgoing_total{type="standard"}', 0.0)
    started = sum(v for k, v in kie.items() if k.startswith("process_instances_started_total"))
    degraded = sum(v for k, v in m.items() if k.startswith("router_degraded_total"))
    fails = []
    if not incoming == produced == fraud + standard == started:
        fails.append(f"produced {produced}, incoming {incoming}, routed {fraud} fraud + "
                     f"{standard} standard, engine starts {started}")
    counts = {c: m.get(c, 0.0) for c in ("router_shed_total", "router_score_errors_total",
                                         "router_process_start_errors_total")}
    counts["router_degraded_total"] = degraded
    bad = {c: v for c, v in counts.items()
           if v and (healthy or c in ("router_shed_total", "router_process_start_errors_total"))}
    if bad:
        fails.append(f"nonzero {bad}")
    if fails:
        raise AssertionError(f"{tag}: " + "; ".join(fails))
    log("services", f"{tag}: produced {produced} = incoming {incoming:.0f} = routed "
        f"{fraud:.0f} fraud + {standard:.0f} standard = engine starts {started:.0f}; "
        + ", ".join(f"{c} {v:.0f}" for c, v in counts.items()))


class Roles:
    """One part's service roles, each ``python -m ccfd_tpu_torch <role>`` on
    free loopback ports, wired by BROKER_URL and KIE_SERVER_URL. Leaving
    the block stops every process it started (SIGTERM, then SIGKILL), and
    on an error prints the tail of each role's log."""

    def __init__(self, card: str, csv: str) -> None:
        self.card = card
        self.bport, self.kport, self.rport, self.nport = (free_port() for _ in range(4))
        self.burl = f"http://127.0.0.1:{self.bport}"
        self.kurl = f"http://127.0.0.1:{self.kport}"
        self.rurl = f"http://127.0.0.1:{self.rport}"
        self.env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.env.update(PYTHONPATH=REPO, BROKER_URL=f"http://127.0.0.1:{self.bport}",
                        KIE_SERVER_URL=self.kurl, CCFD_CSV=csv)
        self.dir = tempfile.mkdtemp(prefix="ccfd_roles_")
        self.procs: dict = {}

    def __enter__(self) -> "Roles":
        return self

    def stop(self) -> None:
        """SIGTERM every process still running, SIGKILL what outlives 20 s."""
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in self.procs.values():
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
        if exc_type is not None:
            for name in self.procs:
                with open(os.path.join(self.dir, f"{name}.log"), errors="replace") as f:
                    tail = f.read()[-3000:]
                print(f"--- {name} log (tail) ---\n{tail}", flush=True)
        shutil.rmtree(self.dir, ignore_errors=True)

    def spawn(self, name: str, role: str, *args: str, extra_env: dict | None = None):
        log_file = open(os.path.join(self.dir, f"{name}.log"), "w")
        p = subprocess.Popen([sys.executable, "-m", "ccfd_tpu_torch", role, *args], cwd=REPO,
                             env={**self.env, **(extra_env or {})}, stdout=log_file,
                             stderr=subprocess.STDOUT)
        log_file.close()
        self.procs[name] = p
        return p

    @staticmethod
    def wait(url: str, proc, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"{proc.args[3:]} exited {proc.returncode}")
            try:
                urllib.request.urlopen(url, timeout=2).read()
                return
            except OSError:
                time.sleep(0.05)
        raise AssertionError(f"{url} did not come up in {timeout} s")

    def gc_thresholds(self) -> dict:
        """Each role's gen-0 GC threshold, from its start-up line (None
        where the line lacks it)."""
        import re

        out = {}
        for name in self.procs:
            with open(os.path.join(self.dir, f"{name}.log"), errors="replace") as f:
                found = re.search(r"gc_threshold=(\d+)", f.read())
            out[name] = int(found.group(1)) if found else None
        return out

    def backbone(self, bus_args: tuple = (), engine_args: tuple = (),
                 engine_env: dict | None = None) -> None:
        """bus, then engine and notify."""
        self.spawn_bus("bus", *bus_args)
        self.spawn_engine("engine", *engine_args, extra_env=engine_env)
        self.spawn_notify("notify")

    def spawn_bus(self, name: str, *args: str, extra_env: dict | None = None) -> float:
        """The bus role under ``name``; returns the seconds to its health
        answer."""
        t0 = time.perf_counter()
        bus = self.spawn(name, "bus", "--host", "127.0.0.1", "--port", str(self.bport), *args,
                         extra_env=extra_env)
        self.wait(f"{self.burl}/health/status", bus, 60)
        return time.perf_counter() - t0

    def spawn_engine(self, name: str, *args: str, extra_env: dict | None = None) -> None:
        engine = self.spawn(name, "engine", "--host", "127.0.0.1", "--port", str(self.kport),
                            *args, extra_env=extra_env)
        self.wait(f"{self.kurl}/health/status", engine, 60)

    def spawn_notify(self, name: str) -> None:
        notify = self.spawn(name, "notify", "--metrics-port", str(self.nport),
                            "--seed", str(SEED))
        self.wait(f"http://127.0.0.1:{self.nport}/prometheus", notify, 60)

    def log_text(self, name: str) -> str:
        with open(os.path.join(self.dir, f"{name}.log"), errors="replace") as f:
            return f.read()

    def exited(self, name: str, timeout: float) -> int:
        """The exit code of ``name``, waited for up to ``timeout`` s."""
        try:
            return self.procs[name].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{name} still running after {timeout} s") from None

    def get(self, url: str):
        with urllib.request.urlopen(url, timeout=60) as r:
            return json.loads(r.read())

    def bus_rows(self) -> int:
        with urllib.request.urlopen(f"{self.burl}/topics/{TX_TOPIC}/offsets", timeout=10) as r:
            return sum(json.loads(r.read()))

    def produce(self, n: int, rate: float | None = None) -> float:
        """The producer role: ``n`` rows of its default dataset on its
        default (CSV) wire, paced at ``rate`` rows/s when given. Returns the
        host clock when its first row reached the bus (the producer's own
        start-up and dataset load come before it)."""
        args = ["producer", "--limit", str(n)] + (["--rate", str(rate)] if rate else [])
        base = self.bus_rows()
        proc = subprocess.Popen([sys.executable, "-m", "ccfd_tpu_torch", *args], cwd=REPO,
                                env=self.env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        first = None
        while first is None and proc.poll() is None:
            if self.bus_rows() > base:
                first = time.perf_counter()
            else:
                time.sleep(0.002)
        err = proc.communicate(timeout=600)[1]
        if proc.returncode != 0 or f"streamed {n} rows" not in err:
            raise AssertionError(f"producer exited {proc.returncode}: {err[-2000:]}")
        return first if first is not None else time.perf_counter()

    def settled(self, total: int, t0: float) -> float:
        """Seconds from ``t0`` until the router has consumed and disposed of
        ``total`` rows (read off its exporter every 20 ms)."""
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            m = scrape(f"{self.rurl}/prometheus")
            done = sum(v for k, v in m.items() if k.startswith((
                "transaction_outgoing_total", "router_shed_total",
                "router_process_start_errors_total")))
            if m.get("transaction_incoming_total", 0.0) >= total and done >= total:
                return time.perf_counter() - t0
            time.sleep(0.02)
        raise AssertionError(f"{total} rows not routed after 180 s: {m}")


class Smoke:
    def __init__(self) -> None:
        import torch

        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

        self.torch = torch
        self.dev = torch.device("cuda:0")
        ds = kaggle_surrogate(n=20_000)  # what the checkpoint saw
        self.rows, self.labels = ds.X, ds.y
        self.card = ""
        self.reports = {
            name: {"name": name, "route": "cuda", "source": k["source"],
                   "replaces": k["replaces"], "launches": 0, "max_abs_err": None,
                   "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
                   "library_ms": None}
            for name, k in KERNELS.items()}

    # -- helpers ---------------------------------------------------------
    def wide_rows(self, features: int):
        """The surrogate rows widened (or cut) to ``features`` columns by
        repeating them."""
        import numpy as np

        reps = -(-features // self.rows.shape[1])
        return np.ascontiguousarray(np.concatenate([self.rows] * reps, axis=1)[:, :features])

    def params(self, which: str, features: int = 30, hidden: int = 256) -> dict:
        """The f32 MLP: the committed checkpoint, or seeded random params
        whose probabilities spread over (0, 1)."""
        from ccfd_tpu_torch.models import mlp
        from ccfd_tpu_torch.params import load_params

        if which == "checkpoint":
            return load_params()
        g = self.torch.Generator().manual_seed(SEED)
        rows = self.wide_rows(features)
        return mlp.set_normalizer(mlp.init(g, num_features=features, hidden=hidden),
                                  rows.mean(0), rows.std(0))

    def q8_params(self, which: str, features: int = 30, hidden: int = 256) -> dict:
        from ccfd_tpu_torch.ops import quant

        return quant.quantize_mlp(self.params(which, features, hidden))

    def kernel_params(self, which: str, features: int = 30, hidden: int = 256) -> dict:
        from ccfd_tpu_torch.ops.fused_mlp import fold_for_kernel, pack_for_kernel

        return pack_for_kernel(fold_for_kernel(self.params(which, features, hidden)), self.dev)

    def q8_kernel_params(self, which: str, features: int = 30, hidden: int = 256) -> dict:
        from ccfd_tpu_torch.ops.fused_mlp_q8 import fold_for_kernel, pack_for_kernel

        return pack_for_kernel(fold_for_kernel(self.q8_params(which, features, hidden)),
                               self.dev)

    def x_rows(self, b: int, dtype=None, features: int = 30):
        """The first ``b`` surrogate rows (b <= 20,000), widened to
        ``features``, on the card, bf16 unless ``dtype`` says otherwise."""
        dtype = dtype or self.torch.bfloat16
        return self.torch.from_numpy(self.wide_rows(features)[:b]).to(dtype).to(self.dev)

    def preq_rows(self, kp: dict, x_np):
        """B3's inputs: the host's int8 rows and scales, on the card."""
        from ccfd_tpu_torch.ops.fused_mlp_q8 import prequantize_rows_numpy

        host = {k: kp[k].cpu() for k in ("mu", "sigma")}
        q, s = prequantize_rows_numpy(host, x_np)
        return (self.torch.from_numpy(q).to(self.dev),
                self.torch.from_numpy(s).to(self.dev))

    def b1_f64(self, kp: dict, x):
        """B1's arithmetic in float64 with the kernel's rounding points (h
        rounded to bf16 after each relu): p with no summation-order noise."""
        torch = self.torch
        d = lambda t: t.double()  # noqa: E731
        h = torch.relu(d(x) @ d(kp["w1"][: x.shape[1]]) + d(kp["b1"])).to(torch.bfloat16)
        h = torch.relu(d(h) @ d(kp["w2"]) + d(kp["b2"])).to(torch.bfloat16)
        return torch.sigmoid((d(h) * d(kp["w3"])).sum(1) + d(kp["b3"]))

    def counters(self) -> dict:
        from ccfd_tpu_torch.serving.server import KERNEL_LAUNCHES

        return {c.kernel: c for c in KERNEL_LAUNCHES}

    def device_ms(self, fn, kernel: str, n: int = 50) -> float | None:
        """Mean device time per launch of the device kernel named
        ``kernel`` from a torch.profiler trace, or None when the trace
        holds no device events for it."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if kernel in ev.key and ev.count:
                total = getattr(ev, "device_time_total", None)
                if total is None:
                    total = getattr(ev, "cuda_time_total", 0.0)
                return total / ev.count / 1e3 if total else None
        return None

    def compare(self, name: str, what: str, p, z, p_ref, z_ref,
                tol_p: float | None = None, undecided=None) -> float:
        """Hold one kernel output against its plain version; returns max|dp|.
        ``undecided`` (B1's wide layout): rows whose f64 evaluation lies
        within ``tol_p`` of 0.5, where the bar cannot tell the two sides of
        the threshold apart; a flip there is logged, not failed."""
        torch = self.torch
        tol_p = KERNELS[name]["tol_p"] if tol_p is None else tol_p
        tol_z = KERNELS[name]["tol_z_rel"]
        dp = (p - p_ref).abs().max().item()
        dz = (z - z_ref).abs().max().item()
        zscale = max(1.0, z_ref.abs().max().item())
        flipped = (p >= 0.5) != (p_ref >= 0.5)
        excused = 0
        if undecided is not None:
            excused = int((flipped & undecided).sum().item())
            flipped = flipped & ~undecided
        flips = int(flipped.sum().item())
        spread = (p_ref.min().item(), p_ref.median().item(), p_ref.max().item())
        log("parity", f"{name} {what}: max|dp|={dp:.3e} max|dz|={dz:.3e} "
            f"flips@0.5={flips} p[min,med,max]=({spread[0]:.3e},"
            f"{spread[1]:.3e},{spread[2]:.3e})"
            + (f"; rows with f64 p within the bar of 0.5: "
               f"{int(undecided.sum().item())}, the two sides straddle 0.5 on {excused}"
               if undecided is not None else ""))
        if not (torch.isfinite(p).all() and torch.isfinite(z).all()):
            raise AssertionError(f"non-finite {name} output ({what})")
        if KERNELS[name].get("exact"):
            if not (torch.equal(p, p_ref) and torch.equal(z, z_ref)):
                raise AssertionError(
                    f"{name} is not bit-equal to its plain version ({what}): "
                    f"|dp|={dp}, |dz|={dz}")
        elif dp > tol_p or dz > tol_z * zscale or flips:
            raise AssertionError(
                f"{name} disagrees with its plain version ({what}): |dp|={dp} "
                f"(tol {tol_p}), |dz|={dz} (tol {tol_z * zscale}), flips={flips}")
        return dp

    # -- phases ----------------------------------------------------------
    def device(self) -> None:
        torch = self.torch
        self.card = nvidia_smi_line()
        log("device", f"{torch.cuda.get_device_name(0)} count="
            f"{torch.cuda.device_count()} torch={torch.__version__} "
            f"cuda={torch.version.cuda}")
        print(self.card, flush=True)

    def build(self) -> None:
        from ccfd_tpu_torch import native
        from ccfd_tpu_torch.ops import _build, fused_mlp, fused_mlp_q8

        t0 = time.perf_counter()
        host = threading.Thread(target=native.lib)  # g++ beside the nvccs
        host.start()
        _build.build(_build.SOURCES)
        for name in _build.SOURCES:
            _build.load(name)
        host.join()
        native.lib()  # raises here with g++'s output if its build failed
        log("build", f"{', '.join(_build.SOURCES)} built in parallel and loaded "
            f"in {time.perf_counter() - t0:.3f} s")
        log("build", f"native host library ({' '.join(native.SOURCES)}) built by "
            f"{native.compiler()} {' '.join(native.flags())} in "
            f"{native.build_seconds:.3f} s: {native.library_path().name}")
        for name in _build.SOURCES:
            for line in _build.ptxas_log.get(name, "").splitlines():
                if line.strip():
                    log("build", f"{name} ptxas: {line.strip()}")
        # the layout each library computes, against the Python mirror the
        # CPU tests check
        for mod, shapes in ((fused_mlp, ((30, 256), (30, 1024), (30, 2048), (30, 4096),
                                         (128, 256))),
                            (fused_mlp_q8, ((30, 256), (30, 1040), (128, 256)))):
            for f, h in shapes:
                got = mod.kernel_plan(f, h)
                want = {k: mod.plan(f, h)[k] for k in got}
                if got != want:
                    raise AssertionError(f"{mod.__name__} plan F={f} H={h}: {got} != {want}")
                log("build", f"{mod.__name__.rsplit('.', 1)[-1]} F={f} H={h}: {got}")

    def parity(self) -> None:
        from ccfd_tpu_torch.ops import fused_mlp_q8 as q8
        from ccfd_tpu_torch.ops.fused_mlp import (
            MAX_RESIDENT_H1,
            fused_mlp_reference,
            fused_mlp_score,
        )

        torch = self.torch
        worst = dict.fromkeys(KERNELS, 0.0)
        served = (("checkpoint", 30, 256), ("random", 30, 256))
        for which, f, h in served + tuple(("random",) + c[1:] for c in WIDE_B1):
            kp = self.kernel_params(which, f, h)
            for b in PARITY_BATCHES:
                x = self.x_rows(b, features=f)
                p, z = fused_mlp_score(kp, x, with_logits=True)
                p_ref, z_ref = fused_mlp_reference(kp, x)
                torch.cuda.synchronize()
                what = f"{which} F={f} H={h} B={b}"
                p64 = self.b1_f64(kp, x) if which == "random" else None
                wide = h > MAX_RESIDENT_H1
                undecided = (p64 - 0.5).abs() <= b1_tol_p(h) if wide else None
                dp = self.compare("fused_mlp_bf16", what, p, z, p_ref, z_ref, b1_tol_p(h),
                                  undecided)
                if p64 is not None:
                    d64 = (p.double() - p64).abs().max().item()
                    log("parity", f"fused_mlp_bf16 {what}: vs an f64 evaluation with the "
                        f"same rounding points, max|dp| kernel {d64:.3e}, plain "
                        f"{(p_ref.double() - p64).abs().max().item():.3e}")
                    if wide and d64 > b1_tol_p(h):
                        raise AssertionError(
                            f"fused_mlp_bf16 ({what}) lies {d64} from the f64 evaluation "
                            f"(bar {b1_tol_p(h)})")
                worst["fused_mlp_bf16"] = max(worst["fused_mlp_bf16"], dp)
        for which, f, h in served + tuple(("random",) + c[1:] for c in WIDE_Q8):
            kq = self.q8_kernel_params(which, f, h)
            for b in PARITY_BATCHES:
                what = f"{which} F={f} H={h} B={b}"
                xf = self.x_rows(b, torch.float32, features=f)
                q, s = self.preq_rows(kq, self.wide_rows(f)[:b])
                p2, z2 = q8.fused_mlp_q8_score(kq, xf, with_logits=True)
                p3, z3 = q8.fused_mlp_q8_score_preq(kq, q, s, with_logits=True)
                r2 = q8.fused_mlp_q8_reference(kq, xf)
                r3 = q8.fused_mlp_q8_preq_reference(kq, q, s)
                torch.cuda.synchronize()
                dp2 = self.compare("fused_mlp_q8", what, p2, z2, *r2)
                dp3 = self.compare("fused_mlp_q8_preq", what, p3, z3, *r3)
                same = torch.equal(p3, p2) and torch.equal(z3, z2)
                log("parity", f"B3 vs B2 {what}: bit-equal {same}")
                if not same:
                    raise AssertionError(f"B3 is not bit-equal to B2 ({what})")
                worst["fused_mlp_q8"] = max(worst["fused_mlp_q8"], dp2)
                worst["fused_mlp_q8_preq"] = max(worst["fused_mlp_q8_preq"], dp3)
        for name, w in worst.items():
            self.reports[name]["max_abs_err"] = w
            bar = ("0 (bit-equal)" if KERNELS[name].get("exact")
                   else f"{KERNELS[name]['tol_p']} (H<=256; sqrt(H/256) times it wider; "
                        f"past H={MAX_RESIDENT_H1} also within the bar of the f64 "
                        f"evaluation, and a flip at 0.5 only where that evaluation lies "
                        f"within the bar of 0.5)")
            log("parity", f"ok: {name} max|dp|={w:.3e} <= {bar}")
        log("parity", "ok: B3 bit-equal to B2 at every case")

    def train(self) -> None:
        """(a) `train` on the card and its held-out AUC against the committed
        checkpoint's; the train step's device time; (b) the train step on
        the card against the CPU; (c) the trained step served through B1,
        then quantized and served through B3 and B2; (d) the demo's trained
        path with the online trainer hot-swapping B1's params."""
        torch = self.torch
        if torch.backends.cuda.matmul.allow_tf32 or \
                torch.get_float32_matmul_precision() != "highest":
            raise AssertionError("TF32 is on for float32 matmuls: the f32 path would "
                                 "round its operands to 10 mantissa bits")
        log("train", "TF32 off for float32 matmuls (allow_tf32 False, precision 'highest')")
        tmp = tempfile.mkdtemp(prefix="ccfd_train_")
        try:
            ck = os.path.join(tmp, "checkpoints_torch")
            self.train_command(ck)
            self.train_step_timing()
            self.train_card_vs_cpu()
            self.train_served(ck, os.path.join(tmp, "q8.npz"))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.train_demo()

    def train_command(self, ck: str) -> None:
        """(a) ``python -m ccfd_tpu_torch train`` on the full surrogate."""
        from ccfd_tpu_torch.cli import held_out_split
        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
        from ccfd_tpu_torch.models import mlp
        from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
        from ccfd_tpu_torch.params import MLP_LIKE, load_params, to_device
        from ccfd_tpu_torch.utils.metrics_math import roc_auc

        torch = self.torch
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "CCFD_SURROGATE_ROWS", "CCFD_CSV")}
        env["PYTHONPATH"] = REPO
        cmd = ["train", "--steps", str(TRAIN_STEPS), "--checkpoint-dir", ck]
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "ccfd_tpu_torch", *cmd], cwd=REPO,
                             env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"train exited {out.returncode}: {out.stderr[-3000:]}")
        doc = json.loads(out.stdout.strip().splitlines()[-1])
        fit = [ln for ln in out.stderr.splitlines() if ln.startswith("[train] fit_mlp")]
        log("train", f"python -m ccfd_tpu_torch {' '.join(cmd)}: {json.dumps(doc)}")
        log("train", f"the command took {wall:.3f} s (process start, the surrogate, fit, "
            f"held-out AUC, checkpoint): {TRAIN_STEPS / wall:.1f} steps/s over the whole "
            f"command; {fit[0] if fit else 'no fit line'} on {self.card}")
        if (set(doc) != TRAIN_KEYS or doc["auc_sklearn_logreg"] is not None
                or doc["steps"] != TRAIN_STEPS or doc["rows"] != 284_807 or not fit
                or doc["checkpoint"] != os.path.join(ck, f"step_{TRAIN_STEPS}")):
            raise AssertionError(f"train printed {doc}")
        # the held-out AUC of the trained step and of the committed
        # checkpoint, served by the port on the same split
        ds = kaggle_surrogate()
        test = held_out_split(ds.n, 0.2)[0]
        x = torch.from_numpy(ds.X[test]).to(self.dev)
        trained, step = CheckpointManager(ck).restore(MLP_LIKE)
        auc = {name: roc_auc(ds.y[test], mlp.apply(to_device(p, self.dev), x).cpu().numpy())
               for name, p in (("trained", trained), ("committed", load_params()))}
        log("train", f"held-out AUC on {len(test)} rows, served by the port on the card: "
            f"step {step} of `train` {auc['trained']:.6f}, the committed checkpoint "
            f"{auc['committed']:.6f} (|d| {abs(auc['trained'] - auc['committed']):.6f}, "
            f"bar {AUC_BAR})")
        if abs(auc["trained"] - doc["auc_mlp"]) > 1e-4 or \
                abs(auc["trained"] - auc["committed"]) > AUC_BAR:
            raise AssertionError(f"held-out AUC {auc} against train's {doc['auc_mlp']}")

    def train_batches(self, n: int, seed: int = SEED) -> list:
        """``n`` class-balanced batches of TRAIN_BATCH surrogate rows (CPU
        tensors), drawn as fit_mlp draws them."""
        import numpy as np

        torch = self.torch
        rng = np.random.default_rng(seed)
        pos, neg = np.flatnonzero(self.labels == 1), np.flatnonzero(self.labels == 0)
        n_pos = TRAIN_BATCH // 4
        out = []
        for _ in range(n):
            idx = np.concatenate([rng.choice(pos, n_pos), rng.choice(neg, TRAIN_BATCH - n_pos)])
            out.append((torch.from_numpy(self.rows[idx]),
                        torch.from_numpy(self.labels[idx].astype(np.float32))))
        return out

    def train_step_timing(self) -> None:
        """The train step on the card at full width (30 -> 256 -> 256 -> 1),
        batch 1,024, f32 and bf16: CUDA events around TIMED_TRAIN_STEPS
        steps on batches already on the card, and the card's busy time over
        the same steps from a device-only trace; then fit_mlp's rate over as
        many steps."""
        from torch.profiler import ProfilerActivity, profile

        from ccfd_tpu_torch.parallel.train import (
            TrainConfig,
            fit_mlp,
            init_state,
            make_train_step,
        )
        from ccfd_tpu_torch.params import to_device

        torch = self.torch
        batches = [(x.to(self.dev), y.to(self.dev))
                   for x, y in self.train_batches(TIMED_TRAIN_STEPS)]
        # forward and backward: 3 matmul passes of 2 * B * (F*H + H*H + H)
        flop = 3 * 2.0 * TRAIN_BATCH * (30 * 256 + 256 * 256 + 256)
        for dtype in ("float32", "bfloat16"):
            tc = TrainConfig(compute_dtype=dtype)
            state = init_state(to_device(self.params("random"), self.dev), tc)
            step = make_train_step(tc)
            for x, y in batches[:10]:
                state, loss = step(state, x, y)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for x, y in batches:
                state, loss = step(state, x, y)
            end.record()
            end.synchronize()
            wall = (time.perf_counter() - t0) / len(batches) * 1e3
            ms = start.elapsed_time(end) / len(batches)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for x, y in batches:
                    state, loss = step(state, x, y)
                torch.cuda.synchronize()
            busy = sum(getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0.0)
                       for e in prof.key_averages()) / 1e3 / len(batches)
            top = sorted(((getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0.0), e.key)
                          for e in prof.key_averages()), reverse=True)[:4]
            log("train", f"train step {dtype}, batch {TRAIN_BATCH}, H=256: {ms:.6f} ms a step "
                f"(CUDA events around {len(batches)} steps; host clock {wall:.6f}); device "
                f"busy {busy:.6f} ms a step (torch.profiler), top kernels "
                + "; ".join(f"{k[:48]} {t / 1e3 / len(batches):.6f} ms" for t, k in top)
                + f"; {flop:.4e} flop a step, {flop / 67e12 * 1e3:.6f} ms at the f32 peak "
                f"(67 TFLOP/s), loss {float(loss):.6f} on {self.card}"
                if busy else f"train step {dtype}: {ms:.6f} ms a step (CUDA events); device "
                f"busy time not measured (no device events in the trace)")
        # fit_mlp in this warm process: the step plus the numpy batch draw
        # and its copy to the card, without a fresh process's first use of
        # each CUDA kernel, which the `train` command's fit time includes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_mlp(self.rows, self.labels, steps=TIMED_TRAIN_STEPS,
                tc=TrainConfig(compute_dtype="float32"), device=self.dev)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        log("train", f"fit_mlp (float32) in this warm process: {TIMED_TRAIN_STEPS} steps of "
            f"{TRAIN_BATCH} rows in {fit_s:.3f} s, {TIMED_TRAIN_STEPS / fit_s:.1f} steps/s, "
            f"host clock, on {self.card}")

    def train_card_vs_cpu(self) -> None:
        """(b) the same train step on the card and on the CPU, from one init
        over the same COMPARE_STEPS batches."""
        from ccfd_tpu_torch.parallel.train import (
            TrainConfig,
            detached,
            init_state,
            make_train_step,
            trainable,
        )
        from ccfd_tpu_torch.params import to_device

        torch = self.torch
        batches = self.train_batches(COMPARE_STEPS, seed=SEED + 1)
        init = self.params("random")
        for dtype in ("float32", "bfloat16"):
            tc = TrainConfig(compute_dtype=dtype)
            got, losses = {}, {}
            for side, dev in (("card", self.dev), ("cpu", torch.device("cpu"))):
                state = init_state(to_device(init, dev), tc)
                step = make_train_step(tc)
                for x, y in batches:
                    state, loss = step(state, x, y)
                got[side] = [t.cpu() for t in trainable(detached(state["params"]))]
                losses[side] = float(loss)
            d = max((a - b).abs().max().item() for a, b in zip(got["card"], got["cpu"]))
            moved = max((a - b.cpu()).abs().max().item()
                        for a, b in zip(got["cpu"], trainable(init)))
            log("train", f"{dtype} train step, card against CPU after {COMPARE_STEPS} steps "
                f"from one init: max |d param| {d:.3e} (bar {TRAIN_TOL[dtype]}; the params "
                f"moved up to {moved:.3e}), last loss {losses['card']:.6f} / "
                f"{losses['cpu']:.6f}")
            if not d <= TRAIN_TOL[dtype] or not moved > TRAIN_TOL[dtype]:
                raise AssertionError(f"{dtype} train step: card and CPU differ by {d}")

    def train_served(self, ck: str, q8: str) -> None:
        """(c) the trained step through the three kernels over REST: `serve
        --checkpoint-dir` (B1), then `quantize --checkpoint-dir` and
        CCFD_MODEL=mlp_q8 `serve` on the int8 wire (B3) and the f32 wire
        (B2); each SEQ_POSTS sequential 16-row POSTs, launches = dispatches,
        answers held against the plain version."""
        import io

        from ccfd_tpu_torch import cli
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.ops import fused_mlp, fused_mlp_q8
        from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
        from ccfd_tpu_torch.params import MLP_LIKE, load_params

        torch = self.torch
        step, _ = CheckpointManager(ck).restore(MLP_LIKE)
        srv = cli.build_server(Config.from_env(), device="cuda", checkpoint_dir=ck)
        if not same_params(srv.scorer.params, step):
            raise AssertionError("serve --checkpoint-dir does not serve the trained step")
        kp = fused_mlp.pack_for_kernel(fused_mlp.fold_for_kernel(step), self.dev)

        def b1_plain(x):
            xd = torch.from_numpy(x).to(torch.bfloat16).to(self.dev)
            return fused_mlp.fused_mlp_reference(kp, xd)

        self.served_run("fused_mlp_bf16", "serve --checkpoint-dir", srv, b1_plain)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["quantize", "--checkpoint-dir", ck, "--out", q8])
        doc = json.loads(out.getvalue().strip().splitlines()[-1])
        log("train", f"quantize --checkpoint-dir: {json.dumps(doc)}")
        if rc != 0 or doc["source_step"] != TRAIN_STEPS:
            raise AssertionError(f"quantize --checkpoint-dir exited {rc}: {doc}")
        kq = fused_mlp_q8.pack_for_kernel(fused_mlp_q8.fold_for_kernel(load_params(q8)),
                                          self.dev)

        def q8_plain(x):
            q, s = self.preq_rows(kq, x)
            return fused_mlp_q8.fused_mlp_q8_preq_reference(kq, q, s)

        for kernel, env in (("fused_mlp_q8_preq", {"CCFD_MODEL": "mlp_q8"}),
                            ("fused_mlp_q8", {"CCFD_MODEL": "mlp_q8", "CCFD_Q8_WIRE": "f32"})):
            srv = cli.build_server(Config.from_env({**os.environ, **env}), device="cuda",
                                   params_path=q8)
            self.served_run(kernel, f"{' '.join(f'{k}={v}' for k, v in env.items())} serve "
                            f"--params <quantize's output>", srv, q8_plain)

    def served_run(self, kernel: str, what: str, srv, plain) -> None:
        """SEQ_POSTS sequential 16-row POSTs to ``srv`` on its default
        transport: every answer against ``plain``, the kernel's launches
        equal to the scorer's dispatches, no other kernel launched."""
        import http.client

        grid = srv.scorer.executable_grid()
        if not srv.scorer.fused or grid["int8_wire"] != (kernel == "fused_mlp_q8_preq"):
            raise AssertionError(f"{what}: the scorer is not on the {kernel} path: {grid}")
        counters = self.counters()
        port = srv.start("127.0.0.1", 0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            for c in counters.values():
                c.reset()
            d0 = srv.scorer.dispatch_total()
            seq, lat = sequential_posts(conn, self.rows, SEQ_POSTS)
            launched = {k: c.value for k, c in counters.items()}
            dispatched = srv.scorer.dispatch_total() - d0
            conn.close()
        finally:
            srv.stop()
        worst = max(rest_check(kernel, plain, x, p, f"{what}, 16-row POST")[0] for x, p in seq)
        if launched[kernel] != dispatched or dispatched != SEQ_POSTS or any(
                v for k, v in launched.items() if k != kernel):
            raise AssertionError(f"{what}: launches {launched} for {dispatched} dispatches")
        self.reports[kernel]["launches"] += launched[kernel]
        log("train", f"{what} ({kernel}, {srv.transport}): {SEQ_POSTS} sequential POSTs of 16 "
            f"rows, {quantiles(lat)}; max |dp| vs plain {worst:.3e}; launches "
            f"{launched[kernel]} = dispatches {dispatched} on {self.card}")

    def train_demo(self) -> None:
        """(d) the demo's trained path (`cli.build_demo` without params: the
        MLP trained on the card) with the online trainer, staged and with
        CCFD_FUSED_DECISION=1: RETRAIN_PARTS bursts of its own rows, each
        followed by the trainer's next hot swap into B1."""
        import dataclasses

        from torch.profiler import ProfilerActivity, profile

        from ccfd_tpu_torch.cli import build_demo
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import Dataset
        from ccfd_tpu_torch.ops.fused_mlp import (
            fold_for_kernel,
            fused_mlp_reference,
            fused_mlp_score,
            pack_for_kernel,
        )
        from ccfd_tpu_torch.ops.fused_mlp import launches as b1_launches
        from ccfd_tpu_torch.producer.producer import Producer

        torch = self.torch
        total = sum(RETRAIN_PARTS)
        for armed in (False, True):
            tag = f"retrain demo {'plane' if armed else 'staged'}"
            env = {**os.environ, "CCFD_FUSED_DECISION": "1" if armed else "0",
                   "CCFD_RETRAIN_MIN_LABELS": str(RETRAIN_MIN_LABELS)}
            cfg = dataclasses.replace(Config.from_env(env),
                                      customer_reply_timeout_s=DEMO_REPLY_TIMEOUT_S)
            t0 = time.perf_counter()
            pipe = build_demo(cfg, total, device=str(self.dev), seed=SEED)
            plane, trainer = pipe.decision, pipe.trainer
            if trainer is None or (plane is not None) != armed:
                raise AssertionError(f"{tag}: trainer {trainer}, plane {plane}")
            ds = pipe.producer.dataset
            log("train", f"{tag}: CCFD_RETRAIN_MIN_LABELS={cfg.retrain_min_labels}, "
                f"retrain batch {cfg.retrain_batch}, trainer {trainer.tc.compute_dtype} on "
                f"{trainer.device}; dataset {ds.n} rows ({int(ds.y.sum())} fraud), the MLP "
                f"trained and the pipeline built in {time.perf_counter() - t0:.3f} s")
            swaps = pipe.reg_retrain.counter("retrain_param_swaps_total")
            for c in self.counters().values():
                c.reset()
            d0 = (pipe.scorer.dispatch_total(), plane.dispatch_total() if plane else 0,
                  plane.warm_dispatches if plane else 0)
            produced, busy, window = 0, 0.0, 0.0
            pipe.start(poll_timeout_s=0.02)
            try:
                for i, n in enumerate(RETRAIN_PARTS):
                    part = Producer(cfg, pipe.broker, Dataset(X=ds.X[produced:produced + n],
                                                              y=ds.y[produced:produced + n]))
                    traced = i == len(RETRAIN_PARTS) - 1
                    with (profile(activities=[ProfilerActivity.CUDA]) if traced
                          else contextlib.nullcontext()) as prof:
                        t0 = time.perf_counter()
                        produced += part.run(limit=n)
                        dt = (time.perf_counter() - t0) + pipe_settled(pipe, produced, tag)
                        deadline = time.monotonic() + 30
                        while swaps.value() < i + 1 and time.monotonic() < deadline:
                            time.sleep(0.01)
                        waited = time.perf_counter() - t0
                    log("train", f"{tag}: part {i + 1}, {n} transactions routed in {dt:.3f} s: "
                        f"{n / dt:.1f} transactions/s end to end; swap {i + 1} at "
                        f"{waited:.3f} s; on {self.card}")
                    if traced:
                        window = waited
                        busy = sum(getattr(e, "self_device_time_total", None)
                                   or getattr(e, "self_cuda_time_total", 0.0)
                                   for e in prof.key_averages()) / 1e6
                time.sleep(DEMO_REPLY_TIMEOUT_S + 1.0)  # the no-reply timers fire
            finally:
                pipe.stop()
            launched = b1_launches.value
            others = {k: c.value for k, c in self.counters().items()
                      if k != "fused_mlp_bf16" and c.value}
            staged_d = pipe.scorer.dispatch_total() - d0[0]
            plane_d = plane.dispatch_total() - d0[1] if plane is not None else 0
            warm_d = plane.warm_dispatches - d0[2] if plane is not None else 0
            summary = pipe.summary()
            rr, reg = pipe.reg_router, pipe.reg_retrain
            score_h = rr.histogram("router_score_seconds")
            log("train", f"{tag}: summary {json.dumps(summary)}")
            log("train", f"{tag}: retrain_steps_total "
                f"{reg.counter('retrain_steps_total').value():.0f}, retrain_last_loss "
                f"{reg.gauge('retrain_last_loss').value():.6f}, labels "
                f"{trainer.labels_seen}; router score stage p50 "
                f"{score_h.quantile(0.5) * 1e3:.3f} ms p99 {score_h.quantile(0.99) * 1e3:.3f} "
                f"ms ({score_h.count()} batches); the last part under a device-only trace "
                + (f"({window:.3f} s to its swap): device busy {busy * 1e3:.3f} ms, idle "
                   f"share {1 - busy / window:.4f}" if busy else "held no device events")
                + f" on {self.card}")
            # the Scorer serves exactly what the trainer last published
            live = pipe.scorer.params
            same = same_params(live, trainer.params)
            fails = []
            routed = summary["fraud_routed"] + summary["standard_routed"]
            if summary["transactions"] != produced or routed != produced:
                fails.append(f"{produced} produced, {summary['transactions']} incoming, "
                             f"{routed} routed")
            if rr.counter("router_score_errors_total").value() or \
                    rr.counter("router_process_start_errors_total").total():
                fails.append("score or start errors")
            if summary["retrain_swaps"] < 2 or not same:
                fails.append(f"retrain_swaps {summary['retrain_swaps']}, the Scorer serves "
                             f"the trainer's last params: {same}")
            if launched != staged_d + plane_d + warm_d or others or not launched:
                fails.append(f"B1 launches {launched} != scorer dispatches {staged_d} + plane "
                             f"{plane_d} + prepublish {warm_d}; other kernels {others}")
            if fails:
                raise AssertionError(f"{tag}: " + "; ".join(fails))
            log("train", f"ok: {tag}: {produced} transactions routed, "
                f"{summary['retrain_swaps']} swaps; B1 launches {launched} = scorer dispatches "
                f"{staged_d} + plane {plane_d} + prepublish {warm_d} "
                f"({summary['retrain_swaps']} swaps x the plane's buckets)" if plane else
                f"ok: {tag}: {produced} transactions routed, {summary['retrain_swaps']} swaps; "
                f"B1 launches {launched} = scorer dispatches {staged_d}")
            self.reports["fused_mlp_bf16"]["launches"] += launched
            # B1 on the retrained params against its plain version
            kp = pack_for_kernel(fold_for_kernel(live), self.dev)
            for b in (16, 16384):
                x = torch.from_numpy(ds.X[:b]).to(torch.bfloat16).to(self.dev)
                p, z = fused_mlp_score(kp, x, with_logits=True)
                self.compare("fused_mlp_bf16", f"{tag} retrained params B={b}", p, z,
                             *fused_mlp_reference(kp, x), b1_tol_p(256))

    def serve(self) -> None:
        from ccfd_tpu_torch.ops import fused_mlp, fused_mlp_q8

        def bf16_plain(which: str):
            kp = self.kernel_params(which)

            def plain(x):
                xd = self.torch.from_numpy(x).to(self.torch.bfloat16).to(self.dev)
                return fused_mlp.fused_mlp_reference(kp, xd)
            return plain

        def q8_plain(which: str):
            kq = self.q8_kernel_params(which)

            def plain(x):
                q, s = self.preq_rows(kq, x)
                return fused_mlp_q8.fused_mlp_q8_preq_reference(kq, q, s)
            return plain

        self.serve_path("fused_mlp_bf16", {}, bf16_plain, self.params("random"))
        self.serve_path("fused_mlp_q8_preq", {"CCFD_MODEL": "mlp_q8"}, q8_plain,
                        self.q8_params("random"))
        self.serve_path("fused_mlp_q8", {"CCFD_MODEL": "mlp_q8", "CCFD_Q8_WIRE": "f32"},
                        q8_plain, self.q8_params("random"))

    def serve_path(self, kernel: str, env: dict, plain_of, swap_to: dict) -> None:
        """One serving path over REST: ``build_server`` with the config
        ``env`` gives (the code path of ``serve`` under that environment,
        through its default transport, the C++ front), every request held
        against the plain version ``plain_of(which)``, and the path's kernel
        launches held against the dispatches; then the same path on the
        Python transport and with the dispatch deadline armed."""
        import http.client

        import numpy as np

        from ccfd_tpu_torch import native
        from ccfd_tpu_torch.cli import build_server
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.ops.fused_mlp_q8 import fold_for_kernel, prequantize_rows_numpy

        plains = {w: plain_of(w) for w in ("checkpoint", "random")}
        tag = f"serve {kernel}"

        def check(x: np.ndarray, p: np.ndarray, what: str,
                  which: str = "checkpoint") -> tuple[float, float, int]:
            return rest_check(kernel, plains[which], x, p, what)

        def sequential(conn, n: int) -> tuple[list, np.ndarray]:
            return sequential_posts(conn, self.rows, n)

        def deadline_zero(m: dict, what: str) -> dict:
            """The dispatch deadline's counters: each present and 0."""
            got = {c: m.get(c) for c in DEADLINE_SERIES}
            if any(v != 0.0 for v in got.values()):
                raise AssertionError(f"{what}: dispatch deadline counters {got}, want 0")
            return got

        cfg = Config.from_env({**os.environ, **env})  # what `serve` reads
        t0 = time.perf_counter()
        srv = build_server(cfg, device="cuda")  # what `serve` runs
        scorer = srv.scorer
        grid = scorer.executable_grid()
        if not scorer.fused or grid["int8_wire"] != (kernel == "fused_mlp_q8_preq"):
            raise AssertionError(f"the scorer is not on the {kernel} path: {grid}")
        if srv.transport != "native-front" or grid["dispatch_deadline_ms"]:
            raise AssertionError(f"{tag}: not the default serving path: transport "
                                 f"{srv.transport}, {grid}")
        log(tag, f"{' '.join(f'{k}={v}' for k, v in env.items()) or 'default env'}: "
            f"model {grid['model']}, int8_wire {grid['int8_wire']}, transport "
            f"{srv.transport}, server built and warmed ({len(scorer.batch_sizes)} buckets) "
            f"in {time.perf_counter() - t0:.3f} s")
        counters = self.counters()
        port = srv.start("127.0.0.1", 0)
        try:
            for c in counters.values():
                c.reset()
            d0 = scorer.dispatch_total()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            for n in REST_ROWS:
                x = self.rows[:n]
                p, dt = post(conn, x)
                dp, dz, live = check(x, p, f"POST {n} rows")
                log(tag, f"POST {n} rows: {dt * 1e3:.3f} ms, vs plain max|dp| "
                    f"{dp:.3e}, max|dz| {dz:.3e} over {live} unsaturated rows")
            # concurrent clients: the front's scorer threads score at once
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
            log(tag, "8 concurrent clients x 8 requests of 16 rows: all agree with plain")
            # sequential latency of a small request, the REST front's common case
            seq, lat_native = sequential(conn, SEQ_POSTS)
            for x, p in seq:
                check(x, p, "sequential 16-row POST")
            log(tag, f"native front: {SEQ_POSTS} sequential POSTs of 16 rows: "
                f"{quantiles(lat_native)} on {self.card}")
            # a publish, then REST answers whose probabilities spread over (0, 1)
            scorer.swap_params(swap_to)
            x = self.rows[:5000]
            p, dt = post(conn, x)
            dp, dz, live = check(x, p, "POST 5000 rows, random params", "random")
            log(tag, f"swap_params to seeded random params, POST 5000 rows: "
                f"{dt * 1e3:.3f} ms, vs plain max|dp| {dp:.3e}, max|dz| {dz:.3e} "
                f"over {live} unsaturated rows, p[min,med,max]=({p.min():.3e},"
                f"{np.median(p):.3e},{p.max():.3e})")
            # the counts of this path's REST traffic alone, read before the
            # direct Scorer.score calls below
            launched = {k: c.value for k, c in counters.items()}
            dispatched = scorer.dispatch_total() - d0
            # where a request's time goes: the scorer alone (pad, host cast
            # or host prequantize, H2D, kernel, D2H) against the decode and
            # reply work
            for n in (16, 5000):
                x = self.rows[:n]
                body = json.dumps({"data": {"ndarray": x.tolist()}}).encode()
                b = scorer.bucket(n)
                norm = fold_for_kernel(scorer.params) if scorer.int8_wire else None
                t_nat, t_parse, t_preq, t_score, t_reply = [], [], [], [], []
                for _ in range(30):
                    t1 = time.perf_counter()
                    rows = np.asarray(json.loads(body)["data"]["ndarray"], np.float32)
                    t2 = time.perf_counter()
                    p = scorer.score(rows)
                    t3 = time.perf_counter()
                    json.dumps(srv._response_dict(np.asarray(p, np.float64),
                                                  grid["model"])).encode()
                    t4 = time.perf_counter()
                    if norm is not None:  # the part of score the int8 wire adds
                        padded = np.zeros((b, rows.shape[1]), np.float32)
                        padded[:n] = rows
                        prequantize_rows_numpy(norm, padded)
                    t5 = time.perf_counter()
                    native.decode_ndarray_json(body, rows.shape[1])
                    t6 = time.perf_counter()
                    t_parse.append(t2 - t1)
                    t_score.append(t3 - t2)
                    t_reply.append(t4 - t3)
                    t_preq.append(t5 - t4)
                    t_nat.append(t6 - t5)
                med = {k: float(np.median(v)) * 1e3 for k, v in
                       (("parse", t_parse), ("preq", t_preq), ("score", t_score),
                        ("reply", t_reply), ("native", t_nat))}
                wire = (f"{b * (rows.shape[1] + 4)} B of int8 rows + scales, of which host "
                        f"prequantize (pad to {b} + normalize + quantize) "
                        f"{med['preq']:.3f} ms" if norm is not None else
                        f"{b * rows.shape[1] * (2 if kernel == 'fused_mlp_bf16' else 4)} "
                        f"B of rows on the wire")
                log(tag, f"{n} rows, median of 30: native payload decode "
                    f"{med['native']:.3f} ms (JSON decode {med['parse']:.3f} ms), "
                    f"Scorer.score {med['score']:.3f} ms ({wire}), JSON reply "
                    f"{med['reply']:.3f} ms on {self.card}")
            conn.request("GET", "/prometheus")
            resp = conn.getresponse()
            text = resp.read().decode()
            conn.close()
        finally:
            srv.stop()
        series = ['seldon_api_executor_client_requests_seconds_count{endpoint="/api/v0.1/predictions"}',
                  "proba_1 "] + [f'ccfd_kernel_launches{{kernel="{k}"}}' for k in KERNELS]
        for s in series:
            if resp.status != 200 or s not in text:
                raise AssertionError(f"/prometheus lacks {s!r}")
        m = {ln.rpartition(" ")[0]: float(ln.rpartition(" ")[2]) for ln in text.splitlines()
             if ln and not ln.startswith("#")}
        zeros = deadline_zero(m, tag)
        queued = {q: m.get(f'ccfd_front_requests_total{{queue="{q}"}}', 0.0)
                  for q in ("predict", "misc")}
        n_posts = len(REST_ROWS) + 8 * 8 + SEQ_POSTS + 1
        if queued["predict"] != n_posts or queued["misc"] != 1:
            # every POST decoded in C++, the scrape alone the Python route
            raise AssertionError(f"{tag}: the native front queued {queued} for {n_posts} "
                                 f"POSTs")
        log(tag, f"REST traffic: {n_posts} POSTs, queued by the front {queued}; launches "
            f"{launched}, scorer dispatches {dispatched}; grid after the split timing "
            f"{scorer.executable_grid()['dispatches']}; dispatch deadline counters {zeros}")
        others = {k: v for k, v in launched.items() if k != kernel and v}
        if launched[kernel] <= 0 or launched[kernel] != dispatched or others:
            raise AssertionError(
                f"REST path did not go through {kernel} alone: {launched} "
                f"launches for {dispatched} dispatches")
        self.reports[kernel]["launches"] += launched[kernel]

        # the same requests on the Python transport (CCFD_NATIVE_FRONT=0)
        srv = build_server(Config.from_env({**os.environ, **env, "CCFD_NATIVE_FRONT": "0"}),
                           device="cuda")
        if srv.transport != "python":
            raise AssertionError(f"{tag}: CCFD_NATIVE_FRONT=0 served by {srv.transport}")
        port = srv.start("127.0.0.1", 0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            for c in counters.values():
                c.reset()
            d0 = srv.scorer.dispatch_total()
            seq, lat_python = sequential(conn, SEQ_POSTS)
            launched = {k: c.value for k, c in counters.items()}
            dispatched = srv.scorer.dispatch_total() - d0
            for x, p in seq:
                check(x, p, "sequential 16-row POST, Python transport")
            conn.close()
            m = scrape(f"http://127.0.0.1:{port}/prometheus")
        finally:
            srv.stop()
        deadline_zero(m, f"{tag} Python transport")
        if launched[kernel] != dispatched or dispatched != SEQ_POSTS or any(
                v for k, v in launched.items() if k != kernel):
            raise AssertionError(f"{tag} Python transport: launches {launched} for "
                                 f"{dispatched} dispatches")
        log(tag, f"{SEQ_POSTS} sequential POSTs of 16 rows, same requests: native front "
            f"{quantiles(lat_native)}; Python transport (CCFD_NATIVE_FRONT=0) "
            f"{quantiles(lat_python)}; launches {launched[kernel]} = dispatches "
            f"{dispatched} on {self.card}")

        # the dispatch deadline armed: each request's dispatch runs on the
        # deadline's dispatcher thread, on the card, and none times out
        srv = build_server(Config.from_env({**os.environ, **env,
                                            "CCFD_DISPATCH_DEADLINE_MS": str(DEADLINE_MS)}),
                           device="cuda")
        if srv.scorer.executable_grid()["dispatch_deadline_ms"] != DEADLINE_MS:
            raise AssertionError(f"{tag}: deadline {srv.scorer.executable_grid()}")
        port = srv.start("127.0.0.1", 0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            for c in counters.values():
                c.reset()
            d0 = srv.scorer.dispatch_total()
            seq, lat_deadline = sequential(conn, SEQ_POSTS)
            launched = {k: c.value for k, c in counters.items()}
            dispatched = srv.scorer.dispatch_total() - d0
            for x, p in seq:
                check(x, p, "sequential 16-row POST, dispatch deadline armed")
            conn.close()
            m = scrape(f"http://127.0.0.1:{port}/prometheus")
        finally:
            srv.stop()
        deadline_zero(m, f"{tag} dispatch deadline")
        if launched[kernel] != dispatched or dispatched != SEQ_POSTS or any(
                v for k, v in launched.items() if k != kernel):
            raise AssertionError(f"{tag} dispatch deadline: launches {launched} for "
                                 f"{dispatched} dispatches")
        log(tag, f"CCFD_DISPATCH_DEADLINE_MS={DEADLINE_MS}: {SEQ_POSTS} sequential 16-row "
            f"POSTs on the native front, {quantiles(lat_deadline)}; launches "
            f"{launched[kernel]} = dispatches {dispatched}, no timeout, on {self.card}")

    def json_rules(self):
        """The decision phase's JSON rule base, its == bound an Amount the
        surrogate rows hold (row 3's, exact in float32)."""
        from ccfd_tpu_torch.router.rules import RuleSet

        obj = json.loads(json.dumps(JSON_RULES))
        obj[3]["when"][0]["value"] = float(self.rows[3, -1])
        return RuleSet.from_obj(obj)

    def decision(self) -> None:
        """The decision plane over each kernel's Scorer, held against the
        staged path (Scorer.score + RuleSet.evaluate) on the same rows."""
        import numpy as np

        from ccfd_tpu_torch.router.rules import default_rules
        from ccfd_tpu_torch.serving.fused import FusedDecisionScorer
        from ccfd_tpu_torch.serving.scorer import Scorer

        counters = self.counters()
        paths = (("fused_mlp_bf16", "mlp", "int8", self.params("random")),
                 ("fused_mlp_q8_preq", "mlp_q8", "int8", self.q8_params("random")),
                 ("fused_mlp_q8", "mlp_q8", "f32", self.q8_params("random")))
        rule_sets = (("default", default_rules(0.5)), ("json", self.json_rules()))
        for kernel, model, wire, params in paths:
            scorer = Scorer(model_name=model, params=params, device=self.dev, q8_wire=wire)
            scorer.warmup()
            for rs_name, rules in rule_sets:
                tag = f"decision {kernel} rules={rs_name}"
                fds = FusedDecisionScorer(scorer, rules, strict=True)
                fds.warmup()
                for c in counters.values():
                    c.reset()
                d0 = fds.dispatch_total()
                got = {b: fds.decide(self.rows[:b]) for b in PARITY_BATCHES}
                launched = {k: c.value for k, c in counters.items()}
                dispatched = fds.dispatch_total() - d0
                others = {k: v for k, v in launched.items() if k != kernel and v}
                if launched[kernel] != dispatched or dispatched <= 0 or others:
                    raise AssertionError(
                        f"{tag}: launches {launched} for {dispatched} plane dispatches")
                fired_any = np.zeros(len(rules.rules), np.int64)
                for b, (proba, fired) in got.items():
                    x = self.rows[:b]
                    staged = scorer.score(x)
                    want = rules.evaluate(x, staged)
                    if fired is None or not np.array_equal(proba, staged):
                        raise AssertionError(
                            f"{tag} B={b}: proba not bit-equal to the staged path "
                            f"(max |dp| {np.abs(proba - staged).max()})")
                    if not np.array_equal(fired, want):
                        raise AssertionError(
                            f"{tag} B={b}: fired differs from RuleSet.evaluate on "
                            f"{int((fired != want).sum())} rows")
                    fired_any += np.bincount(fired, minlength=len(rules.rules))
                grid = fds.executable_grid()
                if grid["staged_fallbacks"] or not grid["enabled"]:
                    raise AssertionError(f"{tag}: the plane fell back: {grid}")
                log("decision", f"{tag}: forward {grid['forward']}, needs_features "
                    f"{grid['needs_features']}; B in {PARITY_BATCHES}: proba bit-equal "
                    f"to Scorer.score, fired equal to RuleSet.evaluate on every row; "
                    f"launches {launched[kernel]} = plane dispatches {dispatched} "
                    f"({grid['dispatches']}); rows per rule {fired_any.tolist()}")
                # a call: the plane against the staged path (score + host rules)
                for b in (16, 16384):
                    x = self.rows[:b]
                    t_dec, t_stg = [], []
                    for _ in range(20):
                        t0 = time.perf_counter()
                        fds.decide(x)
                        t1 = time.perf_counter()
                        rules.evaluate(x, scorer.score(x))
                        t2 = time.perf_counter()
                        t_dec.append(t1 - t0)
                        t_stg.append(t2 - t1)
                    log("decision", f"{tag} B={b}: decide {np.median(t_dec) * 1e3:.3f} ms, "
                        f"staged score + rules {np.median(t_stg) * 1e3:.3f} ms (host clock, "
                        f"median of 20) on {self.card}")

    def demo(self) -> None:
        """The decision pipeline (cli.build_pipeline), staged, then with the
        decision plane armed by the reference's knob."""
        import dataclasses

        from ccfd_tpu_torch.cli import build_pipeline
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import Dataset

        ds = Dataset(X=self.rows, y=self.labels)
        total = 0
        for armed in (False, True):
            env = {**os.environ, "CCFD_FUSED_DECISION": "1" if armed else "0"}
            cfg = dataclasses.replace(Config.from_env(env),
                                      customer_reply_timeout_s=DEMO_REPLY_TIMEOUT_S)
            tag = f"demo {'plane' if armed else 'staged'}"
            t0 = time.perf_counter()
            pipe = build_pipeline(cfg, ds, device=str(self.dev), params=self.params("checkpoint"),
                                  seed=SEED)
            if (pipe.decision is not None) != armed:
                raise AssertionError(f"{tag}: decision plane wired={pipe.decision is not None}")
            log("demo", f"{tag}: pipeline built and warmed in {time.perf_counter() - t0:.3f} s "
                f"(model {pipe.scorer.spec.name}, buckets {pipe.scorer.batch_sizes}, "
                f"router max_batch {pipe.router.max_batch})")
            for c in self.counters().values():
                c.reset()
            total += self.demo_run(pipe, tag)
        self.reports["fused_mlp_bf16"]["launches"] += total
        self.demo_decode()

    def demo_decode(self) -> None:
        """The router's CSV decode of one 4,096-row micro-batch on the
        producer's wire (``decode_records``: the work the router.decode span
        times in the roles), through the native decoder and through its
        plain version, host clock, 50 calls each."""
        import numpy as np

        from ccfd_tpu_torch import native
        from ccfd_tpu_torch.bus.broker import Record
        from ccfd_tpu_torch.router import router as router_mod

        recs = [Record(TX_TOPIC, 0, i, i, ",".join(repr(float(v)) for v in row).encode(), 0.0)
                for i, row in enumerate(self.rows[:4096])]
        times = {}
        real = native.decode_csv
        try:
            for name, fn in (("native", real), ("plain", native._decode_csv_numpy)):
                native.decode_csv = fn  # what decode_records calls
                lat = []
                for _ in range(50):
                    t0 = time.perf_counter()
                    x, _txs, bad = router_mod.decode_records(recs)
                    lat.append(time.perf_counter() - t0)
                if bad or x.shape != (4096, 30):
                    raise AssertionError(f"decode_records ({name}): {bad} bad rows, {x.shape}")
                times[name] = (np.percentile(lat, 50) * 1e3, np.percentile(lat, 99) * 1e3, x)
        finally:
            native.decode_csv = real
        dx = float(np.abs(times["native"][2] - times["plain"][2]).max())
        if not np.allclose(times["native"][2], times["plain"][2], rtol=1e-5, atol=1e-6):
            raise AssertionError(f"native CSV decode disagrees with the plain one: {dx}")
        log("demo", f"router CSV decode of a 4,096-row batch (decode_records, host clock, "
            f"50 calls): native p50 {times['native'][0]:.3f} ms p99 {times['native'][1]:.3f} "
            f"ms; plain p50 {times['plain'][0]:.3f} ms p99 {times['plain'][1]:.3f} ms "
            f"({times['plain'][0] / times['native'][0]:.1f}x); max |dx| {dx:.3e} on "
            f"{self.card}")

    def demo_run(self, pipe, tag: str) -> int:
        """One run of the pipeline; returns B1's launches in it."""
        from ccfd_tpu_torch.ops.fused_mlp import launches as b1_launches

        rr = pipe.reg_router
        score_err = rr.counter("router_score_errors_total")
        start_err = rr.counter("router_process_start_errors_total")

        def settled(n: int, what: str) -> float:
            return pipe_settled(pipe, n, f"{tag}: {what}")

        plane = pipe.decision
        d0 = (pipe.scorer.dispatch_total(), plane.dispatch_total() if plane else 0,
              plane.warm_dispatches if plane else 0)
        produced = 0
        pipe.start(poll_timeout_s=0.02)
        try:
            for wire, n in DEMO_PARTS:
                t0 = time.perf_counter()
                produced += pipe.producer.run(limit=n, wire_format=wire)
                dt = (time.perf_counter() - t0) + settled(produced, f"{wire} part")
                log("demo", f"{tag}: {n} transactions on the {wire} wire routed in "
                    f"{dt:.3f} s: {n / dt:.1f} transactions/s end to end on {self.card}")
            pipe.scorer.swap_params(self.params("random"))
            # the card's busy time over this part, from a device-only trace
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                produced += pipe.producer.run(limit=DEMO_AFTER_SWAP, wire_format="dict")
                window = (time.perf_counter() - t0) + settled(produced, "after the swap")
            busy = sum(getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0.0)
                       for e in prof.key_averages()) / 1e6
            log("demo", f"{tag}: {DEMO_AFTER_SWAP} transactions after the swap (random "
                f"params) routed in {window:.3f} s under a device trace: device busy "
                f"{busy * 1e3:.3f} ms, idle share {1 - busy / window:.4f} on {self.card}"
                if busy else f"{tag}: device busy time not measured (no device events "
                f"in the trace)")
            time.sleep(DEMO_REPLY_TIMEOUT_S + 1.0)  # the no-reply timers fire
        finally:
            pipe.stop()
        launched = b1_launches.value
        others = {k: c.value for k, c in self.counters().items()
                  if k != "fused_mlp_bf16" and c.value}
        summary = pipe.summary()
        staged_d = pipe.scorer.dispatch_total() - d0[0]
        plane_d = plane.dispatch_total() - d0[1] if plane is not None else 0
        warm_d = plane.warm_dispatches - d0[2] if plane is not None else 0
        dec, score_h = rr.histogram("router_decision_seconds"), rr.histogram("router_score_seconds")
        log("demo", f"{tag}: summary {json.dumps(summary)}")
        log("demo", f"{tag}: router decision latency p50 {dec.quantile(0.5) * 1e3:.3f} ms "
            f"p99 {dec.quantile(0.99) * 1e3:.3f} ms, score stage p50 "
            f"{score_h.quantile(0.5) * 1e3:.3f} ms p99 {score_h.quantile(0.99) * 1e3:.3f} ms "
            f"(bucket-interpolated histogram quantiles, {dec.count()} transactions, "
            f"{score_h.count()} batches) on {self.card}")
        log("demo", f"{tag}: scorer dispatches per bucket "
            f"{pipe.scorer.executable_grid()['dispatches']}"
            + (f", plane {plane.executable_grid()['dispatches']} (+{warm_d} from the "
               f"swap's prepublish grid), fused_decision_dispatches_total "
               f"{rr.counter('fused_decision_dispatches_total').value():.0f}, "
               f"staged_fallbacks {plane.staged_fallbacks}, host_syncs {plane.host_syncs}"
               if plane is not None else ""))
        routed = summary["fraud_routed"] + summary["standard_routed"]
        fails = []
        if summary["transactions"] != produced or routed != produced:
            fails.append(f"{produced} produced, {summary['transactions']} incoming, "
                         f"{routed} routed")
        if score_err.value() or start_err.total():
            fails.append(f"score errors {score_err.value()}, start errors {start_err.total()}")
        if not (summary["fraud_routed"] and summary["standard_routed"]):
            fails.append("a process got no transaction")
        if not (summary["low_amount_auto_n"] and summary["investigations_n"]):
            fails.append("a DMN outcome got no transaction")
        if launched != staged_d + plane_d + warm_d or others or not launched:
            fails.append(f"B1 launches {launched} != scorer dispatches {staged_d} + plane "
                         f"{plane_d} + prepublish {warm_d}; other kernels {others}")
        if plane is not None and (
                rr.counter("fused_decision_dispatches_total").value() != produced
                or plane.staged_fallbacks):
            fails.append(f"plane rows {rr.counter('fused_decision_dispatches_total').value()}"
                         f" != {produced} or staged_fallbacks {plane.staged_fallbacks}")
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        log("demo", f"ok: {tag}: {produced} transactions routed, B1 launches {launched} = "
            f"scorer dispatches {staged_d} + plane {plane_d} + prepublish {warm_d}")
        return launched

    def services(self) -> None:
        """The reference's service roles as processes: (a) one router
        worker, (b) one per partition with coalescing, (c) the ladder over
        a killed and restarted ``serve``, (d) the durable bus and engine
        through a bus crash and an engine restart, (e) the router's edges
        under a fault plan. Each part has its own roles; the processes that
        reach the card (four routers and two serve processes) start at
        once, since each takes seconds to import torch and reach the card,
        and the parts then run one after the other, each part's roles
        stopped before the next part runs."""
        import contextlib

        from ccfd_tpu_torch.data.ccfd import to_csv_bytes
        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

        with contextlib.ExitStack() as stack:
            # the producer streams the checkpoint's own training distribution
            # (the Kaggle-shaped surrogate, as the demo phase does), so the
            # fraud process, its notifications and the replies run too
            data = tempfile.mkdtemp(prefix="ccfd_rows_")
            stack.callback(shutil.rmtree, data, ignore_errors=True)
            csv = os.path.join(data, "transactions.csv")
            with open(csv, "wb") as f:
                f.write(to_csv_bytes(kaggle_surrogate(n=SERVICES_ROWS)))
            a, b, c, d, e, f3 = (stack.enter_context(Roles(self.card, csv)) for _ in range(6))
            for roles in (a, b, c, e, f3):
                roles.backbone()
            d.backbone(bus_args=("--dir", os.path.join(d.dir, "bus")),
                       engine_args=("--state-file", os.path.join(d.dir, "engine.json"),
                                    "--save-interval-s", "1"),
                       engine_env={"CCFD_REPLY_TIMEOUT_S": str(DURABLE_REPLY_TIMEOUT_S)})
            rules = os.path.join(d.dir, "rules.json")
            with open(rules, "w") as f:
                json.dump(DURABLE_RULES, f)
            d.env["CCFD_RULES"] = rules  # the router's, and its restarts'
            sport, eport = free_port(), free_port()
            a.spawn("router", "router", "--metrics-port", str(a.rport), "--device", "cuda")
            b.spawn("router", "router", "--metrics-port", str(b.rport), "--device", "cuda",
                    extra_env={"CCFD_ROUTER_WORKERS": "0"})
            c.spawn("serve1", "serve", "--host", "127.0.0.1", "--port", str(sport),
                    "--device", "cuda")
            c.spawn("router", "router", "--metrics-port", str(c.rport),
                    extra_env={"SELDON_URL": f"http://127.0.0.1:{sport}"})
            d.spawn("router", "router", "--metrics-port", str(d.rport), "--device", "cuda")
            e.spawn("serve", "serve", "--host", "127.0.0.1", "--port", str(eport),
                    "--device", "cuda")
            e.spawn("router", "router", "--metrics-port", str(e.rport),
                    extra_env={"SELDON_URL": f"http://127.0.0.1:{eport}",
                               "CCFD_FAULTS": FAULT_PLAN, "CCFD_CLIENT_RETRIES": "0"})
            f_ports = [f3.rport, free_port(), free_port()]
            for i, port in enumerate(f_ports):
                f3.spawn(f"router{i}", "router", "--metrics-port", str(port), "--device",
                         "cuda", extra_env={"CCFD_ROUTER_WORKERS": "1"})
            # all up before any part is measured: a process still starting
            # would take CPU from the part under measurement
            t0 = time.perf_counter()
            for roles in (a, b, c, d, e):
                roles.wait(f"{roles.rurl}/prometheus", roles.procs["router"], 180)
            for i, port in enumerate(f_ports):
                f3.wait(f"http://127.0.0.1:{port}/prometheus", f3.procs[f"router{i}"], 180)
            c.wait(f"http://127.0.0.1:{sport}/health/status", c.procs["serve1"], 180)
            e.wait(f"http://127.0.0.1:{eport}/health/status", e.procs["serve"], 180)
            log("services", f"the roles of six parts, nine of them on the card, up in "
                f"{time.perf_counter() - t0:.3f} s")
            import gc

            try:  # what the reference's service tuning sets
                want_gc = int(os.environ.get("CCFD_GC_THRESHOLD", "").strip() or 100_000)
            except ValueError:
                want_gc = 100_000
            if want_gc <= 0:
                want_gc = gc.get_threshold()[0]  # opted out: Python's default
            for part, roles in zip("abcdef", (a, b, c, d, e, f3)):
                got = roles.gc_thresholds()
                log("services", f"part ({part}) roles' gc.get_threshold()[0]: {got}")
                if any(v != want_gc for v in got.values()):
                    raise AssertionError(f"part ({part}): gc thresholds {got}, want {want_gc}")
            t0 = time.perf_counter()
            one = self.services_run("a", a, SERVICES_ROWS)
            a.stop()
            log("services", f"part (a) took {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            fan = self.services_run("b", b, SERVICES_ROWS)
            b.stop()
            log("services", f"part (b) took {time.perf_counter() - t0:.1f} s")
            log("services", f"fan-out: {fan['tx_s']:.1f} tx/s with 3 workers against "
                f"{one['tx_s']:.1f} with one ({fan['tx_s'] / one['tx_s']:.3f}x) on "
                f"{self.card}")
            t0 = time.perf_counter()
            ladder = self.services_ladder(c, sport)
            c.stop()
            log("services", f"part (c) took {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            durable = self.services_durable(d)
            d.stop()
            log("services", f"part (d) took {time.perf_counter() - t0:.1f} s")
            log("services", "tx/s of a 4,000-row burst on the durable bus (after each "
                f"start): {[round(x, 1) for x in durable['tx_s']]}, with "
                f"CCFD_BUS_FSYNC=1: {durable['tx_s_fsync']:.1f}; part (a)'s memory bus "
                f"(20,000 rows): {one['tx_s']:.1f}; on {self.card}")
            t0 = time.perf_counter()
            faulted = self.services_faults(e, eport)
            e.stop()
            log("services", f"part (e) took {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            procs3 = self.services_routers(f3, f_ports)
            f3.stop()
            log("services", f"part (f) took {time.perf_counter() - t0:.1f} s")
            log("services", f"fan-out: {procs3['tx_s']:.1f} tx/s with three router processes "
                f"against {fan['tx_s']:.1f} with three threads in one (part (b)) and "
                f"{one['tx_s']:.1f} with one worker ({procs3['tx_s'] / one['tx_s']:.3f}x one "
                f"worker, {procs3['tx_s'] / fan['tx_s']:.3f}x the threads) on {self.card}")
        self.reports["fused_mlp_bf16"]["launches"] += (one["b1"] + fan["b1"] + ladder
                                                       + durable["b1"] + faulted
                                                       + procs3["b1"])

    def services_run(self, part: str, roles: "Roles", rows: int) -> dict:
        """Part (a) or (b) on its started roles (the router on the card):
        the producer's ``rows`` CSV rows; returns tx/s and B1's launches."""
        from ccfd_tpu_torch.config import Config

        tag = f"services ({part})"
        warm = len(Config.from_env().batch_sizes)  # the Scorer's warmup launches
        roles.wait(f"{roles.rurl}/prometheus", roles.procs["router"], 180)
        before = scrape(f"{roles.rurl}/prometheus")
        elapsed = roles.settled(rows, roles.produce(rows))
        m = scrape(f"{roles.rurl}/prometheus")
        kie = scrape(f"{roles.kurl}/rest/metrics")
        tx_s = rows / elapsed
        check_conservation(tag, m, kie, rows)
        b1, disp = launches_of(m), m["ccfd_scorer_dispatches"]
        if b1 - disp != warm or disp <= 0 or launches_of(before) != warm:
            raise AssertionError(f"{tag}: B1 launches {b1} != scorer dispatches {disp} + "
                                 f"{warm} warmup launches")
        others = {k: v for k, v in m.items() if k.startswith("ccfd_kernel_launches")
                  and "fused_mlp_bf16" not in k and v}
        if others:
            raise AssertionError(f"{tag}: other kernels launched: {others}")
        workers = {k: v for k, v in m.items() if k.startswith("router_worker_batches_total")}
        fan = {}
        if part == "b":
            coalesced = m.get("router_coalesced_dispatches_total", 0.0)
            if len(workers) != 3 or not all(workers.values()) or not (
                    0 < coalesced <= sum(workers.values())):
                raise AssertionError(f"{tag}: worker batches {workers}, coalesced "
                                     f"dispatches {coalesced}")
            fan = {"coalesced_dispatches": coalesced,
                   "coalesced_rows": m.get("router_coalesced_rows_total")}
        spans = {s: (hist_quantile(m, "trace_span_seconds", 0.5, f'span="{s}"'),
                     hist_quantile(m, "trace_span_seconds", 0.99, f'span="{s}"'))
                 for s in ("router.batch", "router.decode", "router.score", "router.route")}
        log("services", f"{tag}: {rows} CSV rows routed in {elapsed:.3f} s from the first "
            f"row on the bus to the last process start: {tx_s:.1f} transactions/s end to "
            f"end on {self.card}; router decision latency p50 "
            f"{hist_quantile(m, 'router_decision_seconds', 0.5) * 1e3:.3f} ms p99 "
            f"{hist_quantile(m, 'router_decision_seconds', 0.99) * 1e3:.3f} ms, score stage "
            f"p50 {hist_quantile(m, 'router_score_seconds', 0.5) * 1e3:.3f} ms p99 "
            f"{hist_quantile(m, 'router_score_seconds', 0.99) * 1e3:.3f} ms")
        log("services", f"{tag}: span p50 / p99 ms (every span timed; "
            f"{m.get('trace_span_seconds_count{span=\"router.batch\"}', 0):.0f} batches): "
            + ", ".join(f"{s} {a * 1e3:.3f} / {b * 1e3:.3f}" for s, (a, b) in spans.items()))
        log("services", f"ok: {tag}: worker batches {workers}{' ' + str(fan) if fan else ''}; "
            f"B1 launches {b1:.0f} = scorer dispatches {disp:.0f} + {warm} warmup; "
            f"inflight limit {m.get('ccfd_inflight_limit{stage=\"router\"}')}")
        return {"tx_s": tx_s, "b1": int(disp)}

    def services_ladder(self, roles: "Roles", sport: int) -> int:
        """Part (c) on its started roles: the router on SELDON_URL -> the
        ``serve`` process on the card at ``sport``; the serve process is
        killed after the stream's first part, the second part is produced
        while it is down, then it is restarted and the third part streams
        at a fixed rate until the breaker has closed. Returns B1's launches
        on the path."""
        from ccfd_tpu_torch.config import Config

        tag = "services (c)"
        warm = len(Config.from_env().batch_sizes)
        n1, n2 = LADDER_PARTS
        surl = f"http://127.0.0.1:{sport}"
        serve = roles.procs["serve1"]
        roles.wait(f"{surl}/health/status", serve, 180)
        roles.wait(f"{roles.rurl}/prometheus", roles.procs["router"], 180)
        roles.settled(n1, roles.produce(n1))
        s1 = scrape(f"{surl}/prometheus")
        serve.kill()  # the scorer edge dies
        serve.wait(30)
        roles.settled(n1 + n2, roles.produce(n2, rate=LADDER_RATE))
        down = scrape(f"{roles.rurl}/prometheus")
        serve2 = roles.spawn("serve2", "serve", "--host", "127.0.0.1", "--port",
                             str(sport), "--device", "cuda")
        roles.wait(f"{surl}/health/status", serve2, 180)
        total = n1 + n2 + LADDER_RATE_ROWS
        roles.settled(total, roles.produce(LADDER_RATE_ROWS, rate=LADDER_RATE))
        m = scrape(f"{roles.rurl}/prometheus")
        s2 = scrape(f"{surl}/prometheus")
        kie = scrape(f"{roles.kurl}/rest/metrics")
        check_conservation(tag, m, kie, total, healthy=False)
        log("services", f"{tag}: restarted serve's gc.get_threshold()[0]: "
            f"{roles.gc_thresholds()['serve2']}")
        host = m.get('router_degraded_total{tier="host"}', 0.0)
        rules = m.get('router_degraded_total{tier="rules"}', 0.0)
        r1, r2 = s1["serving_batcher_rows_total"], s2["serving_batcher_rows_total"]
        opens = m.get('ccfd_breaker_transitions_total{edge="scorer",to="open"}', 0.0)
        closes = m.get('ccfd_breaker_transitions_total{edge="scorer",to="closed"}', 0.0)
        fails = []
        if r1 != n1:
            fails.append(f"the card scored {r1} of the first {n1} rows")
        if down.get('router_degraded_total{tier="rules"}', 0.0) != n2:
            fails.append(f"{down.get('router_degraded_total{tier=\"rules\"}')} rows on the "
                         f"rules tier while the edge was down, not {n2}")
        if host or not rules or r1 + r2 + rules != total:
            fails.append(f"rows: card {r1} + {r2}, host {host}, rules {rules}, of {total}")
        if not opens or not closes or m['ccfd_breaker_state{edge="scorer"}'] != 0:
            fails.append(f"breaker: {opens} opens, {closes} closes, state "
                         f"{m['ccfd_breaker_state{edge=\"scorer\"}']}")
        b1 = [launches_of(s) for s in (s1, s2)]
        disp = [s["ccfd_scorer_dispatches"] for s in (s1, s2)]
        if any(b - d != warm for b, d in zip(b1, disp)) or not r2:
            fails.append(f"serve B1 launches {b1} != dispatches {disp} + warmup")
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        log("services", f"ok: {tag}: {total} rows routed; the card scored {r1:.0f} (serve "
            f"1) + {r2:.0f} (serve 2 after the restart), the rules tier {rules:.0f} (score "
            f"errors {m.get('router_score_errors_total', 0):.0f}, the rest refused by the "
            f"open breaker), the host tier 0; breaker opened {opens:.0f} times and closed "
            f"{closes:.0f}; serve B1 launches {b1} = dispatches {disp} + warmup; the serve "
            f"processes' dispatch deadline counters "
            f"{[{k: s.get(k) for k in DEADLINE_SERIES} for s in (s1, s2)]}")
        for s in (s1, s2):
            if any(s.get(k) != 0.0 for k in DEADLINE_SERIES):
                raise AssertionError(f"{tag}: a serve process's dispatch deadline counters: "
                                     f"{ {k: s.get(k) for k in DEADLINE_SERIES} }")
        return int(sum(disp))

    def services_durable(self, roles: "Roles") -> dict:
        """Part (d) on its started roles (the bus on ``--dir``, the engine on
        ``--state-file``, the router on the card): three bursts around a bus
        crash and an engine restart, then a second bus crash into
        CCFD_BUS_FSYNC=1 and a last burst. Returns each burst's tx/s and
        B1's launches."""
        import re

        from ccfd_tpu_torch.config import Config

        tag = "services (d)"
        warm = len(Config.from_env().batch_sizes)
        n = DURABLE_ROWS
        quiet = DURABLE_REPLY_TIMEOUT_S + 2.0  # every reply and reply timer done
        names = {"bus": "bus", "engine": "engine", "router": "router", "notify": "notify"}
        routers, engines, tx_s = [], [], []
        seen = {"router": 0}  # rows the current router process has routed

        def burst() -> float:
            roles.wait(f"{roles.rurl}/prometheus", roles.procs[names["router"]], 180)
            first = roles.produce(n)
            seen["router"] += n
            elapsed = roles.settled(seen["router"], first)
            time.sleep(quiet)
            return n / elapsed

        def offsets() -> tuple:
            return (roles.get(f"{roles.burl}/topics/{TX_TOPIC}/offsets"),
                    roles.get(f"{roles.burl}/groups/router/topics/{TX_TOPIC}/offsets"))

        def crash_bus(k: int, fsync: bool) -> None:
            """SIGKILL the bus; the router and notify fail their next poll and
            exit; restart the bus on its port and dir, then them."""
            routers.append(scrape(f"{roles.rurl}/prometheus"))
            want = offsets()
            roles.procs[names["bus"]].kill()
            roles.procs[names["bus"]].wait(30)
            rcs = {r: roles.exited(names[r], 60) for r in ("router", "notify")}
            if not all(rcs.values()):
                raise AssertionError(f"{tag}: {rcs}: the roles outlived the bus")
            names["bus"] = f"bus{k}"
            up_s = roles.spawn_bus(names["bus"], "--dir", os.path.join(roles.dir, "bus"),
                                   extra_env={"CCFD_BUS_FSYNC": "1" if fsync else "0"})
            got = offsets()
            line = re.search(r"opened and replayed in ([0-9.]+) ms",
                             roles.log_text(names["bus"]))
            log("services", f"{tag}: bus SIGKILLed under the router (which exited "
                f"{rcs['router']}) and restarted on its dir{' with CCFD_BUS_FSYNC=1' if fsync else ''}: "
                f"health in {up_s * 1e3:.3f} ms, the log opened and replayed in "
                f"{line.group(1) if line else '?'} ms; {TX_TOPIC} end offsets {got[0]}, "
                f"the router group's committed {got[1]}")
            if got != want:
                raise AssertionError(f"{tag}: after the bus restart offsets {got}, before {want}")
            names["router"], names["notify"] = f"router{k}", f"notify{k}"
            seen["router"] = 0
            roles.spawn(names["router"], "router", "--metrics-port", str(roles.rport),
                        "--device", "cuda")
            roles.spawn_notify(names["notify"])

        tx_s.append(burst())
        crash_bus(2, fsync=False)
        tx_s.append(burst())
        # the engine: SIGTERM (it saves), restart on its state file
        views = ("instances?status=active", "tasks?status=open")
        before = [roles.get(f"{roles.kurl}/rest/{v}") for v in views]
        engines.append(scrape(f"{roles.kurl}/rest/metrics"))
        roles.procs["engine"].send_signal(signal.SIGTERM)
        if roles.exited("engine", 60) != 0:
            raise AssertionError(f"{tag}: the engine exited {roles.procs['engine'].returncode}")
        state = os.path.join(roles.dir, "engine.json")
        saved = re.search(r"saved \S+ \((\d+) bytes\) in ([0-9.]+) ms",
                          roles.log_text("engine"))
        roles.spawn_engine("engine2", "--state-file", state, "--save-interval-s", "1",
                           extra_env={"CCFD_REPLY_TIMEOUT_S": str(DURABLE_REPLY_TIMEOUT_S)})
        loaded = re.search(r"loaded \S+ in ([0-9.]+) ms", roles.log_text("engine2"))
        after = [roles.get(f"{roles.kurl}/rest/{v}") for v in views]
        if not saved or not loaded or after != before:
            raise AssertionError(f"{tag}: engine restart: saved {bool(saved)}, loaded "
                                 f"{bool(loaded)}, {len(before[0])} active / "
                                 f"{len(before[1])} open tasks before, {len(after[0])} / "
                                 f"{len(after[1])} after")
        if not before[0] or not before[1]:
            raise AssertionError(f"{tag}: no live engine state to carry: {before}")
        log("services", f"{tag}: engine SIGTERMed and restarted on its state file: "
            f"{len(before[0])} active fraud processes and {len(before[1])} open "
            f"investigator tasks before = after; saved {saved.group(1)} bytes in "
            f"{saved.group(2)} ms, loaded in {loaded.group(1)} ms")
        tx_s.append(burst())
        crash_bus(3, fsync=True)
        tx_s_fsync = burst()
        routers.append(scrape(f"{roles.rurl}/prometheus"))
        engines.append(scrape(f"{roles.kurl}/rest/metrics"))

        def total(ms: list) -> dict:
            out: dict = {}
            for m in ms:
                for k, v in m.items():
                    out[k] = out.get(k, 0.0) + v
            return out

        produced = 4 * n
        check_conservation(tag, total(routers), total(engines), produced)
        disp = [m["ccfd_scorer_dispatches"] for m in routers]
        b1 = [launches_of(m) for m in routers]
        if any(x - y != warm or y <= 0 for x, y in zip(b1, disp)):
            raise AssertionError(f"{tag}: the routers' B1 launches {b1} != their dispatches "
                                 f"{disp} + {warm} warmup launches each")
        log("services", f"ok: {tag}: {produced} rows through three router processes "
            f"and two engine processes, each routed and started once; the routers' B1 "
            f"launches {b1} = dispatches {disp} + {warm} warmup each")
        return {"tx_s": tx_s, "tx_s_fsync": tx_s_fsync, "b1": int(sum(disp))}

    def services_faults(self, roles: "Roles", sport: int) -> int:
        """Part (e) on its started roles: the router on SELDON_URL -> the
        ``serve`` process on the card at ``sport``, under FAULT_PLAN with no
        client retries. Returns B1's launches on the path."""
        from ccfd_tpu_torch.config import Config

        tag = "services (e)"
        warm = len(Config.from_env().batch_sizes)
        surl = f"http://127.0.0.1:{sport}"
        first = roles.produce(FAULT_ROWS, rate=FAULT_RATE)
        elapsed = roles.settled(FAULT_ROWS, first)
        m = scrape(f"{roles.rurl}/prometheus")
        srv = scrape(f"{surl}/prometheus")
        kie = scrape(f"{roles.kurl}/rest/metrics")
        check_conservation(tag, m, kie, FAULT_ROWS, healthy=False)
        host = m.get('router_degraded_total{tier="host"}', 0.0)
        rules = m.get('router_degraded_total{tier="rules"}', 0.0)
        errors = m.get("router_score_errors_total", 0.0)
        answered = m["transaction_incoming_total"] - rules - host
        card = srv["serving_batcher_rows_total"]
        injected = {k: m.get(f'faults_injected_total{{edge="{e}",kind="{kind}"}}', 0.0)
                    for k, e, kind in (("scorer/error", "scorer", "error"),
                                       ("scorer/corrupt", "scorer", "corrupt"),
                                       ("engine/latency", "engine", "latency"))}
        breaker = {k: v for k, v in m.items() if k.startswith("ccfd_breaker_transitions_total")}
        probas = [i["vars"].get("proba") for i in roles.get(f"{roles.kurl}/rest/instances")]
        b1, disp = launches_of(srv), srv["ccfd_scorer_dispatches"]
        fails = []
        if host or answered + rules != FAULT_ROWS or not answered <= card <= answered + errors:
            fails.append(f"rows: answered by the card {answered}, rules {rules}, host {host}, "
                         f"scored on the card {card}, failed calls' rows {errors}")
        if not all(injected.values()):
            fails.append(f"faults_injected_total {injected}")
        bad = [p for p in probas if p is None or not math.isfinite(p)]
        if bad or not probas:
            fails.append(f"{len(bad)} of {len(probas)} engine probabilities not finite")
        if b1 - disp != warm or disp <= 0:
            fails.append(f"serve B1 launches {b1} != dispatches {disp} + {warm} warmup")
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        log("services", f"ok: {tag}: {FAULT_ROWS} rows routed in {elapsed:.3f} s "
            f"at {FAULT_RATE:.0f}/s under {FAULT_PLAN!r}: "
            f"{answered:.0f} on the card's answers + {rules:.0f} on the rules tier (score "
            f"errors {errors:.0f}, {rules - errors:.0f} refused by the open breaker), the "
            f"host tier 0; "
            f"the card scored {card:.0f} rows (the corrupted answers' rows among them); "
            f"injected {injected}; breaker transitions {breaker}; {len(probas)} engine "
            f"probabilities all finite; serve B1 launches {b1:.0f} = dispatches {disp:.0f} "
            f"+ {warm} warmup")
        return int(disp)

    # -- the models phase ------------------------------------------------
    def services_routers(self, roles: "Roles", ports: list) -> dict:
        """Part (f) on its started roles: three `router` processes on the
        card in one consumer group (one worker each) share the transaction
        topic's partitions; the producer's SERVICES_ROWS CSV rows. Returns
        tx/s and B1's launches."""
        from ccfd_tpu_torch.config import Config

        tag = "services (f)"
        warm = len(Config.from_env().batch_sizes)
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        for i, url in enumerate(urls):
            roles.wait(f"{url}/prometheus", roles.procs[f"router{i}"], 180)
        rows = SERVICES_ROWS
        first = roles.produce(rows)
        deadline = time.monotonic() + 180
        while True:
            ms = [scrape(f"{u}/prometheus") for u in urls]
            incoming = sum(m.get("transaction_incoming_total", 0.0) for m in ms)
            done = sum(v for m in ms for k, v in m.items() if k.startswith((
                "transaction_outgoing_total", "router_shed_total",
                "router_process_start_errors_total")))
            if incoming >= rows and done >= rows:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{tag}: {incoming} of {rows} consumed after 180 s")
            time.sleep(0.02)
        elapsed = time.perf_counter() - first
        kie = scrape(f"{roles.kurl}/rest/metrics")
        routed = sum(v for m in ms for k, v in m.items()
                     if k.startswith("transaction_outgoing_total"))
        started = sum(v for k, v in kie.items() if k.startswith("process_instances_started"))
        per = [m.get("transaction_incoming_total", 0.0) for m in ms]
        b1 = [launches_of(m) for m in ms]
        disp = [m.get("ccfd_scorer_dispatches", 0.0) for m in ms]
        bad = {k: v for m in ms for k, v in m.items() if v and k.startswith((
            "router_shed_total", "router_score_errors_total", "router_degraded_total",
            "router_process_start_errors_total"))}
        if not incoming == routed == started == rows or not all(per) or bad:
            raise AssertionError(f"{tag}: produced {rows}, incoming {per}, routed {routed}, "
                                 f"engine starts {started}, {bad}")
        if any(b - d != warm or not d for b, d in zip(b1, disp)):
            raise AssertionError(f"{tag}: B1 launches {b1} != dispatches {disp} + {warm}")
        tx_s = rows / elapsed
        log("services", f"ok: {tag}: three router processes on one consumer group took "
            f"{[int(x) for x in per]} of {rows} CSV rows, routed and started once, in "
            f"{elapsed:.3f} s: {tx_s:.1f} transactions/s end to end; each process's B1 "
            f"launches = its dispatches {[int(d) for d in disp]} + {warm} warmup on "
            f"{self.card}")
        return {"tx_s": tx_s, "b1": int(sum(disp))}

    # -- platform: the operator (``up -f``, ``manifests``) on the card -------
    def platform(self) -> None:
        """The platform operator: (1) ``manifests`` against the reference's
        documents, (2) ``up -f`` of the port's CR as a process on the card,
        (3) an in-process Platform through an engine crash and a full bounce,
        (4) the operator pipeline at fixed arrival rates."""
        self.platform_manifests()
        b1 = self.platform_up()
        b1 += self.platform_recovery()
        b1 += self.platform_fixed_rate()
        self.reports["fused_mlp_bf16"]["launches"] += b1

    def platform_cr(self, tmp: str, **blocks) -> dict:
        """The port's CR on free ports with its state under ``tmp``, each
        block of ``blocks`` updated."""
        import yaml

        with open(os.path.join(REPO, PORT_CR)) as f:
            cr = yaml.safe_load(f)
        s = cr["spec"]
        s["scorer"].update(port=free_port())
        s["monitoring"]["port"] = free_port()
        s["health"]["port"] = free_port()
        s["bus"]["log_dir"] = os.path.join(tmp, "buslog")
        s["engine"]["checkpoint_file"] = os.path.join(tmp, "cut.json")
        for name, opts in blocks.items():
            s.setdefault(name, {}).update(opts)
        return cr

    def platform_manifests(self) -> None:
        """(1) The port's ``build_manifests`` of its CR against the
        reference's documents for ``deploy/platform_cr.yaml`` (its own
        ``manifests`` output, checked in under deploy/k8s): the same files,
        each document equal once the three port fields are mapped back."""
        import copy

        import yaml

        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.platform.k8s import build_manifests
        from ccfd_tpu_torch.platform.operator import PlatformSpec

        port = build_manifests(PlatformSpec.from_yaml(os.path.join(REPO, PORT_CR),
                                                      cfg=Config()), Config())
        ref_dir = os.path.join(REPO, "deploy", "k8s")
        names = sorted(n for n in os.listdir(ref_dir) if n.endswith(".yaml"))
        if sorted(port) != names:
            raise AssertionError(f"platform manifests: files {sorted(port)} != {names}")
        mapped = {"command": 0, "image": 0, "limits": 0}
        for name in names:
            with open(os.path.join(ref_dir, name)) as f:
                ref = [d for d in yaml.safe_load_all(f) if d is not None]
            got = copy.deepcopy(port[name])
            for doc, want in zip(got, ref):
                pods = [d.get("spec", {}).get("template", {}).get("spec", {})
                        for d in (doc, want)]
                for c, w in zip(pods[0].get("containers", []), pods[1].get("containers", [])):
                    if c.get("image") == "ccfd-tpu-torch:latest":
                        c["image"] = w.get("image")
                        mapped["image"] += 1
                    cmd, wcmd = c.get("command", []), w.get("command", [])
                    # the same command but for the module the image runs
                    if (cmd[2:3] == ["ccfd_tpu_torch"] and len(cmd) == len(wcmd)
                            and cmd[:2] + cmd[3:] == wcmd[:2] + wcmd[3:]):
                        c["command"] = wcmd
                        mapped["command"] += 1
                    if c.get("resources", {}).get("limits") == {"nvidia.com/gpu": 1}:
                        c["resources"]["limits"] = w.get("resources", {}).get("limits")
                        mapped["limits"] += 1
            if got != ref:
                raise AssertionError(f"platform manifests: {name} differs from the "
                                     "reference's beyond the command, image and GPU limit")
        if mapped["limits"] != 1 or mapped["image"] != mapped["command"] or not mapped["image"]:
            raise AssertionError(f"platform manifests: mapped fields {mapped}")
        log("platform", f"ok: manifests: {len(names)} files, every document the reference's "
            f"but {mapped['command']} commands, {mapped['image']} images and the scorer's "
            "nvidia.com/gpu limit")

    def platform_up(self) -> int:
        """(2) ``python -m ccfd_tpu_torch up -f <CR> --exit-after-producer``
        as a process on the card: the store seeds the dataset, the scorer
        trains ``train_steps`` on the card and serves B1 in the router and
        REST lanes, the engine recovers from its checkpoint file; while it
        runs, 16-row POSTs are held against B1's plain version on the
        served params (retrained here from the same seed, the params'
        sha256 compared with the one `up` prints), and /healthz, /profile,
        /debug/device, /prometheus/slo and the build counter are read;
        after it exits, conservation from its final registries. Returns
        B1's launches."""
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import load_dataset
        from ccfd_tpu_torch.ops import fused_mlp
        from ccfd_tpu_torch.params import digest
        from ccfd_tpu_torch.parallel.train import TrainConfig, fit_mlp

        tag = "platform (2) up"
        tmp = tempfile.mkdtemp(prefix="ccfd_up_")
        cr = self.platform_cr(tmp, scorer={"model": "mlp", "train_steps": PLATFORM_TRAIN_STEPS,
                                           "rest": True},
                              engine={"crash_recovery": True},
                              # an SLO tick every 0.5 s: the gauges exist
                              # before the burst is over
                              slo={"interval_s": 0.5},
                              producer={"transactions": PLATFORM_ROWS})
        s = cr["spec"]
        path = os.path.join(tmp, "cr.json")  # JSON is YAML
        with open(path, "w") as f:
            json.dump(cr, f)
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CCFD_CSV")}
        env["PYTHONPATH"] = REPO
        err_path = os.path.join(tmp, "up.log")
        t0 = time.perf_counter()
        with open(err_path, "w") as err:
            proc = subprocess.Popen([sys.executable, "-m", "ccfd_tpu_torch", "up", "-f", path,
                                     "--exit-after-producer", "--drain-s", "180"],
                                    cwd=tmp, env=env, stdout=subprocess.DEVNULL, stderr=err)
        mon = f"http://127.0.0.1:{s['monitoring']['port']}"
        try:
            Roles.wait(f"http://127.0.0.1:{s['health']['port']}/readyz", proc, 300)
            ready_s = time.perf_counter() - t0
            live = self.platform_live(mon, s["scorer"]["port"])
            code = proc.wait(timeout=300)
        except BaseException:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            with open(err_path, errors="replace") as f:
                print(f"--- up log (tail) ---\n{f.read()[-4000:]}", flush=True)
            raise
        wall = time.perf_counter() - t0
        with open(err_path, errors="replace") as f:
            text = f.read()
        if code != 0 or "router drained" not in text:
            print(f"--- up log (tail) ---\n{text[-4000:]}", flush=True)
            raise AssertionError(f"{tag}: exited {code}")
        blocks = self.platform_blocks(text)
        # the served params: the same fit_mlp from the same seed on the card
        ds = load_dataset()
        params = fit_mlp(ds.X, ds.y, steps=PLATFORM_TRAIN_STEPS,
                         tc=TrainConfig(compute_dtype="float32"), device=self.dev)
        served = text.split("params sha256 ", 1)[1].split(";", 1)[0]
        if digest(params) != served:
            raise AssertionError(f"{tag}: retrained params {digest(params)} are not the "
                                 f"served {served}")
        kp = fused_mlp.pack_for_kernel(fused_mlp.fold_for_kernel(params), self.dev)

        def plain(x):
            return fused_mlp.fused_mlp_reference(
                kp, self.torch.from_numpy(x).to(self.torch.bfloat16).to(self.dev))

        worst = max(rest_check("fused_mlp_bf16", plain, x, p, f"{tag}: POST")[0]
                    for x, p in live["posts"])
        r, kie, seldon, slo = (blocks[k] for k in ("router", "kie", "seldon", "slo"))
        fraud = r.get('transaction_outgoing_total{type="fraud"}', 0.0)
        standard = r.get('transaction_outgoing_total{type="standard"}', 0.0)
        started = sum(v for k, v in kie.items() if k.startswith("process_instances_started"))
        incoming = r.get("transaction_incoming_total", 0.0)
        b1 = launches_of(seldon)
        disp = seldon.get("ccfd_scorer_dispatches", 0.0)
        warm = len(Config.from_env().batch_sizes)
        builds = (live["builds"], slo.get("ccfd_build_events_total", 0.0))
        fails = []
        if not incoming == fraud + standard == started == PLATFORM_ROWS:
            fails.append(f"incoming {incoming}, routed {fraud} + {standard}, starts {started}")
        if b1 != disp + warm or not disp:
            fails.append(f"B1 launches {b1} != dispatches {disp} + {warm} warmup")
        if builds[1] != builds[0]:
            fails.append(f"builds while serving: {builds}")
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        prof = blocks["profile"]["stages"]
        log("platform", f"ok: {tag}: ready in {ready_s:.3f} s (the scorer trained "
            f"{PLATFORM_TRAIN_STEPS} steps on the card first), exited 0 after {wall:.3f} s; "
            f"{PLATFORM_ROWS} transactions: incoming {incoming:.0f} = routed {fraud:.0f} fraud "
            f"+ {standard:.0f} standard = engine starts {started:.0f}; B1 launches {b1:.0f} = "
            f"dispatches {disp:.0f} + {warm} warmup; builds {builds[0]:.0f} at ready, "
            f"{builds[1]:.0f} at exit; {len(live['posts'])} 16-row POSTs within b1_tol_p of "
            f"plain (max |dp| {worst:.3e}) on params sha256 {served}")
        log("platform", f"{tag}: the profile at exit (p50 / p99 ms): "
            + "; ".join(f"{st} {c} {prof[st][c]['p50_ms']} / {prof[st][c]['p99_ms']}"
                        for st, c in (("bus", "queue"), ("router.decode", "service"),
                                      ("router.score", "dispatch"), ("router.route", "service"),
                                      ("rest.batcher", "queue"), ("rest.dispatch", "dispatch"))
                        if prof.get(st, {}).get(c, {}).get("count"))
            + f" on {self.card}")
        shutil.rmtree(tmp, ignore_errors=True)
        return int(b1)

    def platform_live(self, mon: str, sport: int) -> dict:
        """What (2) reads while the platform runs: the build counter at
        ready, 16-row POSTs, /healthz, /profile, /debug/device and the SLO
        gauges."""
        import http.client

        from ccfd_tpu_torch.config import Config

        builds = scrape(f"{mon}/prometheus/slo").get("ccfd_build_events_total", 0.0)
        conn = http.client.HTTPConnection("127.0.0.1", sport, timeout=60)
        posts = []
        for i in range(PLATFORM_POSTS):
            x = self.rows[i * 16:(i + 1) * 16]
            posts.append((x, post(conn, x)[0]))
        conn.close()
        want = ("bus", "router.decode", "router.score", "router.route", "rest.batcher",
                "rest.dispatch", "rest")
        deadline = time.monotonic() + 30
        while True:  # until every stage has fed and the SLO engine ticked
            with urllib.request.urlopen(f"{mon}/profile", timeout=30) as r:
                prof = json.loads(r.read())
            slo = scrape(f"{mon}/prometheus/slo")
            if (all(st in prof["stages"] for st in want)
                    and any(k.startswith("ccfd_slo_burn_rate{") for k in slo)) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        with urllib.request.urlopen(f"{mon}/healthz", timeout=30) as r:
            health = (r.status, json.loads(r.read()))
        with urllib.request.urlopen(f"{mon}/debug/device", timeout=30) as r:
            dev = json.loads(r.read())
        fails = []
        if health[0] != 200 or not health[1]["healthy"]:
            fails.append(f"/healthz {health}")
        stages = prof["stages"]
        for st in want:
            if st not in stages or not {"queue", "service", "dispatch"} <= set(stages[st]):
                fails.append(f"/profile lacks {st}")
        mem = dev["memory"].get("cuda:0", {})
        sc = dev["executables"].get("scorer", {})
        if not (mem.get("bytes_in_use", 0) > 0 and dev["h2d"]["bytes_total"] > 0
                and dev["h2d"]["transfer"]["count"] > 0):
            fails.append(f"/debug/device memory {mem}, h2d {dev['h2d']}")
        if sc.get("kernel") != "fused_mlp_bf16" or sc.get("warmed") != list(
                Config.from_env().batch_sizes):
            fails.append(f"/debug/device inventory {sc}")
        if not any(k.startswith("ccfd_slo_burn_rate{") for k in slo):
            fails.append("no ccfd_slo_burn_rate on /prometheus/slo")
        if fails:
            raise AssertionError("platform (2) live: " + "; ".join(fails))
        log("platform", f"ok: platform (2) live: /healthz 200 {sorted(health[1]['sources'])}; "
            f"/profile stages {sorted(stages)}; /debug/device cuda:0 bytes_in_use "
            f"{mem['bytes_in_use']}, bytes_limit {mem.get('bytes_limit')}, H2D "
            f"{dev['h2d']['bytes_total']} bytes in {dev['h2d']['transfer']['count']} copies "
            f"(p50 {dev['h2d']['transfer'].get('p50_ms')} ms); inventory {sc['kernel']} x "
            f"{sc['warmed']}; {sum(1 for k in slo if k.startswith('ccfd_slo_burn_rate{'))} "
            f"burn-rate series on {self.card}")
        return {"builds": builds, "posts": posts}

    @staticmethod
    def platform_blocks(text: str) -> dict:
        """`up`'s exit dump -> {registry: {"name{labels}": value}}, and the
        profile and device documents."""
        out: dict = {}
        cur = None
        for line in text.splitlines():
            if line.startswith("--- ") and line.endswith(" ---"):
                cur = line[4:-4]
                out[cur] = {}
            elif cur in ("profile", "device") and line.startswith("{"):
                out[cur] = json.loads(line)
            elif cur is not None and line and not line.startswith("#") and " " in line:
                key, _, val = line.rpartition(" ")
                try:
                    out[cur][key] = float(val)
                except ValueError:
                    pass
        return out

    def platform_recovery(self) -> int:
        """(3) An in-process Platform on the card (the port's CR, the scorer
        on REST, crash recovery with a 0.5 s checkpoint interval): an engine
        failure injected mid-stream restores the last cut and re-drives the
        gap; after ``down()`` a second Platform on the same log dir and
        checkpoint file restores the saved cut at bring-up. Every
        transaction is started exactly once (the surviving engine's
        ``next_pid``). Returns B1's launches."""
        import http.client

        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import Dataset, iter_transactions
        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
        from ccfd_tpu_torch.ops.fused_mlp import fused_mlp_reference
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec
        from ccfd_tpu_torch.runtime.durability import read_json_artifact

        tag = "platform (3) recovery"
        tmp = tempfile.mkdtemp(prefix="ccfd_recovery_")
        cr = self.platform_cr(tmp, store={"enabled": False}, producer={"enabled": False},
                              retrain={"enabled": False},
                              scorer={"model": "mlp", "train_steps": 0, "rest": True},
                              engine={"crash_recovery": True, "rest": True, "rest_port": 0,
                                      "checkpoint_interval_s": 0.5})
        cfg = Config.from_env()
        n1, n2 = RECOVERY_ROWS
        ds = kaggle_surrogate(n=n1 + n2, seed=SEED)
        rows = list(iter_transactions(Dataset(X=ds.X, y=ds.y)))
        cut_path = cr["spec"]["engine"]["checkpoint_file"]
        counters = self.counters()
        for c in counters.values():
            c.reset()

        def wait(pred, what: str, timeout: float = 120.0) -> None:
            deadline = time.monotonic() + timeout
            while not pred():
                if time.monotonic() > deadline:
                    raise AssertionError(f"{tag}: {what} not reached in {timeout} s")
                time.sleep(0.01)

        p = Platform(PlatformSpec.from_cr(cr, cfg=cfg)).up(wait_ready_s=120)
        dispatched = 0
        try:
            incoming = p.registries["router"].counter("transaction_incoming_total")

            def stream() -> None:  # the first burst over ~2 s, 500 rows a batch
                for i in range(0, n1, 500):
                    part = rows[i:i + 500]
                    p.broker.produce_batch(cfg.kafka_topic, part, [r["id"] for r in part])
                    time.sleep(0.05)

            producer = threading.Thread(target=stream, daemon=True)
            producer.start()
            wait(lambda: incoming.value() >= n1 // 2 and p.recovery.checkpoints > 0,
                 "a checkpoint with half the first burst routed")
            old = p.engine
            t0 = time.perf_counter()
            if not p.supervisor.inject_failure("engine", "smoke"):
                raise AssertionError(f"{tag}: the engine service was not running")
            wait(lambda: p.recovery.restores == 1 and p.engine is not old, "the restore")
            crash_ms = (time.perf_counter() - t0) * 1e3
            restore_ms = p.recovery.last_restore_s * 1e3
            mid = incoming.value()  # rows consumed when the restore landed
            producer.join()
            p.broker.produce_batch(cfg.kafka_topic, rows[n1:], [r["id"] for r in rows[n1:]])
            wait(lambda: p.engine.snapshot()["next_pid"] - 1 >= n1 + n2, "every start")
            k = p.recovery.checkpoints
            wait(lambda: p.recovery.checkpoints >= k + 2, "two more checkpoints")
            # REST through the same scorer: B1 against its plain version on
            # the live kernel params
            kp = p.scorer._live[1]
            conn = http.client.HTTPConnection("127.0.0.1", p.prediction_port, timeout=60)
            worst = 0.0
            for i in range(20):
                x = self.rows[i * 16:(i + 1) * 16]
                got = post(conn, x)[0]
                worst = max(worst, rest_check("fused_mlp_bf16", lambda z: fused_mlp_reference(
                    kp, self.torch.from_numpy(z).to(self.torch.bfloat16).to(self.dev)),
                    x, got, f"{tag}: POST")[0])
            conn.close()
            next_pid = p.engine.snapshot()["next_pid"]
            start_errors = p.registries["router"].counter(
                "router_process_start_errors_total").total()
            dispatched += p.scorer.dispatch_total()
        finally:
            p.down()
        saved = read_json_artifact(cut_path, artifact="recovery_cut", quarantine=False)
        cut_bytes = os.path.getsize(cut_path)
        p2 = Platform(PlatformSpec.from_cr(cr, cfg=cfg)).up(wait_ready_s=120)
        try:
            boot = p2.recovery._last
            boot_ms = p2.recovery.last_restore_s * 1e3
            same = (boot["snap"] == saved["snap"] and boot["offsets"] == saved["offsets"])
            boot_pid = p2.engine.snapshot()["next_pid"]
            restores2 = p2.recovery.restores
            dispatched += p2.scorer.dispatch_total()
        finally:
            p2.down()
        launched = counters["fused_mlp_bf16"].value
        warm = 2 * len(cfg.batch_sizes)
        fails = []
        if next_pid - 1 != n1 + n2:
            fails.append(f"the engine started {next_pid - 1} processes for {n1 + n2} rows")
        if restores2 != 1 or not same or boot_pid != next_pid:
            fails.append(f"the bounce: {restores2} restores, cut equal {same}, next_pid "
                         f"{boot_pid} (before {next_pid})")
        if launched != dispatched + warm:
            fails.append(f"B1 launches {launched} != dispatches {dispatched} + {warm} warmup")
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        log("platform", f"ok: {tag}: an engine failure injected mid-stream (after a "
            f"checkpoint; {mid:.0f} of {n1} rows consumed at the restore) restored its cut in "
            f"{restore_ms:.3f} ms (the "
            f"service back {crash_ms:.3f} ms after the kill); {n1 + n2} transactions, each "
            f"started exactly once (next_pid {next_pid}; {start_errors:.0f} starts into the "
            f"stopped engine re-driven); the bounce restored the saved cut ({cut_bytes} bytes "
            f"on disk) at bring-up in {boot_ms:.3f} ms, equal to what was saved; 20 POSTs "
            f"max |dp| {worst:.3e}; B1 launches {launched} = dispatches {dispatched} + {warm} "
            f"warmup on {self.card}")
        shutil.rmtree(tmp, ignore_errors=True)
        return int(launched)

    def platform_fixed_rate(self) -> int:
        """(4) The operator pipeline (the port's CR: store and retrain off,
        the scorer's seeded MLP on B1, a memory bus) with the producer at a
        fixed rate for FIXED_SECONDS: decision p50/p99 against the 10 ms
        limit, the profiler's router stages (queueing, service, dispatch),
        the H2D copies' device time, and the card's busy share from a
        device-only torch.profiler trace over the run. Returns B1's
        launches."""
        from torch.profiler import ProfilerActivity, profile

        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import to_csv_bytes
        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

        tmp = tempfile.mkdtemp(prefix="ccfd_rate_")
        csv = os.path.join(tmp, "rows.csv")
        most = max(FIXED_RATES) * FIXED_SECONDS
        with open(csv, "wb") as f:
            f.write(to_csv_bytes(kaggle_surrogate(n=most, seed=SEED)))
        counters = self.counters()
        launched = 0
        old_csv = os.environ.get("CCFD_CSV")
        os.environ["CCFD_CSV"] = csv  # the producer's dataset
        try:
            for rate in FIXED_RATES:
                tag = f"platform (4) {rate}/s"
                n = rate * FIXED_SECONDS
                cr = self.platform_cr(tmp, store={"enabled": False}, retrain={"enabled": False},
                                      bus={"log_dir": None},
                                      engine={"crash_recovery": False},
                                      scorer={"model": "mlp", "train_steps": 0, "rest": False},
                                      producer={"transactions": n, "rate": rate})
                cfg = Config.from_env()
                for c in counters.values():
                    c.reset()
                p = Platform(PlatformSpec.from_cr(cr, cfg=cfg))
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    p.up(wait_ready_s=120)
                    try:
                        t1 = time.perf_counter()
                        if not p.wait_producer(FIXED_SECONDS * 3 + 60):
                            raise AssertionError(f"{tag}: the producer did not finish")
                        produced_s = time.perf_counter() - t1
                        if not p.wait_routed(120):
                            raise AssertionError(f"{tag}: the router did not drain")
                        window = time.perf_counter() - t1
                        rr = p.registries["router"]
                        dec = rr.histogram("router_decision_seconds")
                        incoming = rr.counter("transaction_incoming_total").value()
                        routed = rr.counter("transaction_outgoing_total").total()
                        doc = p.profiler.snapshot()["stages"]
                        h2d = p.device_telemetry.h2d_digest().to_dict()
                        h2d_bytes = p.device_telemetry.h2d_bytes()
                        dispatched = p.scorer.dispatch_total()
                        warm = len(p.scorer.batch_sizes)
                    finally:
                        p.down()
                events = prof.key_averages()
                busy = sum(getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0.0) for e in events) / 1e6
                # the copies' own device time, from the trace's memcpy rows
                # (the telemetry's CUDA events also hold the stream's idle
                # time while the host enqueues the copy)
                htod = [e for e in events if "HtoD" in e.key]
                htod_us = sum(getattr(e, "self_device_time_total", None)
                              or getattr(e, "self_cuda_time_total", 0.0) for e in htod)
                htod_n = sum(e.count for e in htod)
                b1 = counters["fused_mlp_bf16"].value
                launched += b1
                if incoming != n or routed != n or b1 != dispatched + warm:
                    raise AssertionError(f"{tag}: {n} produced, {incoming} incoming, {routed} "
                                         f"routed; B1 {b1} != {dispatched} + {warm}")
                p50, p99 = dec.quantile(0.5) * 1e3, dec.quantile(0.99) * 1e3

                def q(st, c):
                    d = doc.get(st, {}).get(c, {})
                    return f"{d.get('p50_ms')} / {d.get('p99_ms')}" if d.get("count") else "-"

                log("platform", f"ok: {tag}: {n} transactions produced in {produced_s:.3f} s "
                    f"({n / produced_s:.1f}/s achieved of the {rate}/s asked), "
                    f"all routed {window:.3f} s after the first; decision p50 {p50:.3f} ms, "
                    f"p99 {p99:.3f} ms against the 10 ms limit "
                    f"({'met' if p99 < 10 else 'missed'}); router stages p50 / p99 ms: bus "
                    f"queue {q('bus', 'queue')}, decode service "
                    f"{q('router.decode', 'service')}, score dispatch "
                    f"{q('router.score', 'dispatch')}, route service "
                    f"{q('router.route', 'service')}; H2D {h2d.get('count', 0)} copies, "
                    f"{h2d_bytes} bytes, CUDA-event brackets p50 {h2d.get('p50_ms')} ms p99 "
                    f"{h2d.get('p99_ms')} ms (sum {h2d.get('sum_s', 0) * 1e3:.3f} ms), the "
                    f"trace's HtoD copies {htod_n}, {htod_us:.3f} us of device time"
                    + (f" ({htod_us / htod_n:.3f} us a copy)" if htod_n else "") + "; "
                    + (f"the card busy {busy * 1e3:.3f} ms (device-only trace from "
                       f"bring-up, {time.perf_counter() - t0:.3f} s): busy share over the "
                       f"routed window {busy / window:.5f}" if busy else
                       "the card's busy share not measured (no device events in the trace)")
                    + f"; B1 launches {b1} = dispatches {dispatched} + {warm} warmup on "
                    f"{self.card}")
        finally:
            if old_csv is None:
                os.environ.pop("CCFD_CSV", None)
            else:
                os.environ["CCFD_CSV"] = old_csv
            shutil.rmtree(tmp, ignore_errors=True)
        return int(launched)

    def models(self) -> None:
        """The reference's other Seldon models on the card: parity card
        against CPU, the committed tree ensemble's held-out AUC, REST and
        `score` on the card (no hand kernel on these paths), and device
        times."""
        from ccfd_tpu_torch import cli
        from ccfd_tpu_torch.models import logreg

        torch = self.torch
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on: the models' float32 products would round")
        self.m_logreg = logreg.fit_numpy(self.rows.astype("float64"), self.labels)
        self.m_trees = {"artifact": cli.restore_gbt_params(os.path.join(REPO, "checkpoints_gbt")),
                        "seeded depth-8": self.seeded_trees()}
        if self.m_trees["artifact"] is None:
            raise AssertionError("checkpoints_gbt/params.npz is missing or unreadable")
        self.models_parity()
        self.models_auc()
        self.models_rest()
        self.models_score()
        self.models_timing()

    def seeded_trees(self) -> dict:
        """SEEDED_TREES depth-8 trees: split features drawn at random,
        thresholds at data quantiles, DEAD_SLOTS of the internal slots dead."""
        import numpy as np

        rng = np.random.default_rng(SEED)
        n_int, torch = 255, self.torch
        feat = rng.integers(0, self.rows.shape[1], (SEEDED_TREES, n_int)).astype(np.int32)
        ranks = (rng.uniform(0.02, 0.98, feat.shape) * (len(self.rows) - 1)).astype(np.int64)
        thr = np.sort(self.rows, axis=0)[ranks, feat]  # each node's column at a quantile
        thr = np.where(rng.random(thr.shape) < DEAD_SLOTS, np.inf, thr).astype(np.float32)
        return {"feature": torch.from_numpy(feat), "threshold": torch.from_numpy(thr),
                "leaf": torch.from_numpy(rng.normal(0, 0.1, (SEEDED_TREES, 256)).astype(
                    np.float32)), "base": torch.tensor(-2.0)}

    def model_rows(self, nonfinite: bool = False):
        """MODEL_BATCHES[-1] surrogate rows; with ``nonfinite`` a seeded
        NONFINITE_ROWS of them carry a NaN, +inf or -inf cell."""
        import numpy as np

        x = self.rows[:MODEL_BATCHES[-1]].copy()
        if nonfinite:
            rng = np.random.default_rng(SEED + 1)
            rows = rng.choice(len(x), int(len(x) * NONFINITE_ROWS), replace=False)
            rows[:4] = (1, 5, 9, 13)  # some in the smallest batch too
            cols = rng.integers(0, x.shape[1], len(rows))
            x[rows, cols] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                                       len(rows))
        return x

    def graph_params(self, spec) -> dict:
        """A graph's seeded init, with the committed checkpoint in an
        ``mlp`` node, the fitted logreg in ``modelfull`` and the committed
        ensemble in ``trees``, so every node's output spreads."""
        from ccfd_tpu_torch.params import load_params

        p = spec.init(self.torch.Generator().manual_seed(SEED))
        for node, value in (("mlp", load_params()), ("modelfull", self.m_logreg),
                            ("trees", self.m_trees["artifact"])):
            if node in p:
                p[node] = value
        return p

    def models_parity(self) -> None:
        import numpy as np

        from ccfd_tpu_torch.models import logreg, trees
        from ccfd_tpu_torch.params import to_device
        from ccfd_tpu_torch.serving import graph

        torch, dev = self.torch, self.dev

        def both(x):
            return torch.from_numpy(x), torch.from_numpy(x).to(dev)

        def check(name: str, what: str, got, want, tol: float) -> float:
            d = (got.double() - want.double()).abs().max().item()
            log("models", f"{name} {what}: card vs CPU max|d|={d:.3e} (bar {tol:.1e})")
            if not d <= tol or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {what}: card and CPU differ by {d} (bar {tol})")
            return d

        x_fin = self.model_rows()
        lr_cpu, lr_card = self.m_logreg, to_device(self.m_logreg, dev)
        for dt in (torch.bfloat16, torch.float32):
            for b in MODEL_BATCHES:
                xc, xd = both(x_fin[:b])
                check("logreg", f"{str(dt)[6:]} B={b}", logreg.apply(lr_card, xd, dt).cpu(),
                      logreg.apply(lr_cpu, xc, dt), MODEL_TOL_P)
        x_nf = self.model_rows(nonfinite=True)
        for which, tp in self.m_trees.items():
            t = tp["leaf"].shape[0]
            card = to_device(tp, dev)
            for b in MODEL_BATCHES:
                xc, xd = both(x_nf[:b])
                what = f"{which} (T={t}, D={trees.depth_of(tp)}) B={b}"
                leaves = trees.leaf_indices(tp, xc)
                for name, fn in (("gbt", trees.leaf_indices), ("gbt_mxu", trees.leaf_indices_mxu)):
                    got = fn(card, xd).cpu()
                    if not torch.equal(got, leaves):
                        raise AssertionError(f"{name} {what}: {(got != leaves).sum().item()} "
                                             "leaf indices differ from the CPU's")
                z_cpu = trees.logits(tp, xc)
                z_card, z_mxu = trees.logits(card, xd).cpu(), trees.logits_mxu(card, xd).cpu()
                check("gbt", what + ", z", z_card, z_cpu, TREE_TOL_Z * t)
                check("gbt_mxu", what + ", z", z_mxu, z_cpu, TREE_TOL_Z * t)
                d = (z_mxu - z_card).abs().max().item()
                log("models", f"gbt_mxu {what}: every leaf index equal to the CPU's; z vs gbt "
                    f"on the card max|d|={d:.3e} (bar {MXU_TOL_Z:.0e}); rows with a "
                    f"non-finite cell {int((~torch.isfinite(xc)).any(1).sum())}")
                if not d <= MXU_TOL_Z:
                    raise AssertionError(f"gbt_mxu vs gbt on the card ({what}): {d}")
        spec = graph.load_graph_cr(os.path.join(REPO, GRAPH_CR))
        gp = self.graph_params(spec)
        gp_card = to_device(gp, dev)
        for dt in (torch.bfloat16, torch.float32):
            for b in MODEL_BATCHES:
                xc, xd = both(x_fin[:b])
                check(spec.name, f"{str(dt)[6:]} B={b}", spec.apply(gp_card, xd, dt).cpu(),
                      spec.apply(gp, xc, dt), MODEL_TOL_P)
        self.models_hash_split(x_fin, both, check)

    def models_hash_split(self, x_fin, both, check) -> None:
        """The hash_split ROUTER graph: the card's arms against the port's
        numpy mirror (a row may differ only where u lies within
        HASH_SPLIT_MARGIN_ULPS of a boundary), then p against the CPU on
        the rows the card and the CPU route alike."""
        import numpy as np

        from ccfd_tpu_torch.params import to_device
        from ccfd_tpu_torch.serving import graph

        torch = self.torch
        g = graph.InferenceGraph.from_cr(ROUTED_CR)
        spec = g.as_model_spec()
        gp = self.graph_params(spec)
        gp_card = to_device(gp, self.dev)
        weights = [0.7, 0.3]
        for b in MODEL_BATCHES:
            x = x_fin[:b]
            xc, xd = both(x)
            arms = {"card": graph.hash_split_arms(xd, gp_card["ab"]["cum"]).cpu().numpy(),
                    "cpu": graph.hash_split_arms(xc, gp["ab"]["cum"]).numpy(),
                    "numpy": graph.hash_split_arms_numpy(x, weights)}
            margin = graph.hash_split_margin_ulps(x, weights)
            for a, bb in (("card", "numpy"), ("card", "cpu")):
                differ = np.flatnonzero(arms[a] != arms[bb])
                log("models", f"hash_split B={b}: {len(differ)} rows whose arm on the {a} "
                    f"differs from the {bb}'s; their u lies "
                    f"{[round(float(m), 3) for m in margin[differ]]} f32 ulps of |h| "
                    f"from a boundary (bar {graph.HASH_SPLIT_MARGIN_ULPS}; arm shares "
                    f"{np.bincount(arms['card'], minlength=2) / b})")
                if (margin[differ] > graph.HASH_SPLIT_MARGIN_ULPS).any():
                    raise AssertionError(f"hash_split B={b}: a {a} arm differs from the "
                                         f"{bb}'s away from a boundary: {margin[differ]}")
            same = torch.from_numpy(arms["card"] == arms["cpu"])
            check(spec.name, f"float32 B={b}, the {int(same.sum())} rows routed alike",
                  spec.apply(gp_card, xd, torch.float32).cpu()[same],
                  spec.apply(gp, xc, torch.float32)[same], MODEL_TOL_P)

    def models_auc(self) -> None:
        """CCFD_MODEL=gbt on the card (what `serve` builds) on the
        reference's held-out split of the full surrogate."""
        from ccfd_tpu_torch import cli
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
        from ccfd_tpu_torch.utils.metrics_math import roc_auc

        ds = kaggle_surrogate()
        test, _train = cli.held_out_split(ds.n, 0.2)
        cfg = Config.from_env({**os.environ, "CCFD_MODEL": "gbt"})
        scorer = cli.make_scorer(cfg, cli.served_params(
            cfg, gbt_dir=os.path.join(REPO, "checkpoints_gbt")), self.dev)
        t0 = time.perf_counter()
        p = scorer.score_pipelined(ds.X[test])
        dt = time.perf_counter() - t0
        auc = roc_auc(ds.y[test], p)
        log("models", f"gbt held-out AUC on the card {auc:.6f} over {len(test)} rows "
            f"(scored in {dt:.3f} s) against the recorded auc_hgb_served {RECORDED_AUC_HGB} "
            f"(|d| {abs(auc - RECORDED_AUC_HGB):.2e}, bar {AUC_HGB_BAR:.0e})")
        if abs(auc - RECORDED_AUC_HGB) > AUC_HGB_BAR:
            raise AssertionError(f"gbt held-out AUC {auc} != recorded {RECORDED_AUC_HGB}")

    def models_rest(self) -> None:
        """`serve` with CCFD_MODEL=modelfull, gbt and CCFD_GRAPH_CR on the
        card through the C++ front: SEQ_POSTS sequential 16-row POSTs, each
        answer against the model's torch function on the CPU; no hand
        kernel launched (the counts set to 0 just before, read just after)."""
        import http.client

        from ccfd_tpu_torch import cli
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.params import to_device

        torch = self.torch
        counters = self.counters()
        for label, env in (("modelfull", {"CCFD_MODEL": "modelfull"}),
                           ("gbt", {"CCFD_MODEL": "gbt"}),
                           ("graph", {"CCFD_GRAPH_CR": os.path.join(REPO, GRAPH_CR)})):
            srv = cli.build_server(Config.from_env({**os.environ, **env}), device=self.dev)
            scorer = srv.scorer
            if srv.transport != "native-front" or scorer.fused or scorer.device != self.dev:
                raise AssertionError(f"serve {label}: {srv.transport} {scorer.executable_grid()}")
            plain = to_device(scorer.params, "cpu")
            port = srv.start("127.0.0.1", 0)
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                for c in counters.values():
                    c.reset()
                d0 = scorer.dispatch_total()
                seq, lat = sequential_posts(conn, self.rows, SEQ_POSTS)
                launched = {k: c.value for k, c in counters.items()}
                dispatched = scorer.dispatch_total() - d0
                conn.close()
            finally:
                srv.stop()
            worst = max(float((torch.from_numpy(p) - scorer.spec.apply(
                plain, torch.from_numpy(x), scorer.compute_dtype).double()).abs().max())
                for x, p in seq)
            log("models", f"serve {' '.join(f'{k}={v}' for k, v in env.items())} (model "
                f"{scorer.spec.name}, {srv.transport}): {SEQ_POSTS} sequential POSTs of 16 rows, "
                f"{quantiles(lat)}; max|dp| vs the CPU {worst:.3e}; dispatches {dispatched}, "
                f"hand-kernel launches {launched} on {self.card}")
            if worst > MODEL_TOL_P or dispatched != SEQ_POSTS or any(launched.values()):
                raise AssertionError(f"serve {label}: |dp| {worst}, dispatches {dispatched}, "
                                     f"launches {launched}")

    def models_score(self) -> None:
        """`python -m ccfd_tpu_torch score` with CCFD_MODEL=gbt over
        SCORE_ROWS surrogate rows on the card and on the CPU."""
        import io

        import numpy as np

        from ccfd_tpu_torch import cli
        from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES

        tmp = tempfile.mkdtemp(prefix="ccfd_score_")
        old = os.environ.get("CCFD_MODEL")
        counters = self.counters()
        try:
            csv = os.path.join(tmp, "rows.csv")
            with open(csv, "w") as f:
                f.write(",".join(FEATURE_NAMES + ("Class",)) + "\n")
                for row, y in zip(self.rows[:SCORE_ROWS], self.labels[:SCORE_ROWS]):
                    f.write(",".join(repr(float(v)) for v in row) + f",{int(y)}\n")
            os.environ["CCFD_MODEL"] = "gbt"
            docs, probas = {}, {}
            for device in (self.dev.type, "cpu"):
                out = io.StringIO()
                for c in counters.values():
                    c.reset()
                with contextlib.redirect_stdout(out):
                    rc = cli.main(["score", "--input", csv, "--output",
                                   os.path.join(tmp, f"{device}.csv"), "--device", device,
                                   "--gbt-dir", os.path.join(REPO, "checkpoints_gbt")])
                docs[device] = json.loads(out.getvalue().strip().splitlines()[-1])
                launched = {k: c.value for k, c in counters.items()}
                with open(os.path.join(tmp, f"{device}.csv")) as f:
                    probas[device] = np.array(f.read().split()[1:], np.float64)
                log("models", f"score CCFD_MODEL=gbt --device {device}: rc {rc}, "
                    f"{json.dumps(docs[device])}; hand-kernel launches {launched}")
                if rc != 0 or docs[device]["rows"] != SCORE_ROWS or not docs[device][
                        "checkpoint"] or any(launched.values()):
                    raise AssertionError(f"score --device {device}: {docs[device]}")
            card = self.dev.type
            d = float(np.abs(probas[card] - probas["cpu"]).max())
            log("models", f"score: the card's proba file vs the CPU's max|dp| {d:.3e} over "
                f"{len(probas[card])} rows (bar {MODEL_TOL_P:.0e}); {docs[card]['tx_s']} "
                f"tx/s on the card ({docs[card]['seconds']} s) on {self.card}")
            if len(probas[card]) != SCORE_ROWS or not d <= MODEL_TOL_P or \
                    docs[card]["flagged_fraud"] != docs["cpu"]["flagged_fraud"]:
                raise AssertionError(f"score: card and CPU files differ by {d}")
        finally:
            if old is None:
                os.environ.pop("CCFD_MODEL", None)
            else:
                os.environ["CCFD_MODEL"] = old
            shutil.rmtree(tmp, ignore_errors=True)

    def models_timing(self) -> None:
        """Device ms a call at MODEL_BATCHES for each model (a CUDA graph of
        back-to-back calls), beside a bound from its bytes and
        operations; the peak memory of gbt_mxu; and B1 on the ensemble's
        ``mlp`` node params, the yardstick for that node."""
        from ccfd_tpu_torch.models import logreg, mlp, trees
        from ccfd_tpu_torch.ops.fused_mlp import fold_for_kernel, fused_mlp_score, pack_for_kernel
        from ccfd_tpu_torch.params import flatten, to_device
        from ccfd_tpu_torch.serving import graph

        torch, dev = self.torch, self.dev

        def device_ms(fn, n: int) -> tuple[float, str]:
            """Device ms a call: ``n`` calls captured in one CUDA graph (every
            model's function captures: no host sync inside), replayed 3
            times between two events."""
            for _ in range(3):
                fn()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(n):
                    fn()
            g.replay()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                g.replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / (3 * n), f"CUDA graph of {n} calls"

        def nbytes(tree) -> int:
            return sum(a.nbytes for a in flatten(tree).values())

        spec = graph.load_graph_cr(os.path.join(REPO, GRAPH_CR))
        gp = to_device(self.graph_params(spec), dev)
        art = to_device(self.m_trees["artifact"], dev)
        lr = to_device(self.m_logreg, dev)
        t_, n_int = art["feature"].shape
        depth = trees.depth_of(art)
        h = gp["mlp"]["layers"][0]["w"].shape[1]
        kp = pack_for_kernel(fold_for_kernel(gp["mlp"]), dev)
        f = self.rows.shape[1]
        mlp_flops = 2 * (f * h + h * h + h)
        times = {}
        for b in MODEL_BATCHES:
            xd = torch.from_numpy(self.rows[:b]).to(dev)
            xb = xd.to(torch.bfloat16)
            n = 20 if b <= 16 else 5
            cases = {
                "logreg bf16": (lambda: logreg.apply(lr, xd, torch.bfloat16), nbytes(lr), 2 * f),
                "logreg f32": (lambda: logreg.apply(lr, xd, torch.float32), nbytes(lr), 2 * f),
                "gbt": (lambda: trees.apply(art, xd), nbytes(art), 2 * t_ * depth),
                "gbt_mxu": (lambda: trees.apply_mxu(art, xd), nbytes(art),
                            2 * f * t_ * n_int),
                f"{spec.name} bf16": (lambda: spec.apply(gp, xd, torch.bfloat16), nbytes(gp),
                                      mlp_flops + 2 * f),
                "mlp node bf16 (torch)": (lambda: mlp.apply(gp["mlp"], xd, torch.bfloat16),
                                          nbytes(gp["mlp"]), mlp_flops),
                "B1 on the mlp node": (lambda: fused_mlp_score(kp, xb), nbytes(gp["mlp"]),
                                       mlp_flops),
            }
            for name, (fn, pbytes, ops_row) in cases.items():
                ms, how = device_ms(fn, n)
                xbytes = b * f * (2 if name.startswith("B1") else 4)
                t_bytes = (xbytes + pbytes + 4 * b) / HBM_BYTES_PER_S * 1e3
                peak = BF16_FLOPS if name.startswith("B1") else F32_FLOPS
                t_ops = b * ops_row / peak * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                times[f"{name} B={b}"] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                                          "bytes_ms": t_bytes, "how": how}
                log("models", f"{name} B={b}: {ms:.6f} ms a call ({how}); bound "
                    f"{bound:.6f} ms ({by}; bytes alone {t_bytes:.6f} ms), {ms / t_bytes:.1f}x "
                    f"its bytes bound on {self.card}")
        xd = torch.from_numpy(self.rows[:MODEL_BATCHES[-1]]).to(dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trees.apply_mxu(art, xd)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        log("models", f"gbt_mxu B={MODEL_BATCHES[-1]} (T={t_}, D={depth}): peak device memory "
            f"{peak / 2**20:.1f} MiB above the inputs; one (B, T*(2^D-1)) float32 temporary "
            f"is {MODEL_BATCHES[-1] * t_ * n_int * 4 / 2**20:.1f} MiB")
        slow = max(times, key=lambda k: times[k]["ms"] / times[k]["bytes_ms"]
                   if k.endswith(f"B={MODEL_BATCHES[-1]}") else 0.0)
        log("models", f"slowest against its bytes bound at B={MODEL_BATCHES[-1]}: {slow} "
            f"({times[slow]['ms'] / times[slow]['bytes_ms']:.1f}x)")
        log("models", "times " + json.dumps(times))

    def timing(self) -> None:
        from ccfd_tpu_torch.ops import fused_mlp_q8 as q8
        from ccfd_tpu_torch.ops.fused_mlp import fused_mlp_reference, fused_mlp_score

        torch = self.torch
        feats = self.rows.shape[1]

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

        def graph_ms(fn, n: int) -> float:
            """Device time per launch: ``n`` launches captured in one CUDA
            graph and replayed between two events, so the Python wrapper's
            host work (checks, allocation, the ctypes call) is not in it."""
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(n):
                    fn()
            graph.replay()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                graph.replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / (5 * n)

        def nbytes(*ts) -> int:
            return sum(t.numel() * t.element_size() for t in ts)

        def cases(kp: dict, kq: dict, b: int) -> dict:
            """kernel: (launch, plain, bytes in + out, operations' peak); the
            bytes are each operand the function needs read once (the plain
            layouts, not the kernels' padded copies) and the output written once"""
            x = self.x_rows(b)
            xf = self.x_rows(b, torch.float32)
            q, s = self.preq_rows(kq, self.rows[:b])
            out = b * 4
            w_b1 = [kp[k] for k in ("w1", "b1", "w2", "b2", "w3", "b3")]
            w_q8 = [kq[k] for k in ("w1t", "s1", "b1", "w2t", "s2", "b2", "w3", "s3", "b3")]
            return {
                "fused_mlp_bf16": (lambda: fused_mlp_score(kp, x),
                                   lambda: fused_mlp_reference(kp, x),
                                   nbytes(x, *w_b1) + out, BF16_FLOPS),
                "fused_mlp_q8": (lambda: q8.fused_mlp_q8_score(kq, xf),
                                 lambda: q8.fused_mlp_q8_reference(kq, xf),
                                 nbytes(xf, kq["mu"], kq["sigma"], *w_q8) + out, INT8_OPS),
                "fused_mlp_q8_preq": (
                    lambda: q8.fused_mlp_q8_score_preq(kq, q, s),
                    lambda: q8.fused_mlp_q8_preq_reference(kq, q, s),
                    nbytes(q, s, *w_q8) + out, INT8_OPS),
            }

        def run(name: str, case: tuple, b: int, hidden: int, what: str,
                profile: bool) -> tuple:
            launch, plain, nbyte, peak = case
            n = 1000 if b <= 1024 else 300
            ops = 2.0 * b * (feats * hidden + hidden * hidden + hidden)
            ms = graph_ms(launch, 100)
            call_ms = time_ms(launch, n)
            plain_ms = time_ms(plain, n)
            ms2 = graph_ms(launch, 100)
            t_ops, t_bytes = ops / peak * 1e3, nbyte / HBM_BYTES_PER_S * 1e3
            bound_ms = max(t_ops, t_bytes)
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            kernel_ms = min(ms, ms2)
            log("timing", f"{name} {what} B={b}: kernel {ms:.6f} / {ms2:.6f} ms (CUDA "
                f"graph of 100 launches, x5), {call_ms:.6f} ms a call through the "
                f"wrapper (events over {n} calls), plain {plain_ms:.6f} ms a call, "
                f"bound {bound_ms:.6f} ms ({bound_by}: {ops:.4e} op, {nbyte} B), "
                f"roofline share {bound_ms / kernel_ms:.4f} on {self.card}")
            # IEEE divisions a row's requantizations take: B2 normalizes F
            # features and quantizes F + 2H values, with one scale per layer
            divs = {"fused_mlp_q8": feats + feats + 2 * hidden + 3,
                    "fused_mlp_q8_preq": 2 * hidden + 2}.get(name)
            if divs:
                div_ms = b * divs * DIV_INSTR / CUDA_CORE_INSTR_PER_S * 1e3
                log("timing", f"{name} {what} B={b}: {divs} IEEE divisions a row, at "
                    f"{DIV_INSTR} CUDA-core instructions each (an estimate): "
                    f"{div_ms:.6f} ms, {div_ms / t_ops:.2f}x the tensor-core time, "
                    f"{div_ms / kernel_ms:.4f} of the kernel's")
            if profile:
                dev_ms = self.device_ms(launch, DEVICE_NAMES[name])
                log("timing", f"{name} {what} B={b}: kernel device time (torch.profiler) "
                    + (f"{dev_ms:.6f} ms, roofline share {bound_ms / dev_ms:.4f}"
                       if dev_ms else "not measured (no device events)")
                    + f" on {self.card}")
            return kernel_ms, plain_ms, bound_ms, bound_by

        kp = self.kernel_params("checkpoint")
        kq = self.q8_kernel_params("checkpoint")
        for b in TIMING_BATCHES:
            for name, case in cases(kp, kq, b).items():
                got = run(name, case, b, 256, "H=256", profile=True)
                if b == TIMING_BATCHES[-1]:
                    kernel_ms, plain_ms, bound_ms, bound_by = got
                    self.reports[name].update(ms=kernel_ms, plain_ms=plain_ms,
                                              bound_ms=bound_ms, bound_by=bound_by)
        # wider models on seeded random params: B1 up to its wide layout
        # (H > 1,024), B2/B3 at the widest H they take
        b = TIMING_BATCHES[-1]
        kq_wide = self.q8_kernel_params("random", feats, 1040)
        for h in B1_TIMED_WIDTHS:
            case = cases(self.kernel_params("random", feats, h), kq_wide, b)["fused_mlp_bf16"]
            run("fused_mlp_bf16", case, b, h, f"H={h}", profile=h > 1024)
        wide = cases(kp, kq_wide, b)
        for name in ("fused_mlp_q8", "fused_mlp_q8_preq"):
            run(name, wide[name], b, 1040, "H=1040", profile=False)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on the card",
              file=sys.stderr)
        return 1
    smoke = Smoke()
    for p in PHASES:
        t0 = time.perf_counter()
        getattr(smoke, p)()
        log(p, f"phase took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(smoke.reports.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
