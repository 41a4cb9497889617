#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's paths on the card (training and the checkpoint round
trip into serving, the REST scorer, the decision plane, the decision
pipeline of ``python -m ccfd_tpu_torch demo`` with and without its online
trainer, the service roles as separate processes, and the reference's
other Seldon models: logreg/modelfull, the tree family, the inference
graph and the ``score`` command, the seq family with its history store, the
user-task model and the investigator, the card as a fallible component:
the heal supervisor, the fault plans, the chaos monkey and the audit plane,
governed rollouts and replay (the seq family's too), the incident and
capacity planes, and the loadgen and doctor tools) and holds each CUDA kernel against
its plain PyTorch version. Each kernel's ``launches`` in the
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
           runs on the deadline's dispatcher thread and none times out;
           (e) `serve` on B1 with CCFD_NATIVE_FRONT=0,
           CCFD_OVERLOAD_SERVE_CODEL_TARGET_MS=2,
           CCFD_OVERLOAD_REST_QUEUE_ROWS=4096 and one batcher worker under
           1,920 16-row POSTs from 32 clients in turn bulk, normal and
           critical (x-ccfd-priority): every answer held against B1's plain
           version, launches = dispatches, the batcher shed bulk rows, and
           no inversion (a dropped request of one class while a request of
           a lower class that waited at least as long was kept, or an
           arrival refused while lower-class rows were queued); the
           per-class answers, 429s and p50/p99, and the sheds by stage
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
  seq      the seq family (models/seq.py, ops/seq_quant.py,
           serving/history.py), torch code on the card (the reference leaves
           it to XLA; no hand kernel):
           (a) apply_serving of assets/seq_init.npz (the reference operator's
               params) for seq in f32 (TF32 off) and bf16 and seq_q8, B in
               {1,16,128,1024,4096} at L=64 and L in {1,8} at B=1,024
               (pos_length 64), against the port's CPU path on the same
               rows within SEQ_TOL, and on the reference's golden rows
               (assets/seq_golden.npz) within the same bars; seq_q8's int32
               accumulators for every dense layer bit-equal to the CPU's;
           (b) for seq (bf16) and seq_q8 at each shape of (a) and B=16,384:
               ms a call (CUDA events around 100 calls), the bound (dense
               operations over the bf16 or int8 peak and the attention's
               over the bf16 peak, against bytes over the memory rate) and
               its share, and the card's busy share from a device-only trace;
           (c) the operator (the port's CR: scorer.model seq, then seq_q8,
               history_length 64; retrain, producer and investigator off;
               engine crash recovery on a durable bus): 20,000 records of
               1,000 seeded customers keyed by customer, an engine failure
               after 10,000: every transaction started once, no hand-kernel
               launch, /debug/device's seq grid, the store after the restore
               equal to one pass of the records without the failure, the
               served p of 64 sampled customers against the CPU on the
               histories the store holds; tx/s, decision p50/p99 against 10
               ms, history assembly against dispatch, the card's busy share;
           (d) the seq family's governed rollout: the port's CR with
               scorer.model seq, history_length 64 and the lifecycle on
               (retrain, producer and investigator off), live records of
               seeded customers at SEQ_LC_RATE/s and labels on the labels
               topic: quantize_seq(champion) submitted passes shadow,
               serves a canary with rows on both arms and is promoted; the
               served tree's params_fingerprint is the candidate's and its
               p on 512 fixed histories is the port's CPU seq_q8 within
               SEQ_TOL["q8"]; a broken quantization (head scale zeroed,
               bias 4) is REJECTED with the champion's fingerprint
               unchanged; no hand-kernel launch; every transaction started
               once; then the same CR with the lifecycle off: decision
               p50/p99 and tx/s on against off, the challenger forward's
               device ms a tapped batch (CUDA events), the shadow worker's
               and the controller's CPU share
  tasks    (a) the user-task model on the card and on the CPU from one
               init over 200 seeded human completions: after every fit the
               params and the confidence within 1e-5 (TF32 off); predict
               p50/p99 and fit ms by bucket;
           (b) the operator (the port's CR) with the investigator,
               engine.usertask_model and usertask_state_file, 20,000
               producer transactions and then 5,000 more once the model
               trained, under TASK_ENV (FRAUD_THRESHOLD=0.0 and more, named
               there): investigations opened, the investigator's completions
               by outcome, the model trained on the human decisions only
               (no auto-closed task observed), tasks of the second wave
               auto-closed and pre-filled, B1's launches = the router's
               dispatches (the prediction service is the model, not B1),
               and down() then up() on the state file restoring trained and
               the params bit for bit;
           (c) while (b)'s first queue is open: `python -m ccfd_tpu_torch
               tasks` lists the open tasks, `tasks --complete ID --outcome
               rejected` completes one, `investigate` works the queue for 5
               s over the engine REST and completes tasks
  heal     the card as a fallible component (runtime/heal.py, runtime/faults.py,
           runtime/chaos.py, observability/audit.py), each part with every
           launch count set to 0 just before it and read just after:
           (a) the drill on B1 in process: bus -> router (ladder on, the
               dispatch watchdog, the profiler, an AuditLog with a
               directory, the gate: the storage pin composed with a
               DeviceSupervisor ticking every 0.2 s, canary deadline 250
               ms) -> a Scorer on the card (the committed checkpoint) ->
               engine; 2,000 transactions on the device tier; device_hang
               :ms=400 on with no traffic: healthy -> suspect ->
               quarantined; 2,000 transactions all on the host tier
               (cause quarantine; no router dispatch, B1 launched only for
               the canaries); the fault off: the ladder, the warm step
               (every bucket, under heal.warm) and the probation canaries
               with host parity, healthy; 2,000 transactions on the device
               tier with no build billed to a serving label and the host
               counter still; ccfd_device_health, and `audit <tx_id>`
               offline on the directory equal to /decisions/<tx_id>; B1
               launches = dispatches + a bucket a warm step; the canary's
               wall and B1's device time in it, the audit plane's cost
               (4,000-row bursts with it on and off, the stamping a row, a
               flush and its bytes a record);
           (b) at the tick() surface on the card: put_fail through
               h2d_failures() (no H2D bytes), device_oom:ratio=0.99 and
               compile_stall (a build storm on a serving label) each
               quarantine and heal once the fault is off; one
               hang-and-heal cycle on mlp_q8 on each wire (B3, then B2),
               launches = dispatches + warmups;
           (c) the port's CR in process with chaos on: the monkey kills the
               router every 2 s and runs device_hang storms (2 s every 2
               s) under 10,000 producer transactions at 1,000/s: every one
               started once, at least one quarantine and one re-promotion,
               one audit record a routed transaction, B1 launches =
               dispatches + warmups, tx/s; and the engine's state file
               under CCFD_STORAGE_FAULTS=bitrot: a platform saves cleanly,
               a second saves under the plan and stops without its
               shutdown save, a third quarantines the file to *.corrupt
               and loads the last good generation
  observatory the evidence planes on the card (observability/incident.py,
           observability/capacity.py, observability/dashboards.py) and the
           tools: the port's CR in process with incident and capacity on
           (store, producer and retrain off; heal off, so the SLO's bundle
           is the only one: the heal supervisor's own bundles are held on
           the CPU) and its SLO block judged on OBS_SLO's short windows,
           OBS_RATE transactions a second:
           (a) after OBS_WINDOW_S: /capacity validates, names its bottleneck
               stage with the headroom, /capacity/whatif?workers=2 answers
               and validates, ccfd_capacity_model_error_ratio;
           (b) device_hang:ms=400 on B1 until the e2e SLO breaches: exactly
               one bundle, valid at /incidents/<id>, embedding the decisions
               in flight and the capacity snapshot, ccfd_build_events_total
               among its watched counters; the decisions routed while the
               SLO breaches carry its id and `audit <tx_id>` joins it; the
               fault off, the SLO recovers; every transaction started once,
               B1 launches = dispatches + a bucket's warmup;
           (c) the same platform with both planes off over the same
               window: tx/s and decision p50/p99 on against off; the
               recorder's and the model's thread CPU; the breach-to-bundle
               time and the bundle's bytes;
           (d) every family the written dashboards read (Fleet is not
               written) is in the scrape or on OBS_ABSENT with its reason;
           the tools: `loadgen --clients 4 --rows 16 --seconds 5` against
           `serve` on the card (B1): no error, p50/p99 beside the serve
           phase's own 16-row POSTs, launches = dispatches + warmup; and
           `doctor` exits 0 naming the card with every kernel built
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
          "platform", "seq", "tasks", "heal", "rollout", "observatory", "models", "timing")
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
# serve (e): the batcher's CoDel target and bounded queue on the Python
# transport, one batcher worker, under a burst of OVERLOAD_CLIENTS clients
OVERLOAD_ENV = {"CCFD_NATIVE_FRONT": "0", "CCFD_OVERLOAD_SERVE_CODEL_TARGET_MS": "2",
                "CCFD_OVERLOAD_REST_QUEUE_ROWS": "4096", "CCFD_BATCH_WORKERS": "1"}
OVERLOAD_CLIENTS = 32
OVERLOAD_POSTS = 60  # 16-row POSTs a client
PRIORITIES = ("bulk", "normal", "critical")
# seq: (a) and (b)'s shapes, the operator's stream
SEQ_L = 64  # the operator's history_length and every forward's pos_length
SEQ_B = (1, 16, 128, 1024, 4096)
SEQ_SHORT_L = (1, 8)  # short windows of a 64-long history
SEQ_SHORT_B = 1024
SEQ_CPU_ROWS = 256  # of each (a) batch, scored on the CPU too
# card vs the port's CPU path (and vs the reference's golden p), max |dp|:
# f32 with TF32 off, summation order only; bf16, a bf16 rounding of a sum
# near its boundary flips between the two orders; seq_q8, an ulp apart
# before a token's rint(h / s) moves it to the next integer
SEQ_TOL = {"f32": 1e-4, "bf16": 2e-2, "q8": 3e-2}
SEQ_CALLS = 100
SEQ_OP_ROWS = 20_000
SEQ_CUSTOMERS = 1_000
SEQ_SAMPLED = 64
SEQ_LC_RATE = 1_000  # live records a second while the seq lifecycle judges
SEQ_LC_LABELS = 100  # labelled transactions a second on the labels topic
SEQ_LC_FRAUD = 0.2  # the share of fraud rows among them
SEQ_LC_GUARDRAILS = {"min_labels": 64, "min_shadow_rows": 2048, "auc_margin": 0.2,
                     "max_alert_rate_delta": 0.5, "max_score_psi": 0.5,
                     "canary_min_labels": 32, "min_submit_interval_s": 0.0}
SEQ_LC_VERDICT_S = 120  # each candidate's verdict deadline
SEQ_LC_OFF_S = 8  # the lifecycle-off run
SEQ_LC_CHECK = 512  # fixed histories the promoted graph scores
# tasks: the user-task model and the investigator
TASK_COMPLETIONS = 200
TASK_PREDICTS = 500
TASK_ROWS = 20_000
TASK_SECOND_ROWS = 5_000  # after the model's first fit
TASK_SETTLE_S = 2.0
TASK_MIN_TASKS = 200
TASK_RATE = 400.0  # the investigator's completions a second
TASK_INVESTIGATE_S = 5
# FRAUD_THRESHOLD=0.0 routes every transaction to the fraud process; a
# customer who does not reply within 1 s goes to the DMN, which opens an
# investigation unless the amount is under CCFD_LOW_AMOUNT=75 and p under
# CCFD_LOW_PROBA=1.01 (so the amount alone decides: ~380 of the first
# 20,000 surrogate rows; the reference's 200 would open ~46); the model
# auto-closes a task at CONFIDENCE_THRESHOLD=0.6 (its weighted loss keeps
# its confidence near the class balance)
TASK_ENV = {"FRAUD_THRESHOLD": "0.0", "CCFD_LOW_AMOUNT": "75", "CCFD_LOW_PROBA": "1.01",
            "CONFIDENCE_THRESHOLD": "0.6", "CCFD_REPLY_TIMEOUT_S": "1.0"}
# the heal phase (runtime/heal.py, runtime/chaos.py, observability/audit.py)
HEAL_ROWS = 2_000  # transactions before, during and after the quarantine
HEAL_BURST = 4_000  # each of the audit-on and audit-off bursts
HEAL_INTERVAL_S = 0.2  # the supervisor's tick, and its backoff base
HEAL_CANARY_MS = 250.0  # the canary's deadline (the reference's default)
HEAL_HANG = "device_hang:ms=400"
HEAL_CANARIES = 50  # canaries timed for the wall and device time
AUDIT_ROWS = 4_096  # rows a record_batch when the stamping is timed
AUDIT_ROUNDS = 2  # bursts with the audit plane on, and as many off, in turns
CHAOS_ROWS = 10_000
CHAOS_RATE = 1_000  # producer rows/s
CHAOS_KILL_S = 2.0  # the monkey kills the router this often
CHAOS_STORM_EVERY_S = 2.0
CHAOS_STORM_S = 2.0
BITROT_ROWS = 1_000
# the rollout phase (lifecycle/, replay/, analytics/): the producer's rate
# (live rows: the platform's own dataset, load_dataset(), as its producer
# sends); FRAUD_THRESHOLD 0.1 routes ~1% of them to the fraud process, whose
# simulated customers' replies are the labels the trainer and the evaluator
# read (the notify service answers at random, approve 0.7, so a
# label AUC sits at 0.5 +- noise for any model: the smoke widens auc_margin,
# and the distribution gates decide); the trainer's bar lowered to match
ROLLOUT_RATE = 1_000
ROLLOUT_ENV = {"FRAUD_THRESHOLD": "0.1", "CCFD_RETRAIN_MIN_LABELS": "32"}
ROLLOUT_GUARDRAILS = {"min_labels": 64, "min_shadow_rows": 1024, "canary_min_labels": 32,
                      "min_submit_interval_s": 20.0, "auc_margin": 0.25}
ROLLOUT_PROMOTE_S = 150  # the first promotion's deadline after ready
ROLLOUT_OFF_S = 20  # the lifecycle-off run
ROLLOUT_BUCKET_ROWS = 4_096
ROLLOUT_BUCKETS = (16, 1024, 16384)
REPLAY_ROWS = 20_000
REPLAY_BATCH = 256
REPLAY_KILL_BATCH = 40
REPLAY_BEFORE_S = 3.0  # live traffic alone before the replay
# (b)'s promotion needs only a champion with other params: lenient gates
REPLAY_GUARDRAILS = {"min_labels": 16, "min_shadow_rows": 256, "canary_min_labels": 8,
                     "min_submit_interval_s": 0.0, "auc_margin": 1.0,
                     "max_alert_rate_delta": 1.0, "max_score_psi": 100.0}
ANALYTICS_ROWS = 284_807  # the Kaggle table's rows
ANALYTICS_TOL = 1e-5  # of the magnitudes summed (float32 sums in two orders)
ANALYTICS_TIMED = 10
OBS_RATE = 2_000  # producer rows/s for the evidence planes' platform
OBS_WINDOW_S = 10  # the fault-free window each arm is timed over
# the SLO block's overlay: the CR's objectives judged on short windows and
# ticks, so a hang of seconds breaches within the phase, with e2e-p99's
# target at 200 ms (the CR's is 50 ms): far above the healthy card's p99
# and below a decision that waits out one 400 ms hung dispatch
OBS_SLO = {"interval_s": 0.25, "windows": "2,4,30", "specs": [
    {"name": "e2e-p99", "kind": "latency", "metric": "router_decision_seconds",
     "target_ms": 200.0, "objective": 0.99},
    {"name": "rest-p99", "kind": "latency",
     "metric": "seldon_api_executor_client_requests_seconds", "target_ms": 25.0,
     "objective": 0.99},
    {"name": "error-rate", "kind": "error_rate", "metric": "transaction_incoming_total",
     "error_metric": "router_process_start_errors_total", "max_error_rate": 0.01}]}
OBS_BREACH_S = 60  # the breach bundle's deadline after the fault
OBS_STAMPED = 200  # decisions carrying the bundle id before the fault goes
OBS_RECOVER_S = 60
LOADGEN_ARGS = ("--clients", "4", "--rows", "16", "--seconds", "5")
# families the written dashboards read that this phase's scrape may lack
OBS_ABSENT = {
    **{f: "the sharded serving mesh (ROADMAP A15b)"
       for f in ("ccfd_mesh_devices", "ccfd_mesh_axis_size", "ccfd_mesh_publishes_total",
                 "ccfd_mesh_publish_pause_timeouts_total")},
    **{f: "a real Kafka cluster's exporter (the KafkaCluster board), no module of the port"
       for f in ("kafka_consumergroup_lag",
                 "kafka_controller_kafkacontroller_offlinepartitionscount",
                 "kafka_server_brokertopicmetrics_bytesin_total",
                 "kafka_server_brokertopicmetrics_bytesout_total",
                 "kafka_server_brokertopicmetrics_messagesin_total",
                 "kafka_server_replicamanager_leadercount",
                 "kafka_server_replicamanager_partitioncount",
                 "kafka_server_replicamanager_underreplicatedpartitions")},
    "ccfd_host_fallback_scores_total": "the Scorer's host latency tier (refused, A5)",
    **{f: "the networked bus role's server (bus/server.py); the operator's bus is in process"
       for f in ("bus_consumers", "bus_records_delivered_total", "bus_records_produced_total",
                 "bus_records_trimmed_total", "bus_topic_backlog", "bus_topic_end_offset",
                 "bus_topic_log_start_offset", "bus_topic_records_in_total",
                 "bus_topic_retained_records")},
    **{f: "the heal supervisor, off in this phase (the heal phase runs it)"
       for f in ("ccfd_device_health", "ccfd_heal_attempts_total", "ccfd_heal_canary_total",
                 "ccfd_heal_transitions_total")},
    **{f: "the replay plane, opt-in (off in the CR)"
       for f in ("ccfd_replay_cursor_seq", "ccfd_replay_divergence_total",
                 "ccfd_replay_rows_per_s", "ccfd_replay_rows_total", "ccfd_replay_verdicts_total",
                 "ccfd_replay_windows_total")},
    **{f: "the chaos monkey, opt-in (off in the CR)"
       for f in ("chaos_fault_windows_total", "chaos_injections_total")},
    "faults_injected_total": "the edge fault plan, armed only by CCFD_FAULTS or chaos.faults",
    "kafka_adapter_send_errors_total": "the Kafka adapter, built only for a kafka:// bus",
    "producer_rows_total": "the producer component, off here (the phase paces its own rows)",
    **{f: "the online trainer, off in this phase (the rollout phase runs it)"
       for f in ("retrain_labels_total", "retrain_last_loss", "retrain_param_swaps_total",
                 "retrain_steps_total")},
    **{f: "a ParallelRouter's coalescing batcher (router.workers > 1; the CR runs one)"
       for f in ("router_coalesced_dispatches_total", "router_coalesced_rows_total")},
    **{f: "the SeqScorer's (scorer.model seq; the seq phase runs it)"
       for f in ("seq_anonymous_rows_total", "seq_assembly_seconds", "seq_bucket_dispatch_total",
                 "seq_bucket_rows_total", "seq_dispatch_seconds", "seq_history_customers",
                 "seq_inflight_dispatches", "seq_stale_commits_total")},
}
PROMQL_WORDS = {"rate", "sum", "by", "min", "max", "histogram_quantile", "increase", "avg",
                "irate", "without", "group_left", "group_right", "on", "ignoring", "bool",
                "and", "or", "unless", "offset", "count", "topk", "clamp_min", "abs"}
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


def settled_launches(dispatches, counter, extra: int, timeout_s: float = 2.0) -> tuple:
    """(dispatches, launches) of a platform read after its ``down()``, once
    every counted dispatch has launched. The heal supervisor's canary
    counts its dispatch just before it launches, at any tick while the
    platform is up, and a canary abandoned past its deadline launches when
    its hang ends; ``down()`` stops new ticks. ``extra`` is the launches
    that no dispatch counts (the warm steps)."""
    deadline = time.monotonic() + timeout_s
    while True:
        d, n = dispatches(), counter.value
        if n == d + extra or time.monotonic() > deadline:
            return d, n
        time.sleep(0.01)


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
        self.serve16: dict = {}  # kernel -> the serve phase's 16-row POST latencies (ms)
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
        self.serve_overload()

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
            self.serve16[kernel] = lat_native
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
        # the lifecycle's lineage and the drift baseline persist across
        # restarts: each platform gets its own, or a later one would
        # restore an earlier one's champion into its scorer
        s["lifecycle"]["state_dir"] = os.path.join(tmp, "lifecycle")
        s["analytics"]["reference_file"] = os.path.join(tmp, "drift_reference.npz")
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
        finally:
            p2.down()
        warm = 2 * len(cfg.batch_sizes)
        dispatched, launched = settled_launches(
            lambda: p.scorer.dispatch_total() + p2.scorer.dispatch_total(),
            counters["fused_mlp_bf16"], warm)
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
                        warm = len(p.scorer.batch_sizes)
                    finally:
                        p.down()
                dispatched, b1 = settled_launches(p.scorer.dispatch_total,
                                                  counters["fused_mlp_bf16"], warm)
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

    # -- heal: the card as a fallible component -----------------------------
    def heal(self) -> None:
        """(a) The heal drill on B1 in process, (b) the other signals at the
        supervisor's tick() surface and a hang-and-heal cycle on B3 and B2,
        (c) the operator with chaos on: the monkey's router kills and a
        device-hang storm, and the engine's state file under bitrot."""
        self.heal_drill()
        self.heal_signals()
        self.heal_operator()
        self.heal_bitrot()

    def heal_pipeline(self, tmp: str) -> dict:
        """The drill's pieces: bus -> router (ladder on, the watchdog, the
        profiler, the audit log with a directory, the gate: the storage pin
        composed with the supervisor) -> a Scorer on the card (B1, the
        committed checkpoint) -> engine, and the exporter."""
        from ccfd_tpu_torch.bus.broker import Broker
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.metrics.exporter import MetricsExporter
        from ccfd_tpu_torch.metrics.prom import Registry
        from ccfd_tpu_torch.observability.audit import AuditLog
        from ccfd_tpu_torch.observability.device import DeviceTelemetry
        from ccfd_tpu_torch.observability.profile import StageProfiler
        from ccfd_tpu_torch.process.fraud import build_engine
        from ccfd_tpu_torch.router.router import Router
        from ccfd_tpu_torch.runtime.durability import ComposedHealGate, StoragePinGate
        from ccfd_tpu_torch.runtime.heal import DeviceSupervisor
        from ccfd_tpu_torch.runtime.overload import OverloadControl
        from ccfd_tpu_torch.serving.scorer import Scorer

        cfg = Config.from_env()
        regs = {n: Registry() for n in ("router", "heal", "device", "slo", "audit", "kie")}
        tele = DeviceTelemetry(registry=regs["device"])
        prof = StageProfiler(registry=regs["slo"])
        prof.arm_compile_listener()
        scorer = Scorer(model_name="mlp", params=self.params("checkpoint"),
                        batch_sizes=cfg.batch_sizes, device=self.dev, telemetry=tele)
        scorer.warmup()
        router_calls = [0]

        def router_score(x):
            router_calls[0] += 1
            return scorer.score(x)

        broker = Broker(default_partitions=2)
        ov = OverloadControl.from_config(cfg, regs["router"], max_batch=4096, on_card=True)
        audit = AuditLog(dir=os.path.join(tmp, "audit"), registry=regs["audit"])
        engine = build_engine(cfg, broker, regs["kie"], None)
        router = Router(cfg, broker, router_score, engine, regs["router"],
                        host_score_fn=scorer.host_score, degrade=True, overload=ov,
                        profiler=prof, audit=audit)
        # as the operator wires it: the supervisor watches the router's
        # scorer-edge breaker, and the router's gate is the storage pin
        # composed with the supervisor
        sup = DeviceSupervisor(scorer, registry=regs["heal"], breaker=router._breaker,
                               telemetry=tele, profiler=prof, overload=ov,
                               canary_deadline_ms=HEAL_CANARY_MS,
                               backoff_base_s=HEAL_INTERVAL_S, backoff_cap_s=1.0)
        router.set_heal_gate(ComposedHealGate(StoragePinGate(), sup))
        exporter = MetricsExporter(regs, profiler=prof, telemetry=tele, audit=audit).start()
        return {"cfg": cfg, "regs": regs, "tele": tele, "prof": prof, "scorer": scorer,
                "router_calls": router_calls, "broker": broker, "audit": audit, "sup": sup,
                "engine": engine, "router": router, "exporter": exporter}

    def heal_drill(self) -> None:
        """(a) Baseline traffic on the device tier; ``device_hang`` on with
        no traffic flowing until the supervisor quarantines; traffic on the
        host tier (cause quarantine) while B1 launches only for the
        canaries; the fault off, the warm probation and the flip; traffic on
        the device tier again with no build on a serving label; the health
        gauge, ``/decisions/<tx_id>`` against ``audit <tx_id>`` offline; then
        the canary's wall and device time, the audit plane's cost."""
        import contextlib
        import gc
        import io

        from ccfd_tpu_torch import cli
        from ccfd_tpu_torch.data.ccfd import Dataset, iter_transactions
        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
        from ccfd_tpu_torch.observability.profile import builds_total
        from ccfd_tpu_torch.runtime import faults
        from ccfd_tpu_torch.runtime.heal import NON_SERVING_COMPILE_STAGES
        from ccfd_tpu_torch.utils.gctune import tune_for_service

        tag = "heal (a)"
        tmp = tempfile.mkdtemp(prefix="ccfd_heal_")
        n = HEAL_ROWS
        ds = kaggle_surrogate(n=3 * n + 4 * AUDIT_ROUNDS * HEAL_BURST, seed=SEED)
        rows = list(iter_transactions(Dataset(X=ds.X, y=ds.y)))
        pl = self.heal_pipeline(tmp)
        cfg, regs, scorer, sup, audit, router = (pl[k] for k in (
            "cfg", "regs", "scorer", "sup", "audit", "router"))
        rr = regs["router"]
        out_c = rr.counter("transaction_outgoing_total")
        degraded = rr.counter("router_degraded_total")
        warm_ms = []
        warmup = scorer.warmup

        def timed_warmup():
            t = time.perf_counter()
            warmup()
            warm_ms.append((time.perf_counter() - t) * 1e3)

        scorer.warmup = timed_warmup
        counters = self.counters()
        for c in counters.values():
            c.reset()
        builds0 = builds_total()
        threads = [threading.Thread(target=sup.run, args=(HEAL_INTERVAL_S,), daemon=True),
                   threading.Thread(target=audit.run, args=(0.25,), daemon=True)]
        for t in threads:
            t.start()
        rt = router.start(poll_timeout_s=0.02)
        done = [0, 0]  # routed, stamped

        def burst(part: list) -> float:
            """Produce ``part`` and wait until it is routed and (the audit
            plane armed) stamped: the route seam stamps a batch after its
            starts are counted."""
            t = time.perf_counter()
            pl["broker"].produce_batch(cfg.kafka_topic, part, [r["id"] for r in part])
            done[0] += len(part)
            done[1] += len(part) if router._audit is not None else 0
            self.heal_wait(lambda: out_c.total() >= done[0]
                           and audit.counts()["recorded"] >= done[1],
                           f"{tag}: {done[0]} routed")
            return time.perf_counter() - t

        def tiers(part: list) -> dict:
            got: dict = {}
            for r in part:
                rec = audit.get(r["id"])
                key = (rec["tier"], rec.get("cause")) if rec else None
                got[key] = got.get(key, 0) + 1
            return got

        def serving_builds() -> int:
            return sum(v for s, v in pl["prof"].compile_counts().items()
                       if s not in NON_SERVING_COMPILE_STAGES)

        b1 = counters["fused_mlp_bf16"]
        offset = b1.value - scorer.dispatch_total()

        def quiet() -> tuple:
            """(dispatches, B1 launches) at a moment when every counted
            dispatch has launched: a canary counts its dispatch just before
            its launch, and a hung one wakes when it will."""
            for _ in range(400):
                d, launches = scorer.dispatch_total(), b1.value
                if launches - d == offset:
                    return d, launches
                time.sleep(0.005)
            raise AssertionError(f"{tag}: B1 launches {b1.value} never matched the "
                                 f"dispatches {scorer.dispatch_total()}")

        try:
            burst(rows[:n])
            base = tiers(rows[:n])
            if base != {("device", None): n} or sup.state != "healthy":
                raise AssertionError(f"{tag}: baseline {base}, state {sup.state}")
            # the fault on with no traffic: a hung dispatch of live traffic
            # would trip the breaker first
            plan = faults.DeviceFaultPlan.from_string(HEAL_HANG)
            t0 = time.perf_counter()
            faults.install_device_faults(plan)
            states = [sup.state]
            self.heal_wait(lambda: states.append(sup.state) or sup.state == "quarantined",
                           f"{tag}: the quarantine", 30)
            to_quarantine = time.perf_counter() - t0
            seen = [s for i, s in enumerate(states) if i == 0 or s != states[i - 1]]
            calls0, (disp0, l0) = pl["router_calls"][0], quiet()
            host0 = degraded.value({"tier": "host"})
            burst(rows[n:2 * n])
            calls1, (disp1, l1) = pl["router_calls"][0], quiet()
            held = sup.state
            host_rows = degraded.value({"tier": "host"}) - host0
            during = tiers(rows[n:2 * n])
            # the fault off: the ladder, the warm probation and the flip
            t1 = time.perf_counter()
            faults.install_device_faults(None)
            self.heal_wait(lambda: sup.state == "healthy", f"{tag}: the re-promotion", 60)
            to_healthy = time.perf_counter() - t1
            time.sleep(2 * HEAL_INTERVAL_S)
            serving0, host1 = serving_builds(), degraded.value({"tier": "host"})
            calls2 = pl["router_calls"][0]
            burst(rows[2 * n:3 * n])
            after = tiers(rows[2 * n:3 * n])
            serving1 = serving_builds()
            host2 = degraded.value({"tier": "host"})
            calls3 = pl["router_calls"][0]
            # the audit plane's cost on the same router: bursts with it on
            # and off in turns, under this process's collector and then
            # under the services' tuning (utils/gctune.py, as `up` runs),
            # with the collections each side paid
            cost = {}
            old_gc = gc.get_threshold()
            for tuned in (False, True):
                if tuned:
                    tune_for_service()
                t_on = t_off = 0.0
                coll = {True: [0, 0, 0], False: [0, 0, 0]}
                for k in range(2 * AUDIT_ROUNDS):
                    lo = 3 * n + (2 * AUDIT_ROUNDS * tuned + k) * HEAL_BURST
                    on = k % 2 == 0
                    router._audit = audit if on else None
                    g0 = [st["collections"] for st in gc.get_stats()]
                    dt = burst(rows[lo:lo + HEAL_BURST])
                    coll[on] = [c + st["collections"] - g for c, st, g in
                                zip(coll[on], gc.get_stats(), g0)]
                    t_on, t_off = (t_on + dt, t_off) if on else (t_on, t_off + dt)
                cost[tuned] = (AUDIT_ROUNDS * HEAL_BURST / t_on,
                               AUDIT_ROUNDS * HEAL_BURST / t_off, coll[True], coll[False])
            gc.unfreeze()
            gc.set_threshold(*old_gc)
            router._audit = audit
        finally:
            faults.install_device_faults(None)
            router.stop()
            rt.join(timeout=10)
            sup.stop()
            audit.stop()
            for t in threads:
                t.join(timeout=10)
        launched = b1.value
        dispatched = scorer.dispatch_total()
        hs = sup.status()
        probations = regs["heal"].counter("ccfd_heal_transitions_total").value(
            {"to": "probation"})
        warm = len(scorer.batch_sizes)
        health = scrape(f"{pl['exporter'].endpoint}/prometheus")
        gauge = health.get(f'ccfd_device_health{{device="{sup.device}",state="healthy"}}')
        tx = rows[n + 7]["id"]
        with urllib.request.urlopen(f"{pl['exporter'].endpoint}/decisions/{tx}",
                                    timeout=10) as r:
            live = json.loads(r.read())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["audit", str(tx), "--dir", os.path.join(tmp, "audit"), "--json"])
        offline = json.loads(buf.getvalue())
        fails = []
        if seen[-3:] != ["healthy", "suspect", "quarantined"]:
            fails.append(f"states on the way to quarantine {seen}")
        if held != "quarantined" or during != {("host", "quarantine"): n} or host_rows != n:
            fails.append(f"while quarantined: state {held}, records {during}, host tier "
                         f"{host_rows}")
        if calls1 != calls0 or l1 - l0 != disp1 - disp0:
            fails.append(f"while quarantined: router dispatches {calls1 - calls0}, B1 "
                         f"launches {l1 - l0} for {disp1 - disp0} canary dispatches")
        if after != {("device", None): n} or host2 != host1 or calls3 == calls2:
            fails.append(f"after the flip: records {after}, host tier {host1} -> {host2}")
        if serving1 != serving0 or serving0 != 0 or builds_total() != builds0:
            fails.append(f"builds on serving labels {serving0} -> {serving1}, compiler runs "
                         f"{builds_total() - builds0}")
        # the counts were set to 0 after the scorer's own warmup: B1
        # launches once a dispatch (router, canaries) and once a bucket a
        # warm step
        if launched != dispatched + warm * probations:
            fails.append(f"B1 launches {launched} != dispatches {dispatched} + {warm} x "
                         f"{probations} warm steps")
        if not launched or not hs["repromotions"] or not probations or len(warm_ms) != probations:
            fails.append(f"launches {launched}, status {hs}, warm steps {warm_ms}")
        if gauge != 1.0:
            fails.append(f"ccfd_device_health healthy = {gauge}")
        if rc != 0 or offline["record"] != live or live.get("cause") != "quarantine":
            fails.append(f"audit {tx}: rc {rc}, offline {offline.get('record')} != {live}")
        if audit.counts()["recorded"] != 3 * n + 2 * AUDIT_ROUNDS * HEAL_BURST:
            fails.append(f"audit recorded {audit.counts()} for the routed rows")
        pl["exporter"].stop()
        router.close()
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        self.reports["fused_mlp_bf16"]["launches"] += launched
        # the numbers: the canary's wall and B1's device time inside it,
        # the stamping a row, the flush
        import numpy as np

        from ccfd_tpu_torch.observability.audit import AuditLog

        walls = []
        for _ in range(HEAL_CANARIES):
            t = time.perf_counter()
            sup._device_dispatch()
            walls.append((time.perf_counter() - t) * 1e3)
        dev_ms = self.device_ms(lambda: scorer.score_pipelined(sup._probe_x, depth=1),
                                DEVICE_NAMES["fused_mlp_bf16"])
        stamp = AuditLog(clock=time.time)
        recs = [{"tx": i, "uid": f"0:{i}", "ts": 1.0, "proba": 0.5, "rule": "standard",
                 "branch": "standard", "pid": i, "priority": "normal"}
                for i in range(AUDIT_ROWS)]
        t = time.perf_counter()
        for k in range(5):
            stamp.record_batch([dict(r, uid=f"{k}:{r['pid']}") for r in recs],
                               threshold=0.5, worker=0)
        stamp_us = (time.perf_counter() - t) / (5 * AUDIT_ROWS) * 1e6
        flushed = AuditLog(dir=os.path.join(tmp, "flush"), clock=time.time)
        flushed.record_batch([dict(r) for r in recs], threshold=0.5, worker=0)
        t = time.perf_counter()
        landed = flushed.flush()
        flush_ms = (time.perf_counter() - t) * 1e3
        seg_bytes = sum(os.path.getsize(os.path.join(tmp, "flush", f))
                        for f in os.listdir(os.path.join(tmp, "flush")))
        walls_a = np.asarray(walls)
        log("heal", f"ok: {tag}: {n} baseline transactions on the device tier; "
            f"{HEAL_HANG} on with no traffic: {' -> '.join(seen[-3:])} in "
            f"{to_quarantine:.3f} s; {n} transactions while quarantined all on the host tier "
            f"(cause quarantine; router dispatches 0, B1 launches {l1 - l0} = the canaries' "
            f"{disp1 - disp0} dispatches); the fault off -> healthy in {to_healthy:.3f} s "
            f"({hs['quarantines']} quarantine(s), {probations:.0f} probation(s), warm step "
            f"{', '.join(f'{w:.3f}' for w in warm_ms)} ms at {warm} buckets); {n} "
            f"transactions after the flip on the device tier, builds on serving labels "
            f"{serving1}; ccfd_device_health healthy 1; audit {tx} offline equal to "
            f"/decisions; B1 launches {launched} = dispatches {dispatched} + {warm} x "
            f"{probations:.0f} warm steps on {self.card}")
        log("heal", f"{tag}: the canary ({len(sup._probe_x)} rows, bucket "
            f"{scorer.bucket(len(sup._probe_x))}) wall p50 {np.median(walls_a):.3f} ms p99 "
            f"{np.quantile(walls_a, 0.99):.3f} ms over {HEAL_CANARIES}; B1's device time "
            f"inside it {dev_ms if dev_ms is None else f'{dev_ms:.6f}'} ms; router bursts of "
            f"{HEAL_BURST}, the audit on and off in turns, {AUDIT_ROUNDS} each: "
            + "; ".join(f"{'services GC tuning' if tuned else 'default GC'}: on {on:.1f} "
                        f"tx/s, off {off:.1f} tx/s (collections by generation on {c_on}, "
                        f"off {c_off})" for tuned, (on, off, c_on, c_off) in cost.items())
            + f"; stamping {stamp_us:.3f} us a row "
            f"(record_batch of {AUDIT_ROWS}); a flush of {landed} records {flush_ms:.3f} ms, "
            f"{seg_bytes / max(1, landed):.1f} bytes a record on {self.card}")
        shutil.rmtree(tmp, ignore_errors=True)

    @staticmethod
    def heal_wait(pred, what: str, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                raise AssertionError(f"{what} not reached in {timeout} s")
            time.sleep(0.005)

    def heal_signals(self) -> None:
        """(b) Each of the other signals on the card at the tick() surface:
        ``put_fail`` through ``h2d_failures()``, ``device_oom:ratio=0.99``,
        ``compile_stall`` as a build storm; each quarantines and heals once
        the fault is off. Then one hang-and-heal cycle on an ``mlp_q8``
        scorer on each wire (B3, then B2)."""
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.metrics.prom import Registry
        from ccfd_tpu_torch.observability.device import DeviceTelemetry
        from ccfd_tpu_torch.observability.profile import StageProfiler, compile_stage
        from ccfd_tpu_torch.runtime import faults
        from ccfd_tpu_torch.runtime.heal import DeviceSupervisor
        from ccfd_tpu_torch.serving.scorer import Scorer

        tag = "heal (b)"
        cfg = Config.from_env()
        x = self.rows[:300]
        kw = dict(suspect_strikes=1, probation_canaries=2, canary_deadline_ms=HEAL_CANARY_MS,
                  backoff_base_s=0.05, backoff_cap_s=0.2)

        def heal_back(sup, what: str) -> float:
            t = time.perf_counter()
            for _ in range(400):
                if sup.tick() == "healthy":
                    return time.perf_counter() - t
                time.sleep(0.02)
            raise AssertionError(f"{tag}: {what}: not healthy again: {sup.status()}")

        counters = self.counters()
        for c in counters.values():
            c.reset()
        tele = DeviceTelemetry(registry=Registry())
        prof = StageProfiler(registry=Registry())
        prof.arm_compile_listener()
        sc = Scorer(model_name="mlp", params=self.params("checkpoint"),
                    batch_sizes=cfg.batch_sizes, device=self.dev, telemetry=tele)
        sc.warmup()
        results = []
        try:
            # put_fail: the failed staging copy counts, adds no bytes
            sup = DeviceSupervisor(sc, telemetry=tele, **kw)
            assert sup.tick() == "healthy"
            f0, b0 = tele.h2d_failures(), tele.h2d_bytes()
            faults.install_device_faults(faults.DeviceFaultPlan.from_string("put_fail"))
            try:
                sc.score_pipelined(x)
                raise AssertionError(f"{tag}: put_fail: the staging copy did not fail")
            except faults.InjectedFault:
                pass
            state = sup.tick()
            reasons = sup.status()["reasons"]
            fails_n, bytes_n = tele.h2d_failures() - f0, tele.h2d_bytes() - b0
            faults.install_device_faults(None)
            if state != "quarantined" or not any("put_fail" in r for r in reasons) \
                    or fails_n < 1 or bytes_n:
                raise AssertionError(f"{tag}: put_fail: {state}, {reasons}, failures "
                                     f"{fails_n}, bytes {bytes_n}")
            results.append(f"put_fail: {fails_n} failed copies (0 bytes) -> quarantined, "
                           f"healthy {heal_back(sup, 'put_fail'):.3f} s after")
            # device_oom: the overlay on cuda:0's real limit
            sup = DeviceSupervisor(sc, telemetry=tele, **kw)
            faults.install_device_faults(
                faults.DeviceFaultPlan.from_string("device_oom:ratio=0.99"))
            mem = tele.device_memory()
            state, reasons = sup.tick(), sup.status()["reasons"]
            faults.install_device_faults(None)
            if state != "quarantined" or not any("device_oom" in r for r in reasons):
                raise AssertionError(f"{tag}: device_oom: {state}, {reasons}")
            results.append(f"device_oom:ratio=0.99 ({reasons[0]}; the card's limit "
                           f"{max(e['bytes_limit'] for e in mem.values())} bytes) -> "
                           f"quarantined, healthy "
                           f"{heal_back(sup, 'device_oom'):.3f} s after")
            # compile_stall: synthetic builds billed to a serving label
            sup = DeviceSupervisor(sc, profiler=prof, compile_storm_per_s=2.0, **kw)
            assert sup.tick() == "healthy"
            faults.install_device_faults(
                faults.DeviceFaultPlan.from_string("compile_stall:ms=1"))
            with compile_stage("router.score"):
                for _ in range(10):
                    sc.score_pipelined(x[:16])
            state, reasons = sup.tick(), sup.status()["reasons"]
            faults.install_device_faults(None)
            if state != "quarantined" or not any("compile_storm" in r for r in reasons):
                raise AssertionError(f"{tag}: compile_stall: {state}, {reasons}")
            results.append(f"compile_stall ({[r for r in reasons if 'compile' in r][0]}) -> "
                           f"quarantined, healthy {heal_back(sup, 'compile_stall'):.3f} s after")
        finally:
            faults.install_device_faults(None)
        b1 = counters["fused_mlp_bf16"].value
        if b1 == 0:
            raise AssertionError(f"{tag}: B1 never launched")
        self.reports["fused_mlp_bf16"]["launches"] += b1
        log("heal", f"ok: {tag}: " + "; ".join(results) + f"; B1 launches {b1} on {self.card}")
        for wire, kernel in (("int8", "fused_mlp_q8_preq"), ("f32", "fused_mlp_q8")):
            for c in counters.values():
                c.reset()
            q8 = Scorer(model_name="mlp_q8", params=self.q8_params("checkpoint"),
                        batch_sizes=cfg.batch_sizes, device=self.dev, q8_wire=wire)
            q8.warmup()
            reg = Registry()
            sup = DeviceSupervisor(q8, registry=reg, **kw)
            faults.install_device_faults(faults.DeviceFaultPlan.from_string(HEAL_HANG))
            try:
                t = time.perf_counter()
                state = sup.tick()
            finally:
                faults.install_device_faults(None)
            quarantined_s = time.perf_counter() - t
            back = heal_back(sup, kernel)
            time.sleep(0.5)  # the abandoned hung canary launches once it wakes
            launched = counters[kernel].value
            probations = reg.counter("ccfd_heal_transitions_total").value({"to": "probation"})
            warm = len(q8.batch_sizes)
            others = sum(c.value for k, c in counters.items() if k != kernel)
            if state != "quarantined" or launched != q8.dispatch_total() + warm * (
                    1 + probations) or others:
                raise AssertionError(f"{tag} {kernel}: {state}; launches {launched}, "
                                     f"dispatches {q8.dispatch_total()}, {probations} "
                                     f"probations, other kernels {others}")
            self.reports[kernel]["launches"] += launched
            log("heal", f"ok: {tag}: mlp_q8 on the {wire} wire ({kernel}): {HEAL_HANG} -> "
                f"quarantined in {quarantined_s:.3f} s, healthy {back:.3f} s after the fault "
                f"off (parity within {sup.parity_tol} of the host forward); launches "
                f"{launched} = dispatches {q8.dispatch_total()} + {warm} x "
                f"{1 + probations:.0f} warmups on {self.card}")

    def heal_operator(self) -> None:
        """(c) ``up`` of the port's CR in process with chaos on: the monkey
        kills the router on a seeded schedule while ``device_hang`` storms
        run; every produced transaction started once, at least one
        quarantine and one re-promotion, one audit record a routed
        transaction; the chaos run's tx/s."""
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

        tag = "heal (c) chaos"
        tmp = tempfile.mkdtemp(prefix="ccfd_chaos_")
        n = CHAOS_ROWS
        cr = self.platform_cr(tmp, store={"enabled": False}, retrain={"enabled": False},
                              scorer={"model": "mlp", "train_steps": 0, "rest": False},
                              producer={"transactions": n, "rate": CHAOS_RATE},
                              heal={"interval_s": HEAL_INTERVAL_S,
                                    "backoff_base_s": HEAL_INTERVAL_S, "backoff_cap_s": 1.0},
                              chaos={"enabled": True, "interval_s": CHAOS_KILL_S,
                                     "seed": SEED, "targets": ["router"],
                                     "device_faults": HEAL_HANG,
                                     "fault_interval_s": CHAOS_STORM_EVERY_S,
                                     "fault_duration_s": CHAOS_STORM_S})
        cfg = Config.from_env()
        counters = self.counters()
        for c in counters.values():
            c.reset()
        p = Platform(PlatformSpec.from_cr(cr, cfg=cfg)).up(wait_ready_s=120)
        try:
            t0 = time.perf_counter()
            if not p.wait_producer(n / CHAOS_RATE * 3 + 60):
                raise AssertionError(f"{tag}: the producer did not finish")
            if not p.wait_routed(120):
                raise AssertionError(f"{tag}: the router did not drain")
            wall = time.perf_counter() - t0
            p.chaos.stop()  # closes a storm window in flight
            self.heal_wait(lambda: p.heal.state == "healthy", f"{tag}: healthy at the end", 60)
            # the route seam stamps a batch after its starts are counted
            self.heal_wait(lambda: p.audit.counts()["recorded"] >= n, f"{tag}: every record",
                           30)
            rr = p.registries["router"]
            incoming = rr.counter("transaction_incoming_total").value()
            routed = rr.counter("transaction_outgoing_total").total()
            deg = rr.counter("router_degraded_total")
            host, rules = deg.value({"tier": "host"}), deg.value({"tier": "rules"})
            started = p.engine.snapshot()["next_pid"] - 1
            hs = p.heal.status()
            kills = [v for _, v in p.chaos.history]
            windows = len(p.chaos.fault_windows)
            recorded, ring = p.audit.counts()["recorded"], p.audit.ring_size
            by_tier: dict = {}
            for rec in p.audit.list(limit=4096):
                by_tier[rec["tier"]] = by_tier.get(rec["tier"], 0) + 1
            probations = p.registries["heal"].counter("ccfd_heal_transitions_total").value(
                {"to": "probation"})
            warm = len(p.scorer.batch_sizes)
        finally:
            p.down()
        dispatched, launched = settled_launches(p.scorer.dispatch_total,
                                                counters["fused_mlp_bf16"],
                                                warm * (1 + probations))
        fails = []
        if not incoming == routed == started == n:
            fails.append(f"incoming {incoming}, routed {routed}, started {started} of {n}")
        if hs["quarantines"] < 1 or hs["repromotions"] < 1 or not kills or not windows:
            fails.append(f"heal {hs}, kills {kills}, storm windows {windows}")
        if recorded != routed or ring != routed:
            fails.append(f"audit recorded {recorded}, ring {ring}, routed {routed}")
        if launched != dispatched + warm * (1 + probations):
            fails.append(f"B1 launches {launched} != dispatches {dispatched} + {warm} x "
                         f"{1 + probations:.0f} warmups")
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        self.reports["fused_mlp_bf16"]["launches"] += launched
        log("heal", f"ok: {tag}: {n} transactions at {CHAOS_RATE}/s, all routed in "
            f"{wall:.3f} s ({n / wall:.1f} tx/s) while the monkey killed the router "
            f"{len(kills)} times and ran {windows} {HEAL_HANG} storms: incoming = routed = "
            f"started = {started}; {hs['quarantines']} quarantine(s), {hs['repromotions']} "
            f"re-promotion(s); host tier {host:.0f}, rules tier {rules:.0f} rows; audit "
            f"{recorded} records = routed, the newest 4,096 by tier {by_tier}; B1 launches "
            f"{launched} = dispatches {dispatched} + {warm} x {1 + probations:.0f} warmups "
            f"on {self.card}")
        shutil.rmtree(tmp, ignore_errors=True)

    def heal_bitrot(self) -> None:
        """(c) The engine's state file under CCFD_STORAGE_FAULTS=bitrot: a
        platform routes and saves cleanly at ``down()``; a second one under
        the bitrot plan routes more and saves (the periodic save's call)
        and stops without its shutdown save, as a killed process would; a
        third comes up on the file: the corrupt file is quarantined to
        ``*.corrupt`` and the last good generation loads."""
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import Dataset, iter_transactions
        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec
        from ccfd_tpu_torch.runtime import durability

        tag = "heal (c) bitrot"
        tmp = tempfile.mkdtemp(prefix="ccfd_bitrot_")
        state = os.path.join(tmp, "engine.state")
        cr = self.platform_cr(tmp, store={"enabled": False}, retrain={"enabled": False},
                              producer={"enabled": False}, bus={"log_dir": None},
                              scorer={"model": "mlp", "train_steps": 0, "rest": False},
                              engine={"crash_recovery": False, "state_file": state,
                                      "save_interval_s": 3600.0})
        ds = kaggle_surrogate(n=2 * BITROT_ROWS, seed=SEED + 1)
        rows = list(iter_transactions(Dataset(X=ds.X, y=ds.y)))
        pids = []
        before = {k: durability.counts().get(k, {}).get("engine_snapshot", 0)
                  for k in ("corrupt", "fallback")}
        for k, env in enumerate(({}, {"CCFD_STORAGE_FAULTS": "bitrot"}, {})):
            cfg = Config.from_env({**os.environ, **env})
            p = Platform(PlatformSpec.from_cr(cr, cfg=cfg)).up(wait_ready_s=120)
            try:
                loaded = p.engine.snapshot()["next_pid"]
                if k < 2:
                    part = rows[k * BITROT_ROWS:(k + 1) * BITROT_ROWS]
                    p.broker.produce_batch(cfg.kafka_topic, part, [r["id"] for r in part])
                    if not p.wait_routed(120):
                        raise AssertionError(f"{tag}: run {k} did not drain")
                if k == 1:
                    p._save_engine_state()  # under the bitrot plan
                    p._engine_state_file = None  # stopped without the shutdown save
                pids.append((loaded, p.engine.snapshot()["next_pid"]))
            finally:
                p.down()
        counts = {k: durability.counts().get(k, {}).get("engine_snapshot", 0) - v
                  for k, v in before.items()}
        fails = []
        if counts["corrupt"] < 1 or counts["fallback"] < 1:
            fails.append(f"engine_snapshot tallies {counts}")
        if not os.path.exists(state + ".corrupt"):
            fails.append(f"no {state}.corrupt: {sorted(os.listdir(tmp))}")
        if pids[2][0] != pids[0][1] or pids[1][1] != pids[0][1] + BITROT_ROWS:
            fails.append(f"next_pid by run (at load, at the end): {pids}")
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        log("heal", f"ok: {tag}: the engine's state file written under "
            f"CCFD_STORAGE_FAULTS=bitrot was quarantined to *.corrupt at the next bring-up "
            f"and the last good generation loaded (next_pid {pids[2][0]}, the first run's "
            f"end; the {BITROT_ROWS} starts saved only into bitrotted copies are the loss); "
            f"engine_snapshot tallies: {counts['corrupt']} corrupt, {counts['fallback']} "
            f"served from a retained generation")
        shutil.rmtree(tmp, ignore_errors=True)

    # -- rollout: the model lifecycle, replay, analytics (slice 13) -------
    def rollout(self) -> None:
        """The governed rollout and replay on the card: (a) the lifecycle
        over the port's CR with retrain on (a promotion served bit for bit
        through B1, a degraded candidate rejected in shadow, a breaker
        rollback mid-canary, every transaction started once, the counters
        against the audit trail, and the cost against a lifecycle-off run),
        (b) a recorded window replayed at bulk priority beside live traffic
        (parity, a kill and resume, a promotion's divergences classified)
        after B1's per-row bucket invariance, (c) ``analyze`` at the Kaggle
        table's size, card against CPU, and the drift monitor."""
        self.rollout_buckets()
        b1 = self.rollout_lifecycle()
        b1 += self.rollout_replay()
        self.reports["fused_mlp_bf16"]["launches"] += b1
        self.rollout_analytics()

    def rollout_paced(self, p, rows: list, rate: float, stop: threading.Event,
                      key: str = "id") -> threading.Thread:
        """A thread producing ``rows`` (cycled, fresh ids) onto ``p``'s
        transaction topic at ``rate`` rows/s in 100-row batches on an
        absolute schedule, until ``stop``, keyed by each row's ``key``;
        ``thread.sent`` counts them."""
        topic = p.cfg.kafka_topic
        batch = 100

        def run() -> None:
            t0 = time.perf_counter()
            i = 0
            while not stop.is_set():
                part = [dict(rows[(i + j) % len(rows)], id=f"live-{i + j}")
                        for j in range(batch)]
                p.broker.produce_batch(topic, part, [r[key] for r in part])
                i += batch
                th.sent = i
                ahead = i / rate - (time.perf_counter() - t0)
                if ahead > 0:
                    stop.wait(ahead)

        th = threading.Thread(target=run, daemon=True, name="smoke-live")
        th.sent = 0
        th.start()
        return th

    @staticmethod
    def rollout_records(p) -> list:
        """Every decision record in ``p``'s audit ring (the listing caps at
        4,096)."""
        with p.audit._mu:
            return list(p.audit._ring.values())

    @staticmethod
    def rollout_latency(records: list, t0: float = 0.0, t1: float = float("inf")) -> tuple:
        """Exact decision latency (ms, route-seam stamp minus produce
        stamp) p50/p99 of the live records decided in [t0, t1]."""
        import numpy as np

        lat = [(r["decided_ts"] - r["ts"]) * 1e3 for r in records
               if r.get("ts") and t0 <= r["decided_ts"] <= t1
               and str(r.get("tx", "")).startswith("live-")]
        if not lat:
            return float("nan"), float("nan"), 0
        a = np.asarray(lat)
        return float(np.percentile(a, 50)), float(np.percentile(a, 99)), len(lat)

    def rollout_buckets(self) -> None:
        """B1 gives a row the same p bit for bit in every bucket: 4,096 rows
        scored as 256 chunks at bucket 16, 4 at 1,024 and one padded to
        16,384, on the committed checkpoint and on seeded params. A
        replay's byte-stable parity rests on it (the live batch and its
        replay land in different buckets and row positions). These
        launches compare the kernel with itself: counted in no main path."""
        from ccfd_tpu_torch.ops.fused_mlp import fused_mlp_score

        torch = self.torch
        tag = "rollout (b) buckets"
        n = ROLLOUT_BUCKET_ROWS
        x = self.x_rows(n)
        for which in ("checkpoint", "seeded"):
            kp = self.kernel_params(which)
            got = {}
            for b in ROLLOUT_BUCKETS:
                out = []
                for s in range(0, n, min(b, n)):
                    chunk = x[s:s + min(b, n)]
                    pad = torch.zeros((b, x.shape[1]), dtype=x.dtype, device=self.dev)
                    pad[:chunk.shape[0]] = chunk
                    out.append(fused_mlp_score(kp, pad)[:chunk.shape[0]])
                got[b] = torch.cat(out).cpu()
            base = got[ROLLOUT_BUCKETS[0]]
            diff = {b: int((got[b] != base).sum()) for b in ROLLOUT_BUCKETS[1:]}
            if any(diff.values()):
                worst = max(float((got[b] - base).abs().max()) for b in ROLLOUT_BUCKETS)
                raise AssertionError(f"{tag}: {which} params: rows whose p differs from "
                                     f"bucket {ROLLOUT_BUCKETS[0]}'s: {diff} (max |dp| "
                                     f"{worst:.3e})")
            log("rollout", f"ok: {tag}: {which} params, {n} rows: p bit-equal at buckets "
                f"{', '.join(map(str, ROLLOUT_BUCKETS))} (p spans "
                f"{float(base.min()):.3e}..{float(base.max()):.6f}) on {self.card}")

    def rollout_lifecycle(self) -> int:
        """(a) The port's CR in process with retrain and the lifecycle on,
        the producer paced at ROLLOUT_RATE: the trainer's candidates walk
        shadow -> canary -> promote; after the first promotion the served
        params are the promoted checkpoint bit for bit and B1 on them holds
        its plain version; a degraded candidate (the trainer's params with
        w3 negated) submitted directly is rejected in shadow, the champion
        untouched; a candidate in canary rolls back when the scorer-edge
        breaker opens; every transaction started once; the lifecycle
        counters equal the audit trail's transitions. Then the same CR
        with the lifecycle off for ROLLOUT_OFF_S: decision p50/p99 and tx/s
        on against off, and the shadow worker's, controller's and drift
        monitor's CPU seconds. Returns B1's launches."""
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import iter_transactions, load_dataset
        from ccfd_tpu_torch.ops.fused_mlp import fused_mlp_reference, fused_mlp_score
        from ccfd_tpu_torch.params import params_fingerprint
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

        tag = "rollout (a) lifecycle"
        tmp = tempfile.mkdtemp(prefix="ccfd_rollout_")
        rows = list(iter_transactions(load_dataset()))
        cfg = Config.from_env({**os.environ, **ROLLOUT_ENV})
        wait = self.heal_wait
        launched = 0
        runs = {}
        for arm in ("on", "off"):
            cr = self.platform_cr(
                os.path.join(tmp, arm), store={"enabled": False}, producer={"enabled": False},
                scorer={"model": "mlp", "train_steps": PLATFORM_TRAIN_STEPS, "rest": False},
                retrain={"enabled": True, "interval_s": 0.5},
                lifecycle={"enabled": arm == "on", **ROLLOUT_GUARDRAILS})
            counters = self.counters()
            for c in counters.values():
                c.reset()
            p = Platform(PlatformSpec.from_cr(cr, cfg=cfg)).up(wait_ready_s=120)
            stop = threading.Event()
            cpu = {}
            try:
                lc = p.lifecycle
                if lc is not None:
                    for name, obj in (("shadow", lc.shadow), ("controller", lc),
                                      ("drift", p.analytics)):
                        cpu[name] = [0.0]
                        self.rollout_cpu_clock(obj, cpu[name])
                t0 = time.perf_counter()
                live = self.rollout_paced(p, rows, ROLLOUT_RATE, stop)
                if arm == "off":
                    time.sleep(ROLLOUT_OFF_S)
                else:
                    runs["checks"] = self.rollout_drive(p, lc, tag, wait)
                stop.set()
                live.join()
                sent = live.sent
                if not p.wait_routed(120):
                    raise AssertionError(f"{tag} ({arm}): the router did not drain")
                wall = time.perf_counter() - t0
                wait(lambda: p.audit.counts()["recorded"] >= sent, f"{tag}: every record", 30)
                rr = p.registries["router"]
                incoming = rr.counter("transaction_incoming_total").value()
                routed = rr.counter("transaction_outgoing_total").total()
                started = p.engine.snapshot()["next_pid"] - 1
                recs = self.rollout_records(p)
                probations = p.registries["heal"].counter(
                    "ccfd_heal_transitions_total").value({"to": "probation"})
                warm = len(p.scorer.batch_sizes)
                if lc is not None:
                    # under the controller's lock: a transition stamps the
                    # trail, then bumps its counter, and a promotion swaps
                    # the params before it stamps CHAMPION; read between
                    # two of those steps, counters, trail and served params
                    # would disagree although the controller is right
                    reg = p.registries["lifecycle"]
                    with lc._mu:
                        got = {n: reg.counter(f"ccfd_lifecycle_{n}_total").value()
                               for n in ("promotions", "rejections", "rollbacks", "candidates",
                                         "submissions_coalesced")}
                        trail = lc.store.audit_trail()
                        kp = p.scorer._live[1]
                        served_fp = params_fingerprint(p.scorer.params)
                        champ = lc.store.champion()
            finally:
                stop.set()
                p.down()
            dispatched, n_launch = settled_launches(p.scorer.dispatch_total,
                                                    counters["fused_mlp_bf16"],
                                                    warm * (1 + probations))
            fails = []
            if not sent == incoming == routed == started:
                fails.append(f"produced {sent}, incoming {incoming}, routed {routed}, "
                             f"started {started}")
            if n_launch != dispatched + warm * (1 + probations):
                fails.append(f"B1 launches {n_launch} != dispatches {dispatched} + {warm} x "
                             f"{1 + probations:.0f} warmups")
            p50, p99, n_lat = self.rollout_latency(recs)
            runs[arm] = {"sent": sent, "wall": wall, "tx_s": routed / wall, "p50": p50,
                         "p99": p99, "n_lat": n_lat, "cpu": {k: v[0] for k, v in cpu.items()}}
            if lc is not None:
                want = {
                    "promotions": sum(1 for e in trail if e["event"] == "stage"
                                      and e["detail"].get("to") == "CHAMPION"
                                      and e["detail"].get("reason") != "bootstrap"),
                    "rejections": sum(1 for e in trail if e["event"] == "stage"
                                      and e["detail"].get("to") == "REJECTED"),
                    "rollbacks": sum(1 for e in trail if e["event"] == "stage"
                                     and e["detail"].get("to") == "ROLLED_BACK"),
                    "candidates": sum(1 for e in trail if e["event"] == "created") - 1,
                }
                if any(got[k] != want[k] for k in want):
                    fails.append(f"counters {got} != audit trail {want}")
                if served_fp != champ.checkpoint_hash:
                    fails.append(f"served params {served_fp[:12]} are not champion "
                                 f"v{champ.version}'s checkpoint {champ.checkpoint_hash[:12]}")
                runs["counters"] = got
                runs["champion"] = champ.version
            if fails:
                raise AssertionError(f"{tag} ({arm}): " + "; ".join(fails))
            launched += n_launch
            if lc is not None:
                # B1 on the final champion's kernel params against its plain
                # version (compare launches, after the count was read)
                x = self.x_rows(16384)
                worst = self.compare("fused_mlp_bf16", f"{tag}: champion",
                                     *fused_mlp_score(kp, x, with_logits=True),
                                     *fused_mlp_reference(kp, x), tol_p=b1_tol_p(256))
                runs["b1_err"] = worst
        c, on, off = runs["checks"], runs["on"], runs["off"]
        log("rollout", f"ok: {tag}: first promotion (v{c['promoted']}) {c['promote_s']:.3f} s "
            f"after ready, served params = its checkpoint bit for bit (sha256 "
            f"{c['promoted_fp'][:16]}); degraded candidate v{c['bad']} REJECTED in "
            f"{c['reject_s']:.3f} s ({c['bad_reason']}), champion untouched; candidate "
            f"v{c['canary']} ROLLED_BACK {c['rollback_s']:.3f} s after the breaker opened "
            f"mid-canary, the champion's checkpoint restored; counters {runs['counters']} = "
            f"the audit trail; final champion v{runs['champion']}: B1 vs plain max |dp| "
            f"{runs['b1_err']:.3e}; {on['sent']} transactions each started once on {self.card}")
        log("rollout", f"{tag}: at {ROLLOUT_RATE}/s asked: lifecycle on {on['tx_s']:.1f} tx/s, "
            f"decision p50 {on['p50']:.3f} ms p99 {on['p99']:.3f} ms ({on['n_lat']} records, "
            f"{on['wall']:.3f} s); off {off['tx_s']:.1f} tx/s, p50 {off['p50']:.3f} ms p99 "
            f"{off['p99']:.3f} ms ({off['n_lat']} records, {off['wall']:.3f} s); thread CPU "
            f"seconds while on: " + ", ".join(f"{k} {v:.3f} s ({v / on['wall'] * 100:.2f}% of "
                                             f"a core)" for k, v in on["cpu"].items())
            + f" on {self.card}")
        shutil.rmtree(tmp, ignore_errors=True)
        return int(launched)

    @staticmethod
    def rollout_cpu_clock(obj, acc: list, attr: str = "step") -> None:
        """Accumulate the calling thread's CPU seconds spent in
        ``obj.<attr>`` (a supervised service's loop body) into ``acc[0]``."""
        fn = getattr(obj, attr)

        def step(*a, **kw):
            t0 = time.thread_time()
            try:
                return fn(*a, **kw)
            finally:
                acc[0] += time.thread_time() - t0

        setattr(obj, attr, step)

    def rollout_drive(self, p, lc, tag: str, wait) -> dict:
        """(a)'s checks on the live platform; returns what the log reports."""
        import dataclasses

        import numpy as np

        from ccfd_tpu_torch.lifecycle.controller import STAGE_CANARY
        from ccfd_tpu_torch.params import params_fingerprint, to_numpy

        out = {}
        reg = p.registries["lifecycle"]
        promotions = reg.counter("ccfd_lifecycle_promotions_total")
        t0 = time.perf_counter()
        wait(lambda: promotions.value() >= 1, f"{tag}: a promotion", ROLLOUT_PROMOTE_S)
        out["promote_s"] = time.perf_counter() - t0
        with lc._mu:  # the promotion's state, before the next candidate moves it
            champ = lc.store.champion()
            out["promoted"] = champ.version
            out["promoted_fp"] = params_fingerprint(p.scorer.params)
            restored = lc.checkpoints.restore(lc._host_copy(p.scorer.params),
                                              step=champ.checkpoint_step)[0]
        if not out["promoted_fp"] == champ.checkpoint_hash == params_fingerprint(restored):
            raise AssertionError(f"{tag}: served {out['promoted_fp'][:12]}, champion "
                                 f"v{champ.version} recorded {champ.checkpoint_hash[:12]}, "
                                 f"checkpoint {params_fingerprint(restored)[:12]}")
        trainer = lc.trainer_rebase.__self__
        g = lc.guardrails

        def submit(params) -> int:
            # accepted now (superseding a trainer candidate in flight); the
            # trainer's own submissions coalesce into it until its verdict
            with lc._mu:
                lc.guardrails = dataclasses.replace(g, min_submit_interval_s=0.0)
                v = lc.submit_candidate(params, label_watermark=trainer.labels_seen)
                lc.guardrails = dataclasses.replace(g, min_submit_interval_s=1e9)
            return v

        def settled(v: int, stages: tuple, what: str) -> float:
            t = time.perf_counter()
            wait(lambda: lc.store.get(v).stage in stages, f"{tag}: {what}", 120)
            return time.perf_counter() - t

        # a degraded candidate: rejected in shadow, the champion untouched
        bad = to_numpy(trainer.params)
        bad["layers"][-1]["w"] = -bad["layers"][-1]["w"]
        champ_v, champ_fp = lc.champion, params_fingerprint(p.scorer.params)
        out["bad"] = submit(bad)
        out["reject_s"] = settled(out["bad"], ("REJECTED", "CANARY", "CHAMPION"),
                                  "the degraded candidate's verdict")
        rec = lc.store.get(out["bad"])
        if rec.stage != "REJECTED" or lc.champion != champ_v or params_fingerprint(
                p.scorer.params) != champ_fp:
            raise AssertionError(f"{tag}: the degraded candidate ended {rec.stage}, champion "
                                 f"v{lc.champion} (was v{champ_v})")
        out["bad_reason"] = [e["detail"].get("reason") for e in lc.store.audit_trail(rec.version)
                             if e["detail"].get("to") == "REJECTED"][0]
        # a candidate in canary when the scorer-edge breaker opens: rollback
        good = to_numpy(p.scorer.params)
        good["layers"][-1]["b"] = good["layers"][-1]["b"] + np.float32(0.01)
        out["canary"] = submit(good)
        wait(lambda: lc.stage == STAGE_CANARY and lc.candidate == out["canary"],
             f"{tag}: candidate v{out['canary']} in canary", 120)
        champ = lc.store.champion()
        breaker = lc.breaker
        t = time.perf_counter()
        while breaker.state == "closed":
            breaker.record_failure()  # a sick edge's failures trip it
        wait(lambda: lc.store.get(out["canary"]).stage == "ROLLED_BACK",
             f"{tag}: the rollback", 60)
        out["rollback_s"] = time.perf_counter() - t
        breaker.force_close()
        if params_fingerprint(p.scorer.params) != champ.checkpoint_hash:
            raise AssertionError(f"{tag}: after the rollback the served params are not "
                                 f"champion v{champ.version}'s checkpoint")
        lc.guardrails = g
        return out

    def rollout_replay(self) -> int:
        """(b) A platform on the port's CR with the replay plane armed (row
        capture on the audit seam, the verdict tap, the service) and the
        lifecycle on: REPLAY_ROWS transactions recorded, then replayed at
        bulk priority while live traffic runs at ROLLOUT_RATE: every row
        holds parity (no divergence, drop or ghost); a second replay killed
        at a batch's production and resumed joins exactly once; after a
        promotion a third replay's divergences are all ``champion_hash``.
        Rows/s, and live decision p50/p99 before and during the replay.
        Returns B1's launches."""
        import numpy as np

        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import Dataset, iter_transactions, load_dataset
        from ccfd_tpu_torch.data.surrogate import kaggle_surrogate
        from ccfd_tpu_torch.params import to_numpy
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec
        from ccfd_tpu_torch.replay.service import CAUSE_CHAMPION_HASH, ReplayKilled

        tag = "rollout (b) replay"
        tmp = tempfile.mkdtemp(prefix="ccfd_replay_")
        n = REPLAY_ROWS
        ds = kaggle_surrogate(n=n, seed=SEED)
        window_rows = list(iter_transactions(Dataset(X=ds.X, y=ds.y)))
        live_rows = list(iter_transactions(load_dataset()))
        cr = self.platform_cr(
            tmp, store={"enabled": False}, producer={"enabled": False},
            retrain={"enabled": False},
            scorer={"model": "mlp", "train_steps": PLATFORM_TRAIN_STEPS, "rest": False},
            lifecycle={"enabled": True, **REPLAY_GUARDRAILS},
            audit={"dir": os.path.join(tmp, "audit"), "ring": 1 << 18},
            replay={"enabled": True, "dir": os.path.join(tmp, "cursor"),
                    "batch": REPLAY_BATCH, "timeout_s": 30.0})
        cfg = Config.from_env({**os.environ, **ROLLOUT_ENV})
        wait = self.heal_wait
        counters = self.counters()
        for c in counters.values():
            c.reset()
        p = Platform(PlatformSpec.from_cr(cr, cfg=cfg)).up(wait_ready_s=120)
        stop = threading.Event()
        live = None
        out = {}
        try:
            topic = cfg.kafka_topic
            t0 = time.perf_counter()
            for i in range(0, n, 500):
                p.broker.produce_batch(topic, window_rows[i:i + 500],
                                       [r["id"] for r in window_rows[i:i + 500]])
                time.sleep(0.02)
            if not p.wait_routed(120):
                raise AssertionError(f"{tag}: the recorded window did not drain")
            out["record_s"] = time.perf_counter() - t0
            wait(lambda: p.audit.counts()["recorded"] >= n, f"{tag}: every record", 30)
            p.audit.flush()
            recs = p.audit.scan_window()
            if len(recs) != n or any(r.get("row") is None for r in recs):
                raise AssertionError(f"{tag}: {len(recs)} records of {n}, rows captured on "
                                     f"{sum(r.get('row') is not None for r in recs)}")
            lo, hi = recs[0]["seq"], recs[-1]["seq"]
            live = self.rollout_paced(p, live_rows, ROLLOUT_RATE, stop)
            time.sleep(REPLAY_BEFORE_S)
            t_b = time.time()
            rep = p.replay.run_window(lo, hi, window_id="parity")
            t_e = time.time()
            out["parity"] = rep
            # kill a window at a batch's production, then resume it
            def kill(ev, bi):
                if ev == "produced" and bi == REPLAY_KILL_BATCH:
                    raise ReplayKilled()

            p.replay.crash_hook = kill
            try:
                p.replay.run_window(lo, hi, window_id="killed")
                raise AssertionError(f"{tag}: the kill did not fire")
            except ReplayKilled:
                pass
            p.replay.crash_hook = None
            time.sleep(1.0)  # the dead worker's batch lands in its join
            out["resumed"] = p.replay.run_window(lo, hi, window_id="killed")
            # a promotion through the gates (lenient here: (a) holds the
            # gates; this part needs a champion with other params)
            lc = p.lifecycle
            new = to_numpy(p.scorer.params)
            new["layers"][-1]["b"] = new["layers"][-1]["b"] + np.float32(0.25)
            v = lc.submit_candidate(new)
            wait(lambda: lc.store.get(v).stage in ("CHAMPION", "REJECTED", "ROLLED_BACK"),
                 f"{tag}: the promotion", 120)
            if lc.store.get(v).stage != "CHAMPION":
                raise AssertionError(f"{tag}: the candidate ended {lc.store.get(v).stage}")
            out["promoted"] = p.replay.run_window(lo, hi, window_id="after-promotion")
            stop.set()
            live.join()
            if not p.wait_routed(120):
                raise AssertionError(f"{tag}: the router did not drain")
            rr = p.registries["router"]
            produced = sum(p.broker.end_offsets(topic))
            incoming = rr.counter("transaction_incoming_total").value()
            routed = rr.counter("transaction_outgoing_total").total()
            started = p.engine.snapshot()["next_pid"] - 1
            ring = self.rollout_records(p)
            probations = p.registries["heal"].counter(
                "ccfd_heal_transitions_total").value({"to": "probation"})
            warm = len(p.scorer.batch_sizes)
            sent = live.sent
        finally:
            stop.set()
            p.down()
        dispatched, launched = settled_launches(p.scorer.dispatch_total,
                                                counters["fused_mlp_bf16"],
                                                warm * (1 + probations))
        par, res, pro = out["parity"], out["resumed"], out["promoted"]
        before = self.rollout_latency(ring, 0.0, t_b)
        during = self.rollout_latency(ring, t_b, t_e)
        fails = []
        if not (par["parity"] and par["match"] == n and par["ghost"] == 0):
            fails.append(f"parity window: {({k: par[k] for k in ('match', 'divergence', 'drop', 'ghost', 'causes')})}, "
                         f"first findings {par['findings'][:3]}")
        if not (res["resumed_at"] == REPLAY_KILL_BATCH * REPLAY_BATCH and res["parity"]
                and res["match"] == n):
            fails.append(f"the resumed window: resumed_at {res['resumed_at']}, "
                         f"{({k: res[k] for k in ('match', 'divergence', 'drop', 'ghost', 'dup')})}")
        if not (pro["divergence"] > 0 and set(pro["causes"]) == {CAUSE_CHAMPION_HASH}
                and pro["drop"] == pro["ghost"] == 0):
            fails.append(f"after the promotion: causes {pro['causes']}, drops {pro['drop']}, "
                         f"ghosts {pro['ghost']}")
        if not produced == incoming == routed == started:
            fails.append(f"produced {produced}, incoming {incoming}, routed {routed}, "
                         f"started {started}")
        if launched != dispatched + warm * (1 + probations):
            fails.append(f"B1 launches {launched} != dispatches {dispatched} + {warm} x "
                         f"{1 + probations:.0f} warmups")
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        log("rollout", f"ok: {tag}: {n} transactions recorded in {out['record_s']:.3f} s with "
            f"their rows captured; replayed at bulk priority beside {ROLLOUT_RATE}/s live "
            f"({sent} live rows): {par['match']} of {n} rows at parity (0 divergences, drops, "
            f"ghosts) at {par['rows_per_s']:.1f} rows/s; killed at batch {REPLAY_KILL_BATCH}'s "
            f"production and resumed at row {res['resumed_at']}: {res['match']} matched, "
            f"{res['dup']} late duplicates ignored; after promoting v{v}: {pro['divergence']} "
            f"divergences, all champion_hash, {pro['match']} rows unchanged; live decision "
            f"p50/p99 before the replay {before[0]:.3f}/{before[1]:.3f} ms ({before[2]} "
            f"records), during it {during[0]:.3f}/{during[1]:.3f} ms ({during[2]}); "
            f"produced {produced:.0f} = incoming = routed = started; B1 launches {launched} = "
            f"dispatches {dispatched} + {warm} x {1 + probations:.0f} warmups on {self.card}")
        shutil.rmtree(tmp, ignore_errors=True)
        return int(launched)

    def rollout_analytics(self) -> None:
        """(c) ``analyze``'s summary at the Kaggle table's size on the card
        against the port's CPU run: counts, extrema and edges exact, the
        moments within 1e-5 of the magnitudes summed, PSI within 1e-6; the
        drift monitor flags a shifted window and passes a stable one;
        summarize's device ms (CUDA events, the two passes on rows already
        on the card) and wall ms."""
        import numpy as np

        from ccfd_tpu_torch.analytics.engine import (
            AnalyticsEngine, DriftMonitor, hist_job, moments_job)
        from ccfd_tpu_torch.bus.broker import Broker
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES, synthetic_dataset
        from ccfd_tpu_torch.metrics.prom import Registry

        torch = self.torch
        tag = "rollout (c) analytics"
        ds = synthetic_dataset(n=ANALYTICS_ROWS, seed=0)
        card, cpu = AnalyticsEngine(device=self.dev), AnalyticsEngine(device="cpu")
        card.summarize(ds.X[:4096], ds.y[:4096])  # first use off the clock
        t0 = time.perf_counter()
        got = card.summarize(ds.X, ds.y)
        wall_ms = (time.perf_counter() - t0) * 1e3
        want = cpu.summarize(ds.X, ds.y)
        x64 = ds.X.astype(np.float64)
        s_mean, s_sq = np.abs(x64).mean(0), (x64 * x64).mean(0)
        fails = []
        for k in ("min", "max", "hist", "edges", "class_counts"):
            if not np.array_equal(getattr(got, k), getattr(want, k)):
                fails.append(f"{k} differs")
        if got.n != want.n:
            fails.append(f"n {got.n} != {want.n}")
        e_mean = float(np.max(np.abs(got.mean - want.mean) / s_mean))
        e_var = float(np.max(np.abs(got.std**2 - want.std**2) / s_sq))
        bound = np.sqrt(np.outer(s_sq, s_sq)) / np.maximum(np.outer(want.std, want.std), 1e-6)
        e_corr = float(np.max(np.abs(got.corr - want.corr) / np.maximum(bound, 1.0)))
        if max(e_mean, e_var, e_corr) > ANALYTICS_TOL:
            fails.append(f"moments: mean {e_mean:.3e}, var {e_var:.3e}, corr {e_corr:.3e} "
                         f"of the magnitudes summed")
        rng = np.random.default_rng(SEED)
        stable = ds.X[rng.permutation(ds.n)[:4096]]
        shifted = stable.copy()
        shifted[:, FEATURE_NAMES.index("Amount")] *= 25.0
        e_psi = max(float(np.max(np.abs(card.drift(got, w) - cpu.drift(want, w))))
                    for w in (stable, shifted))
        if e_psi > 1e-6:
            fails.append(f"PSI card vs CPU {e_psi:.3e}")
        cfg = Config.from_env()
        scores = {}
        for name, win in (("stable", stable), ("shifted", shifted)):
            broker, reg = Broker(), Registry()
            mon = DriftMonitor(cfg, broker, got, engine=card, registry=reg, window=4096)
            try:
                broker.produce_batch(cfg.kafka_topic,
                                     [dict(zip(FEATURE_NAMES, map(float, r))) for r in win])
                mon.step()
                scores[name] = reg.gauge("analytics_drift_max_psi").value()
            finally:
                mon.stop()
        if not (scores["stable"] < 0.1 and scores["shifted"] > 0.25):
            fails.append(f"drift monitor: stable max PSI {scores['stable']:.4f}, shifted "
                         f"{scores['shifted']:.4f}")
        if fails:
            raise AssertionError(f"{tag}: " + "; ".join(fails))
        xd = torch.from_numpy(ds.X).to(self.dev)
        yd = torch.from_numpy(ds.y.astype(np.int64)).to(self.dev)
        lo, hi = (torch.from_numpy(a).to(self.dev) for a in (got.min, got.max))
        ms = []
        for _ in range(ANALYTICS_TIMED):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            moments_job(xd, yd)
            hist_job(xd, lo, hi, card.nbins)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        nbytes = ds.X.nbytes + ds.y.astype(np.int64).nbytes
        log("rollout", f"ok: {tag}: {ds.n} rows x {ds.X.shape[1]} features, card against "
            f"CPU: counts, extrema, edges exact; mean {e_mean:.3e}, var {e_var:.3e}, corr "
            f"{e_corr:.3e} of the magnitudes summed, PSI {e_psi:.3e}; drift monitor max PSI "
            f"stable {scores['stable']:.4f}, Amount x25 {scores['shifted']:.4f}; summarize "
            f"{wall_ms:.3f} ms wall, the two device passes {min(ms):.3f} ms (median "
            f"{sorted(ms)[len(ms) // 2]:.3f}; the rows' {nbytes} bytes at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s take {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) "
            f"on {self.card}")

    # -- observatory: the evidence planes and the tools ---------------------
    def observatory(self) -> None:
        """(a)-(d) the incident and capacity planes on the operator, then
        ``loadgen`` and ``doctor`` (see the module docstring)."""
        b1 = self.observatory_planes()
        b1 += self.observatory_tools()
        self.reports["fused_mlp_bf16"]["launches"] += b1

    @staticmethod
    def dashboard_families() -> set:
        """The metric families the written dashboards' expressions read."""
        import re

        from ccfd_tpu_torch.observability import build_all_dashboards

        out = set()
        for board in build_all_dashboards().values():
            for panel in board["panels"]:
                for t in panel["targets"]:
                    e = re.sub(r"\{[^}]*\}", "", t["expr"])
                    e = re.sub(r"\[[^\]]*\]", "", e)
                    e = re.sub(r"\b(by|without|on|ignoring|group_left|group_right)"
                               r"\s*\([^)]*\)", "", e)
                    out |= {w for w in re.findall(r"[a-zA-Z_][a-zA-Z0-9_]*", e)
                            if w not in PROMQL_WORDS}
        return out

    def observatory_planes(self) -> int:
        """(a)-(d); returns B1's launches."""
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import iter_transactions, load_dataset
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

        tag = "observatory"
        tmp = tempfile.mkdtemp(prefix="ccfd_obs_")
        rows = list(iter_transactions(load_dataset()))
        cfg = Config.from_env()
        launched = 0
        runs: dict = {}
        for arm in ("on", "off"):
            cr = self.platform_cr(
                os.path.join(tmp, arm), store={"enabled": False}, producer={"enabled": False},
                scorer={"model": "mlp", "train_steps": 0, "rest": True},
                retrain={"enabled": False}, heal={"enabled": False}, slo=OBS_SLO,
                incident={"enabled": arm == "on", "interval_s": 1.0,
                          "dir": os.path.join(tmp, arm, "incidents")},
                capacity={"enabled": arm == "on", "interval_s": 1.0})
            counters = self.counters()
            for c in counters.values():
                c.reset()
            p = Platform(PlatformSpec.from_cr(cr, cfg=cfg)).up(wait_ready_s=120)
            stop = threading.Event()
            cpu_s: dict = {}
            out: dict = {}
            try:
                if arm == "on":
                    cpu_s["recorder"], cpu_s["capacity"] = [0.0], [0.0]
                    self.rollout_cpu_clock(p.recorder, cpu_s["recorder"], "snapshot")
                    self.rollout_cpu_clock(p.capacity, cpu_s["capacity"], "refresh")
                    breach_ms: list = []
                    on_breach = p.recorder.on_breach

                    def timed_breach(*a, **kw):
                        t = time.perf_counter()
                        try:
                            return on_breach(*a, **kw)
                        finally:
                            breach_ms.append((time.perf_counter() - t) * 1e3)

                    # the SLO engine holds the bound method: re-point it
                    p.slo._breach_listeners[:] = [
                        timed_breach if fn == on_breach else fn for fn in p.slo._breach_listeners]
                    out["breach_ms"] = breach_ms
                rr = p.registries["router"]
                t0, u0 = time.perf_counter(), time.time()
                live = self.rollout_paced(p, rows, OBS_RATE, stop)
                time.sleep(OBS_WINDOW_S)
                window = time.perf_counter() - t0
                routed_w, u1 = rr.counter("transaction_outgoing_total").total(), time.time()
                if arm == "on":
                    out.update(self.observatory_capacity(p, tag))
                    out.update(self.observatory_breach(p, tag))
                    out.update(self.observatory_families(p, tag))
                stop.set()
                live.join()
                sent = live.sent
                if not p.wait_routed(120):
                    raise AssertionError(f"{tag} ({arm}): the router did not drain")
                self.heal_wait(lambda: p.audit.counts()["recorded"] >= sent,
                               f"{tag}: every record", 30)
                incoming = rr.counter("transaction_incoming_total").value()
                routed = rr.counter("transaction_outgoing_total").total()
                started = p.engine.snapshot()["next_pid"] - 1
                recs = self.rollout_records(p)
                warm = len(p.scorer.batch_sizes)
            finally:
                stop.set()
                p.down()
            dispatched, n_launch = settled_launches(p.scorer.dispatch_total,
                                                    counters["fused_mlp_bf16"], warm)
            fails = []
            if not sent == incoming == routed == started:
                fails.append(f"produced {sent}, incoming {incoming}, routed {routed}, "
                             f"started {started}")
            if n_launch != dispatched + warm:
                fails.append(f"B1 launches {n_launch} != dispatches {dispatched} + {warm} "
                             "warmups")
            if fails:
                raise AssertionError(f"{tag} ({arm}): " + "; ".join(fails))
            launched += n_launch
            p50, p99, n_lat = self.rollout_latency(recs, u0, u1)
            runs[arm] = {"sent": sent, "tx_s": routed_w / window, "p50": p50, "p99": p99,
                         "n_lat": n_lat, "window": window,
                         "cpu": {k: v[0] for k, v in cpu_s.items()}, **out}
        on, off = runs["on"], runs["off"]
        log(tag, f"ok: (a) at {OBS_RATE}/s asked: /capacity valid, bottleneck "
            f"{on['bottleneck']['stage']} ({on['bottleneck']['layer']}) headroom "
            f"{on['bottleneck']['headroom_ratio']} at {on['bottleneck']['admitted_rows_per_s']} "
            f"rows/s; /capacity/whatif?workers=2 valid, predicted e2e p99 "
            f"{on['whatif']['base_predicted_p99_ms']} -> {on['whatif']['predicted_p99_ms']} ms; "
            f"ccfd_capacity_model_error_ratio {on['error_ratio']}; stages "
            f"{on['cap_stages']} on {self.card}")
        log(tag, f"ok: (b) {HEAL_HANG} on B1: the e2e SLO breached, bundle {on['bundle']} "
            f"{on['fault_to_bundle_s']:.3f} s after the fault (bundles of the healthy window "
            f"before it: {on['bundles_before'] or 'none'}; on_breach took "
            f"{max(on['breach_ms'] or [float('nan')]):.3f} ms), {on['bundle_bytes']} bytes, "
            f"valid; it embeds {on['decisions']} decisions and the capacity snapshot "
            f"(bottleneck {on['bundle_bottleneck']}), ccfd_build_events_total "
            f"{on['build_events']} among its watched counters; {on['stamped']} decisions "
            f"carry its id, `audit {on['joined_tx']}` joins it; the SLO recovered "
            f"{on['recover_s']:.3f} s after the fault went; {on['sent']} + {off['sent']} "
            f"transactions each started once on {self.card}")
        log(tag, f"(c) at {OBS_RATE}/s asked over {OBS_WINDOW_S} s: planes on "
            f"{on['tx_s']:.1f} tx/s, decision p50 {on['p50']:.3f} ms p99 {on['p99']:.3f} ms "
            f"({on['n_lat']} records); off {off['tx_s']:.1f} tx/s, p50 {off['p50']:.3f} ms "
            f"p99 {off['p99']:.3f} ms ({off['n_lat']} records); thread CPU while on (the whole "
            f"run): " + ", ".join(f"{k} {v:.3f} s" for k, v in on["cpu"].items())
            + f" on {self.card}")
        log(tag, f"ok: (d) {on['families_read']} families read by the dashboards: "
            f"{on['families_seen']} in the scrape, absent with a named reason: "
            f"{sorted(on['families_absent'])}; listed absent but present: "
            f"{sorted(on['families_listed_present'])}")
        shutil.rmtree(tmp, ignore_errors=True)
        return int(launched)

    def observatory_capacity(self, p, tag: str) -> dict:
        """(a): /capacity and a what-if over HTTP, both valid."""
        from ccfd_tpu_torch.observability.capacity import validate_capacity

        base = p.exporter.endpoint
        self.heal_wait(lambda: (p.capacity.snapshot().get("bottleneck") or {}).get("stage"),
                       f"{tag}: a bottleneck", 30)
        cap = json.loads(urllib.request.urlopen(base + "/capacity", timeout=10).read())
        wi = json.loads(urllib.request.urlopen(base + "/capacity/whatif?workers=2",
                                               timeout=10).read())
        errs = validate_capacity(cap) + [f"whatif: {e}" for e in validate_capacity(wi)]
        bn = cap.get("bottleneck") or {}
        if errs or "headroom_ratio" not in bn or wi.get("whatif", {}).get(
                "requested") != {"workers": 2}:
            raise AssertionError(f"{tag} (a): /capacity {errs}, bottleneck {bn}, whatif "
                                 f"{wi.get('whatif')}")
        m = scrape(base + "/prometheus")
        return {"bottleneck": bn, "whatif": wi["whatif"],
                "error_ratio": m.get("ccfd_capacity_model_error_ratio"),
                "cap_stages": {k: (v["layer"], v["utilization"], v["headroom_ratio"])
                               for k, v in cap["stages"].items() if v["samples"]}}

    def observatory_breach(self, p, tag: str) -> dict:
        """(b): the forced breach, its bundle and the incident join."""
        import contextlib
        import io

        from ccfd_tpu_torch import cli
        from ccfd_tpu_torch.observability.incident import validate_incident
        from ccfd_tpu_torch.runtime import faults

        rec, base = p.recorder, p.exporter.endpoint
        # a healthy window's own breach is a finding, reported; the fault
        # starts from a closed breach so that its edge is a new one
        before = {s["id"] for s in rec.incidents()}
        self.heal_wait(lambda: not p.slo.any_breaching(), f"{tag} (b): no open breach", 60)
        t_fault = time.perf_counter()
        faults.install_device_faults(faults.DeviceFaultPlan.from_string(HEAL_HANG))
        try:
            self.heal_wait(lambda: len(rec.incidents()) > len(before), f"{tag} (b): a bundle",
                           OBS_BREACH_S)
            fault_to_bundle = time.perf_counter() - t_fault
            inc_id = rec.incidents()[0]["id"]

            def stamped() -> list:
                return [r for r in p.audit.list(limit=4096) if r.get("incident") == inc_id]

            self.heal_wait(lambda: len(stamped()) >= OBS_STAMPED,
                           f"{tag} (b): {OBS_STAMPED} decisions carrying {inc_id}", 60)
        finally:
            faults.install_device_faults(None)
        t_off = time.perf_counter()
        self.heal_wait(lambda: not p.slo.any_breaching(), f"{tag} (b): the SLO's recovery",
                       OBS_RECOVER_S)
        recover_s = time.perf_counter() - t_off
        listing = json.loads(urllib.request.urlopen(base + "/incidents", timeout=10).read())
        doc = json.loads(urllib.request.urlopen(f"{base}/incidents/{inc_id}",
                                                timeout=10).read())
        carried = stamped()
        tx = carried[0]["tx"]
        p.audit.flush()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["audit", str(tx), "--url", base, "--json"])
        joined = json.loads(buf.getvalue()) if rc == 0 else {}
        fails = []
        if [s["id"] for s in listing["incidents"] if s["id"] not in before] != [inc_id]:
            fails.append(f"bundles {listing['incidents']} (want exactly one new)")
        if doc.get("trigger", {}).get("type") != "slo_breach" or validate_incident(doc):
            fails.append(f"bundle trigger {doc.get('trigger')}, invalid "
                         f"{validate_incident(doc)}")
        if not doc.get("decisions") or not isinstance(doc.get("capacity"), dict):
            fails.append(f"bundle decisions {len(doc.get('decisions') or [])}, capacity "
                         f"{doc.get('capacity')}")
        if "ccfd_build_events_total" not in doc["snapshot"]["counters"]:
            fails.append(f"watched counters {sorted(doc['snapshot']['counters'])}")
        if (joined.get("incident") or {}).get("id") != inc_id or not joined["incident"]["found"]:
            fails.append(f"audit {tx}: incident join {joined.get('incident')} (rc {rc})")
        if fails:
            raise AssertionError(f"{tag} (b): " + "; ".join(fails))
        return {"bundle": inc_id, "fault_to_bundle_s": fault_to_bundle,
                "bundles_before": sorted(before),
                "bundle_bytes": len(json.dumps(doc).encode()),
                "decisions": len(doc["decisions"]),
                "bundle_bottleneck": (doc["capacity"].get("bottleneck") or {}).get("stage"),
                "build_events": doc["snapshot"]["counters"]["ccfd_build_events_total"],
                "stamped": len(carried), "joined_tx": tx, "recover_s": recover_s}

    def observatory_families(self, p, tag: str) -> dict:
        """(d): every family the dashboards read is in the scrape or named
        absent with its reason."""
        import re

        text = urllib.request.urlopen(p.exporter.endpoint + "/prometheus",
                                      timeout=10).read().decode()
        seen = set(re.findall(r"^# TYPE (\S+) ", text, flags=re.M))
        read = self.dashboard_families()

        def present(f: str) -> bool:
            return f in seen or re.sub(r"_(bucket|count|sum)$", "", f) in seen

        missing = {f for f in read if not present(f)}
        unexplained = sorted(f for f in missing
                             if re.sub(r"_(bucket|count|sum)$", "", f) not in OBS_ABSENT
                             and f not in OBS_ABSENT)
        if unexplained:
            raise AssertionError(f"{tag} (d): families the dashboards read, absent from the "
                                 f"scrape with no named reason: {unexplained}")
        return {"families_read": len(read), "families_seen": len(read - missing),
                "families_absent": missing,
                "families_listed_present": {f for f in OBS_ABSENT if present(f)}}

    def observatory_tools(self) -> int:
        """``loadgen`` against ``serve`` on the card and ``doctor``; returns
        the serve process's B1 launches."""
        from ccfd_tpu_torch.config import Config

        tag = "observatory tools"
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = REPO
        port = free_port()
        url = f"http://127.0.0.1:{port}"
        logf = tempfile.NamedTemporaryFile("w+", prefix="ccfd_serve_", suffix=".log",
                                           delete=False)
        serve = subprocess.Popen([sys.executable, "-m", "ccfd_tpu_torch", "serve", "--host",
                                  "127.0.0.1", "--port", str(port), "--device", "cuda"],
                                 cwd=REPO, env=env, stdout=logf, stderr=subprocess.STDOUT)
        try:
            Roles.wait(f"{url}/health/status", serve, 180)
            t0 = time.perf_counter()
            lg = subprocess.run([sys.executable, "-m", "ccfd_tpu_torch", "loadgen", "--url",
                                 url, *LOADGEN_ARGS], cwd=REPO, env=env, capture_output=True,
                                text=True, timeout=120)
            lg_wall = time.perf_counter() - t0
            m = scrape(f"{url}/prometheus")
        finally:
            serve.send_signal(signal.SIGTERM)
            try:
                serve.wait(timeout=20)
            except subprocess.TimeoutExpired:
                serve.kill()
                serve.wait()
            logf.seek(0)
            serve_log = logf.read()[-3000:]
            logf.close()
            os.unlink(logf.name)
        try:
            rep = json.loads(lg.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            rep = {}
        warm = len(Config.from_env().batch_sizes)
        b1, disp = launches_of(m), m.get("ccfd_scorer_dispatches", 0.0)
        if lg.returncode != 0 or rep.get("errors") != 0 or rep.get("failed_clients") != 0:
            print(f"--- serve log (tail) ---\n{serve_log}", flush=True)
            raise AssertionError(f"{tag}: loadgen exited {lg.returncode}: {rep or lg.stderr[-2000:]}")
        if b1 != disp + warm or not disp:
            raise AssertionError(f"{tag}: serve B1 launches {b1} != dispatches {disp} + "
                                 f"{warm} warmups")
        own = self.serve16.get("fused_mlp_bf16")
        log(tag, f"ok: `loadgen {' '.join(LOADGEN_ARGS)}` against `serve` (B1) in "
            f"{lg_wall:.3f} s: {rep['requests_s']} requests/s, {rep['tx_s']} tx/s, p50 "
            f"{rep['p50_ms']} ms, p99 {rep['p99_ms']} ms, 0 errors; the serve phase's own "
            f"200 sequential 16-row POSTs (one client): "
            + (quantiles(own) if own is not None else "not run")
            + f"; serve B1 launches {b1:.0f} = dispatches {disp:.0f} + {warm} warmups on "
            f"{self.card}")
        t0 = time.perf_counter()
        dr = subprocess.run([sys.executable, "-m", "ccfd_tpu_torch", "doctor"], cwd=REPO,
                            env=env, capture_output=True, text=True, timeout=180)
        try:
            doc = json.loads(dr.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            doc = {}
        dev = doc.get("device", {})
        name = self.torch.cuda.get_device_name(0)
        built = {k: v.get("built") for k, v in doc.get("kernels", {}).items()}
        if dr.returncode != 0 or dev.get("name") != name or not all(built.values()):
            raise AssertionError(f"{tag}: doctor exited {dr.returncode}: device {dev}, "
                                 f"kernels built {built}; {dr.stderr[-2000:]}")
        log(tag, f"ok: `doctor` exit 0 in {time.perf_counter() - t0:.3f} s: {dev.get('name')} "
            f"x{dev.get('devices')}, nvidia-smi {dev.get('nvidia_smi')}, torch "
            f"{dev.get('torch')} CUDA {dev.get('cuda')}, dispatch round trip "
            f"{dev.get('dispatch_rtt_ms')} ms; kernels built and current {built}")
        return int(disp)

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

    # -- serve (e): the batcher's CoDel and bounded priority queue ---------
    def serve_overload(self) -> None:
        """(e) ``serve`` on the Python transport with CoDel and the bounded
        priority queue armed (OVERLOAD_ENV), under a burst of 16-row POSTs
        from OVERLOAD_CLIENTS clients in mixed classes: every answer held
        against B1's plain version, B1's launches = the scorer's
        dispatches, bulk shed by the batcher, and no shed of a class while
        a lower class's rows that waited as long stayed queued or were kept
        (an inversion). Returns B1's launches."""
        import http.client

        import numpy as np

        from ccfd_tpu_torch.cli import build_server
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.ops import fused_mlp

        tag = "serve (e) overload"
        kp = self.kernel_params("checkpoint")

        def plain(x):
            return fused_mlp.fused_mlp_reference(
                kp, self.torch.from_numpy(x).to(self.torch.bfloat16).to(self.dev))

        srv = build_server(Config.from_env({**os.environ, **OVERLOAD_ENV}), device="cuda")
        b = srv.batcher
        if srv.transport != "python" or b._codel is None or b._max_queue_rows != 4096:
            raise AssertionError(f"{tag}: not the Python transport with CoDel and the bound")
        inv = {"older_lower_kept": 0, "fresher_lower_kept": 0, "assemblies_shedding": 0,
               "refused_over_lower": 0}
        shed_stale = b._shed_stale
        codel_drop = threading.local()

        def watched_shed_stale(batch):
            codel_drop.on = True
            try:
                kept = shed_stale(batch)
            finally:
                codel_drop.on = False
            ids = {id(e) for e in kept}
            dropped = [e for e in batch if id(e) not in ids]
            if dropped:
                inv["assemblies_shedding"] += 1
            for d in dropped:  # entry: (x, future, enqueue_ts, priority)
                for k in kept:
                    if k[3] < d[3]:
                        inv["older_lower_kept" if k[2] <= d[2] else "fresher_lower_kept"] += 1
            return kept

        b._shed_stale = watched_shed_stale
        on_shed = b._on_shed

        def watched_on_shed(rows, pri):
            # an arrival refused by the bound: lower-class rows still queued
            # would be an inversion (the condition is an RLock); CoDel's
            # drops are judged above, by their sojourns
            if not getattr(codel_drop, "on", False):
                with b._cv:
                    if any(e[3] < pri for e in b._queue):
                        inv["refused_over_lower"] += 1
            on_shed(rows, pri)

        b._on_shed = watched_on_shed
        counters = self.counters()
        port = srv.start("127.0.0.1", 0)
        results: list = []
        errs: list = []
        go = threading.Event()

        def client(i: int) -> None:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                go.wait()
                for j in range(OVERLOAD_POSTS):
                    pri = PRIORITIES[(i + j) % len(PRIORITIES)]
                    x = self.rows[((i * OVERLOAD_POSTS + j) * 16) % 19_984:][:16]
                    body = json.dumps({"data": {"ndarray": x.tolist()}})
                    t0 = time.perf_counter()
                    conn.request("POST", "/api/v0.1/predictions", body,
                                 {"Content-Type": "application/json", "x-ccfd-priority": pri})
                    resp = conn.getresponse()
                    out = json.loads(resp.read())
                    results.append((pri, resp.status, time.perf_counter() - t0, x, out))
                conn.close()
            except Exception as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        try:
            for c in counters.values():
                c.reset()
            d0 = srv.scorer.dispatch_total()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(OVERLOAD_CLIENTS)]
            for t in threads:
                t.start()
            t0 = time.perf_counter()
            go.set()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            launched = {k: c.value for k, c in counters.items()}
            dispatched = srv.scorer.dispatch_total() - d0
            m = scrape(f"http://127.0.0.1:{port}/prometheus")
        finally:
            srv.stop()
        if errs or any(t.is_alive() for t in threads):
            raise AssertionError(f"{tag}: clients failed: {errs[:3]}")
        answered = {p: 0 for p in PRIORITIES}
        refused = {p: 0 for p in PRIORITIES}
        lat = {p: [] for p in PRIORITIES}
        dp_max = 0.0
        for pri, status, dt, x, out in results:
            if status == 200:
                p = np.asarray(out["data"]["ndarray"], np.float64)[:, 1]
                dp_max = max(dp_max, rest_check("fused_mlp_bf16", plain, x, p,
                                                f"{tag} {pri} answer")[0])
                answered[pri] += 1
                lat[pri].append(dt * 1e3)
            elif status == 429:
                refused[pri] += 1
            else:
                raise AssertionError(f"{tag}: HTTP {status}: {out}")
        shed = {(p, s): m.get(f'ccfd_shed_total{{priority="{p}",stage="{s}"}}', 0.0)
                for p in PRIORITIES for s in ("batcher", "rest")}
        n = OVERLOAD_CLIENTS * OVERLOAD_POSTS
        log(tag, f"{n} POSTs of 16 rows from {OVERLOAD_CLIENTS} clients in {wall:.3f} s "
            f"({n * 16 / wall:.1f} rows/s); answered {answered}, 429 {refused}; rows shed "
            f"by the batcher {({p: shed[(p, 'batcher')] for p in PRIORITIES})}, by the REST "
            f"gate {({p: shed[(p, 'rest')] for p in PRIORITIES})}; answers vs plain max|dp| "
            f"{dp_max:.3e}; launches {launched}, dispatches {dispatched}; inversions "
            f"{inv} on {self.card}")
        for p in PRIORITIES:
            if lat[p]:
                log(tag, f"{p}: {answered[p]} answered, latency {quantiles(np.sort(lat[p]))}")
        if sum(answered.values()) + sum(refused.values()) != n:
            raise AssertionError(f"{tag}: {len(results)} answers for {n} POSTs")
        if shed[("bulk", "batcher")] <= 0:
            raise AssertionError(f"{tag}: the batcher shed no bulk rows: the burst did not "
                                 "pass what the path serves")
        if inv["older_lower_kept"] or inv["refused_over_lower"]:
            raise AssertionError(f"{tag}: priority inversions {inv}")
        others = {k: v for k, v in launched.items() if k != "fused_mlp_bf16" and v}
        if launched["fused_mlp_bf16"] != dispatched or not dispatched or others:
            raise AssertionError(f"{tag}: launches {launched} for {dispatched} dispatches")
        self.reports["fused_mlp_bf16"]["launches"] += launched["fused_mlp_bf16"]

    # -- seq: the history-aware family (torch code, no hand kernel) --------
    def seq(self) -> None:
        """The seq family on the card: (a) parity against the port's CPU
        path and the reference's golden rows, (b) timing against the bound,
        (c) the operator with ``scorer.model: seq`` and ``seq_q8``."""
        self.seq_parity()
        self.seq_timing()
        for model in ("seq", "seq_q8"):
            self.seq_operator(model)
        self.seq_lifecycle()

    def seq_histories(self, b: int, length: int, seed: int = SEED):
        """``b`` (length, 30) histories of surrogate rows, each of a seeded
        depth (1 and full included) with zero left-pad."""
        import numpy as np

        rng = np.random.default_rng(seed + b + length)
        x = self.rows[rng.integers(0, len(self.rows), size=(b, length))].astype(np.float32)
        depth = rng.integers(1, length + 1, size=b)
        depth[0] = 1
        depth[-1] = length
        for i, d in enumerate(depth):
            x[i, : length - d] = 0.0
        return x

    def seq_variants(self) -> dict:
        """name -> (apply, params on the card, params on the CPU, dtype, bar)."""
        from ccfd_tpu_torch.models import seq as seq_mod
        from ccfd_tpu_torch.ops import seq_quant
        from ccfd_tpu_torch.params import load_tree
        from ccfd_tpu_torch.platform.operator import SEQ_INIT

        torch = self.torch
        cpu = load_tree(SEQ_INIT)
        q8 = seq_quant.quantize_seq(cpu)
        card, q8_card = load_tree(SEQ_INIT, self.dev), seq_quant.quantize_seq(cpu, self.dev)
        return {
            "seq f32": (seq_mod.apply_serving, card, cpu, torch.float32, SEQ_TOL["f32"]),
            "seq bf16": (seq_mod.apply_serving, card, cpu, torch.bfloat16, SEQ_TOL["bf16"]),
            "seq_q8 bf16": (seq_quant.apply_serving, q8_card, q8, torch.bfloat16,
                            SEQ_TOL["q8"]),
        }

    def seq_parity(self) -> None:
        import numpy as np

        from ccfd_tpu_torch.ops import seq_quant

        torch = self.torch
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            variants = self.seq_variants()
            cases = [(b, SEQ_L) for b in SEQ_B] + [(SEQ_SHORT_B, lb) for lb in SEQ_SHORT_L]
            for name, (apply, card, cpu, dt, bar) in variants.items():
                worst = 0.0
                for b, length in cases:
                    x = self.seq_histories(b, length)
                    got = apply(card, torch.from_numpy(x).to(self.dev), dt,
                                pos_length=SEQ_L).cpu()
                    # rows are independent: the CPU scores the first
                    # SEQ_CPU_ROWS of the card's batch
                    want = apply(cpu, torch.from_numpy(x[:SEQ_CPU_ROWS]), dt, pos_length=SEQ_L)
                    whole = torch.isfinite(got).all() and got.shape == (b,)
                    d = (got[:SEQ_CPU_ROWS] - want).abs().max().item() if whole else math.inf
                    worst = max(worst, d)
                    if d > bar:
                        raise AssertionError(f"seq (a) {name} B={b} L={length}: card vs CPU "
                                             f"max|dp| {d:.3e} (bar {bar:.0e})")
                log("seq", f"(a) {name}: card vs the port's CPU path, B in {SEQ_B} at L="
                    f"{SEQ_L} and L in {SEQ_SHORT_L} at B={SEQ_SHORT_B} (pos_length {SEQ_L}; "
                    f"the CPU on the first {SEQ_CPU_ROWS} rows of each batch): "
                    f"max|dp| {worst:.3e} (bar {bar:.0e}) on {self.card}")
            # the reference's own numbers, from the golden file
            g = np.load(os.path.join(REPO, "ccfd_tpu_torch", "assets", "seq_golden.npz"))
            xg = torch.from_numpy(g["x"]).to(self.dev)
            for name, key in (("seq f32", "p_seq_f32"), ("seq bf16", "p_seq_bf16"),
                              ("seq_q8 bf16", "p_seq_q8_bf16")):
                apply, card, _cpu, dt, bar = variants[name]
                got = apply(card, xg, dt, pos_length=SEQ_L).cpu().numpy()
                d = float(np.abs(got - g[key]).max())
                log("seq", f"(a) {name} on the reference's golden rows ({len(got)} histories, "
                    f"depths 1..{int(g['depth'].max())}): max|dp| {d:.3e} (bar {bar:.0e})")
                if d > bar:
                    raise AssertionError(f"seq (a) {name}: the card is {d:.3e} from the "
                                         "reference's golden p")
            # seq_q8's int32 sums: the card's equal the CPU's bit for bit, for
            # every dense layer's weights and the embed's real rows
            _, q8_card, q8_cpu, _, _ = variants["seq_q8 bf16"]
            rng = np.random.default_rng(SEED)
            layers = {"embed": (q8_cpu["embed"], q8_card["embed"]),
                      "head": (q8_cpu["head"], q8_card["head"])}
            for i, (bc, bd) in enumerate(zip(q8_cpu["blocks"], q8_card["blocks"])):
                for k in ("qkv", "proj", "mlp_in", "mlp_out"):
                    layers[f"blocks/{i}/{k}"] = (bc[k], bd[k])
            x = self.seq_histories(256, SEQ_L)
            h = (torch.from_numpy(x) - q8_cpu["norm"]["mu"]) / q8_cpu["norm"]["sigma"]
            qe, _ = seq_quant._rowquant_tokens(h)
            n_acc = 0
            for name, (lc, ld) in layers.items():
                k = lc["wq"].shape[0]
                q = (qe.reshape(-1, k) if name == "embed" else torch.from_numpy(
                    rng.integers(-127, 128, size=(4096, k), dtype=np.int8)))
                want = seq_quant._int_acc(q, lc["wq"])
                got = seq_quant._int_acc(q.to(self.dev), ld["wq"]).cpu()
                n_acc += want.numel()
                if got.dtype != torch.int32 or not torch.equal(got, want):
                    raise AssertionError(f"seq (a) seq_q8 {name}: the card's int32 sums "
                                         "differ from the CPU's")
            log("seq", f"(a) seq_q8: int32 accumulators of {len(layers)} dense layers "
                f"({n_acc} sums, the embed's on real rows) bit-equal to the CPU's")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    @staticmethod
    def seq_work(b: int, length: int, q8: bool) -> tuple:
        """(dense ops, attention ops, bytes) of one readout forward: dense
        products at 2 ops a multiply-add, the attention's QK and PV, the
        rows in and p out and the weights read once."""
        d, f, h4 = 128, 30, 512
        dense = 2 * b * length * f * d  # embed
        attn = 0
        for last in (False, True):
            lq = 1 if last else length
            dense += 2 * b * length * d * 2 * d + 2 * b * lq * d * d  # k, v; q
            attn += 2 * 2 * b * lq * length * d  # scores and P.V
            dense += 2 * b * lq * d * d + 2 * 2 * b * lq * d * h4  # proj; mlp
        dense += 2 * b * d  # head
        weights = f * d + 2 * (3 * d * d + d * d + 2 * d * h4) + d
        nbytes = b * length * f * 4 + b * 4 + weights * (1 if q8 else 4)
        return dense, attn, nbytes

    def seq_timing(self) -> None:
        """(b) Each (L, B) shape of (a) and B=16,384 for seq (bf16) and
        seq_q8: CUDA events around SEQ_CALLS calls of ``apply_serving`` on
        histories already on the card, beside the bound (operations over
        the bf16 or int8 dense peak, the attention at the bf16 peak,
        against bytes over the memory rate), and the card's busy share
        over the calls from a device-only trace."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        variants = self.seq_variants()
        shapes = [(b, SEQ_L) for b in SEQ_B + (16384,)] + [(SEQ_SHORT_B, lb)
                                                           for lb in SEQ_SHORT_L]
        for name in ("seq bf16", "seq_q8 bf16"):
            apply, card, _cpu, dt, _bar = variants[name]
            q8 = name.startswith("seq_q8")
            for b, length in shapes:
                xs = torch.from_numpy(self.seq_histories(b, length)).to(self.dev)

                def call(xs=xs, apply=apply, card=card, dt=dt):
                    return apply(card, xs, dt, pos_length=SEQ_L)

                call()
                torch.cuda.synchronize()
                n = SEQ_CALLS if b <= 4096 else SEQ_CALLS // 5
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    e0.record()
                    for _ in range(n):
                        call()
                    e1.record()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                ms = e0.elapsed_time(e1) / n
                busy = sum(getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0.0)
                           for e in prof.key_averages()) / 1e3  # ms
                dense, attn, nbytes = self.seq_work(b, length, q8)
                t_ops = (dense / (INT8_OPS if q8 else BF16_FLOPS)
                         + attn / BF16_FLOPS) * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                bound = max(t_ops, t_bytes)
                by = "operations" if t_ops >= t_bytes else "bytes"
                log("seq", f"(b) {name} L={length} B={b}: {ms:.6f} ms a call (CUDA events "
                    f"around {n} calls), bound {bound:.6f} ms ({by}: {dense + attn:.4e} op, "
                    f"{nbytes} B), share {bound / ms:.4f}; the card busy "
                    + (f"{busy / (wall * 1e3):.4f} of the calls' wall time ({busy / n:.6f} ms "
                       f"a call of device time)" if busy else "not measured (no device "
                       "events)") + f" on {self.card}")

    def seq_operator(self, model: str) -> None:
        """(c) The operator (the port's CR, what ``up -f`` builds) with
        ``scorer.model: <model>``, history_length 64, retrain, producer and
        the investigator off, engine crash recovery on a durable bus:
        SEQ_OP_ROWS records from a seeded pool of SEQ_CUSTOMERS customers,
        an engine failure injected mid-stream; every transaction started
        once, no hand-kernel launch, /debug/device's seq grid, the served p
        of sampled customers against the CPU on the store's histories, and
        the store after the restore against a pass without the failure."""
        import numpy as np
        from torch.profiler import ProfilerActivity, profile

        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
        from ccfd_tpu_torch.models import seq as seq_mod
        from ccfd_tpu_torch.ops import seq_quant
        from ccfd_tpu_torch.params import to_device
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec
        from ccfd_tpu_torch.serving.history import HistoryStore

        torch = self.torch
        tag = f"seq (c) {model}"
        tmp = tempfile.mkdtemp(prefix="ccfd_seq_")
        cr = self.platform_cr(tmp, scorer={"model": model, "history_length": SEQ_L,
                                           "train_steps": 0},
                              retrain={"enabled": False}, producer={"enabled": False},
                              investigator={"enabled": False}, store={"enabled": False},
                              # (d) drives the seq family's lifecycle
                              lifecycle={"enabled": False},
                              engine={"crash_recovery": True, "checkpoint_interval_s": 0.5})
        cust = np.random.default_rng(SEED).integers(0, SEQ_CUSTOMERS, size=SEQ_OP_ROWS)
        rows = self.rows[np.arange(SEQ_OP_ROWS) % len(self.rows)]
        records = [{**{f: float(rows[i, j]) for j, f in enumerate(FEATURE_NAMES)},
                    "id": i, "customer_id": int(cust[i])} for i in range(SEQ_OP_ROWS)]
        counters = self.counters()
        p = Platform(PlatformSpec.from_cr(cr, cfg=Config.from_env()))
        p.up(wait_ready_s=120)
        served: dict = {}
        try:
            scorer = p.scorer
            score = scorer.score

            def recording_score(x, ids=None):
                out = score(x, ids)
                for k, v in zip(ids or [], out):
                    served[k] = float(v)
                return out

            scorer.score = recording_score
            for c in counters.values():
                c.reset()
            cfg = p.cfg
            half = SEQ_OP_ROWS // 2

            def produce(i: int, end: int) -> None:
                # keyed by customer: one customer's records stay in order on
                # one partition
                chunk = records[i:min(i + 1000, end)]
                p.broker.produce_batch(cfg.kafka_topic, chunk,
                                       keys=[r["customer_id"] for r in chunk])

            old = p.engine
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(0, half, 1000):
                    produce(i, half)
                self.seq_wait(lambda: p.recovery.checkpoints > 0, tag, "a checkpoint")
                if not p.supervisor.inject_failure("engine", "seq smoke"):
                    raise AssertionError(f"{tag}: the engine failure was not injected")
                self.seq_wait(lambda: p.recovery.restores >= 1 and p.engine is not old, tag,
                              "the restore")
                for i in range(half, SEQ_OP_ROWS, 1000):
                    produce(i, SEQ_OP_ROWS)
                self.seq_wait(lambda: p.engine.snapshot()["next_pid"] - 1 >= SEQ_OP_ROWS, tag,
                              "every start")
                window = time.perf_counter() - t0
            started = p.engine.snapshot()["next_pid"] - 1
            rr = p.registries["router"]
            dec = rr.histogram("router_decision_seconds")
            sreg = p.registries["seldon"]
            asm, disp = (sreg.histogram(h).sum() for h in ("seq_assembly_seconds",
                                                            "seq_dispatch_seconds"))
            snap = scorer.store.snapshot()
            dev_doc = json.loads(urllib.request.urlopen(
                p.exporter.endpoint + "/debug/device", timeout=10).read())
            grid = dev_doc["executables"]["seq"]
            restores, stale = p.recovery.restores, sreg.counter("seq_stale_commits_total").value()
            launched = {k: c.value for k, c in counters.items()}
        finally:
            p.down()
        busy = sum(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0.0)
                   for e in prof.key_averages()) / 1e6
        if started != SEQ_OP_ROWS or any(launched.values()):
            raise AssertionError(f"{tag}: {started} starts for {SEQ_OP_ROWS} records; hand "
                                 f"kernel launches {launched} (want none)")
        if grid["model"] != model or not any(e.get("dispatches") for e in grid["grid"]):
            raise AssertionError(f"{tag}: /debug/device seq grid {grid}")
        # the store after the failure against one pass of the same records
        want = HistoryStore(length=SEQ_L, max_customers=20_000)
        x = np.asarray([[r[f] for f in FEATURE_NAMES] for r in records], np.float32)
        _, tok = want.prepare([r["customer_id"] for r in records], x)
        want.commit(tok)
        ws = want.snapshot()["customers"]
        # per customer (the partitions interleave customers, so the LRU
        # order may differ; no customer is evicted at this cap)
        got_d = {k: (f, np.asarray(b).tobytes()) for k, b, f in snap["customers"]}
        same = got_d == {k: (f, np.asarray(b).tobytes()) for k, b, f in ws}
        if not same:
            raise AssertionError(f"{tag}: the store after the engine failure differs from a "
                                 "pass of the same records without it")
        # sampled customers: the served p of each one's last transaction
        # against the CPU on the history the store holds for it
        variants = self.seq_variants()
        _a, _card, cpu, dt, bar = variants["seq_q8 bf16" if model == "seq_q8" else "seq bf16"]
        apply = seq_quant.apply_serving if model == "seq_q8" else seq_mod.apply_serving
        rng = np.random.default_rng(SEED)
        picks = rng.choice(len(snap["customers"]), size=SEQ_SAMPLED, replace=False)
        hist = np.stack([np.asarray(snap["customers"][i][1]) for i in picks])
        want_p = apply(to_device(cpu, "cpu"), torch.from_numpy(hist), dt,
                       pos_length=SEQ_L).numpy()
        got_p = np.asarray([served[snap["customers"][i][0]] for i in picks])
        d = float(np.abs(got_p - want_p).max())
        depth = np.asarray([snap["customers"][i][2] for i in picks])
        if d > bar:
            raise AssertionError(f"{tag}: served p of {SEQ_SAMPLED} customers {d:.3e} from "
                                 f"the CPU on their histories (bar {bar:.0e})")
        log(tag, f"{SEQ_OP_ROWS} records from {SEQ_CUSTOMERS} customers, an engine failure "
            f"after {half} ({restores} restore, {stale:.0f} stale commits): {started} starts, "
            f"no hand-kernel launch ({launched}); the store after the restore equals a pass "
            f"without the failure ({len(ws)} customers, depths "
            f"{min(e[2] for e in ws)}..{max(e[2] for e in ws)}); served p of {SEQ_SAMPLED} "
            f"sampled customers (depths {depth.min()}..{depth.max()}) vs the CPU max|dp| "
            f"{d:.3e} (bar {bar:.0e}); /debug/device seq grid "
            f"{[(e['l_bucket'], e['b_bucket'], e.get('dispatches')) for e in grid['grid']]}")
        log(tag, f"{SEQ_OP_ROWS / window:.1f} tx/s over {window:.3f} s (the failure and "
            f"its replay included); decision p50 {dec.quantile(0.5) * 1e3:.3f} ms p99 "
            f"{dec.quantile(0.99) * 1e3:.3f} ms against the 10 ms limit; history assembly "
            f"{asm:.3f} s against dispatch {disp:.3f} s (assembly share "
            f"{asm / max(asm + disp, 1e-9):.4f}); the card busy "
            + (f"{busy:.3f} s, {busy / window:.4f} of the window" if busy
               else "not measured (no device events)") + f" on {self.card}")

    def seq_labels(self, p, stop: threading.Event) -> threading.Thread:
        """A thread producing SEQ_LC_LABELS labelled transactions a second
        (SEQ_LC_FRAUD of them fraud rows of the surrogate) onto ``p``'s
        labels topic, until ``stop``: the evaluator's label joins."""
        import numpy as np

        from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES

        rng = np.random.default_rng(SEED + 1)
        fraud, legit = np.nonzero(self.labels == 1)[0], np.nonzero(self.labels == 0)[0]
        topic = p.cfg.labels_topic

        def run() -> None:
            while not stop.wait(0.1):
                for _ in range(SEQ_LC_LABELS // 10):
                    y = int(rng.uniform() < SEQ_LC_FRAUD)
                    j = int(rng.choice(fraud if y else legit))
                    p.broker.produce(topic, {"transaction": dict(zip(
                        FEATURE_NAMES, map(float, self.rows[j]))), "label": y})

        th = threading.Thread(target=run, daemon=True, name="smoke-labels")
        th.start()
        return th

    def seq_lifecycle(self) -> None:
        """(d) The seq family's governed rollout on the operator (see the
        module docstring): a faithful int8 candidate promoted through
        shadow and canary and served as the int8 graph, a broken one
        rejected, then the lifecycle's cost against a lifecycle-off run."""
        import numpy as np

        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
        from ccfd_tpu_torch.ops import seq_quant
        from ccfd_tpu_torch.params import load_tree, params_fingerprint, to_numpy
        from ccfd_tpu_torch.platform.operator import SEQ_INIT, Platform, PlatformSpec

        torch = self.torch
        tag = "seq (d) lifecycle"
        tmp = tempfile.mkdtemp(prefix="ccfd_seqlc_")
        cpu = load_tree(SEQ_INIT)  # the operator's champion
        cand = seq_quant.quantize_seq(cpu)
        cand_fp = params_fingerprint(cand)
        broken = to_numpy(cand)
        broken["head"] = dict(broken["head"])
        broken["head"]["scale"] = np.zeros_like(broken["head"]["scale"])
        broken["head"]["b"] = np.asarray([4.0], np.float32)
        n_pool = 50_000
        cust = np.random.default_rng(SEED).integers(0, SEQ_CUSTOMERS, size=n_pool)
        pool = self.rows[np.arange(n_pool) % len(self.rows)]
        records = [{**dict(zip(FEATURE_NAMES, map(float, pool[i]))),
                    "customer_id": int(cust[i])} for i in range(n_pool)]
        hists = self.seq_histories(SEQ_LC_CHECK, SEQ_L)
        cfg = Config.from_env()
        wait = self.heal_wait
        runs: dict = {}
        for arm in ("on", "off"):
            cr = self.platform_cr(
                os.path.join(tmp, arm), scorer={"model": "seq", "history_length": SEQ_L,
                                                "train_steps": 0},
                retrain={"enabled": False}, producer={"enabled": False},
                investigator={"enabled": False}, store={"enabled": False},
                lifecycle={"enabled": arm == "on", **SEQ_LC_GUARDRAILS})
            counters = self.counters()
            for c in counters.values():
                c.reset()
            p = Platform(PlatformSpec.from_cr(cr, cfg=cfg)).up(wait_ready_s=120)
            stop = threading.Event()
            cpu_s: dict = {}
            taps: list = []
            out: dict = {}
            try:
                lc = p.lifecycle
                if lc is not None:
                    for name, obj in (("shadow", lc.shadow), ("controller", lc)):
                        cpu_s[name] = [0.0]
                        self.rollout_cpu_clock(obj, cpu_s[name])
                    chall = p.scorer.challenger_score

                    def timed(x, chall=chall):
                        # the challenger's forward on tapped (and canary)
                        # histories, CUDA events around the whole call
                        if np.ndim(x) != 3:
                            return chall(x)
                        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        a.record()
                        res = chall(x)
                        b.record()
                        b.synchronize()
                        taps.append((len(x), a.elapsed_time(b)))
                        return res

                    p.scorer.challenger_score = timed
                t0 = time.perf_counter()
                live = self.rollout_paced(p, records, SEQ_LC_RATE, stop, key="customer_id")
                labels = self.seq_labels(p, stop)
                if lc is None:
                    time.sleep(SEQ_LC_OFF_S)
                else:
                    out = self.seq_lifecycle_drive(p, lc, cand, cand_fp, broken, hists, tag,
                                                   wait)
                stop.set()
                live.join()
                labels.join()
                sent = live.sent
                if not p.wait_routed(120):
                    raise AssertionError(f"{tag} ({arm}): the router did not drain")
                wall = time.perf_counter() - t0
                wait(lambda: p.audit.counts()["recorded"] >= sent, f"{tag}: every record", 30)
                rr = p.registries["router"]
                incoming = rr.counter("transaction_incoming_total").value()
                routed = rr.counter("transaction_outgoing_total").total()
                started = p.engine.snapshot()["next_pid"] - 1
                recs = self.rollout_records(p)
                launched = {k: c.value for k, c in counters.items()}
            finally:
                stop.set()
                p.down()
            if not sent == incoming == routed == started or any(launched.values()):
                raise AssertionError(f"{tag} ({arm}): produced {sent}, incoming {incoming}, "
                                     f"routed {routed}, started {started}; hand-kernel "
                                     f"launches {launched} (want none)")
            p50, p99, n_lat = self.rollout_latency(recs)
            runs[arm] = {"sent": sent, "wall": wall, "tx_s": routed / wall, "p50": p50,
                         "p99": p99, "n_lat": n_lat, "cpu": {k: v[0] for k, v in cpu_s.items()},
                         "taps": taps, **out}
        on, off = runs["on"], runs["off"]
        tap_rows = np.asarray([r for r, _ in on["taps"]] or [0])
        tap_ms = np.asarray([m for _, m in on["taps"]] or [float("nan")])
        log("seq", f"ok: {tag}: quantize_seq(champion) v{on['v']} PROMOTED "
            f"{on['promote_s']:.3f} s after its submission (canary rows champion "
            f"{on['canary'][0]:.0f}, challenger {on['canary'][1]:.0f}); served "
            f"params_fingerprint = the candidate's = the lineage's ({cand_fp[:16]}), the int8 "
            f"graph; its p on {SEQ_LC_CHECK} histories vs the CPU seq_q8 max|dp| "
            f"{on['dp']:.3e} (bar {SEQ_TOL['q8']:.0e}); broken quantization v{on['bad']} "
            f"REJECTED in {on['reject_s']:.3f} s ({on['bad_reason']}), the champion's "
            f"fingerprint unchanged; no hand-kernel launch; {on['sent']} + {off['sent']} "
            f"transactions each started once on {self.card}")
        log("seq", f"{tag}: at {SEQ_LC_RATE}/s asked: lifecycle on {on['tx_s']:.1f} tx/s, "
            f"decision p50 {on['p50']:.3f} ms p99 {on['p99']:.3f} ms ({on['n_lat']} records, "
            f"{on['wall']:.3f} s); off {off['tx_s']:.1f} tx/s, p50 {off['p50']:.3f} ms p99 "
            f"{off['p99']:.3f} ms ({off['n_lat']} records, {off['wall']:.3f} s); the "
            f"challenger's forward a tapped batch: {len(on['taps'])} batches of "
            f"{tap_rows.mean():.1f} rows mean, median {float(np.median(tap_ms)):.3f} ms, mean "
            f"{float(tap_ms.mean()):.3f} ms (CUDA events); thread CPU while on: "
            + ", ".join(f"{k} {v:.3f} s ({v / on['wall'] * 100:.2f}% of a core)"
                        for k, v in on["cpu"].items()) + f" on {self.card}")
        shutil.rmtree(tmp, ignore_errors=True)

    def seq_lifecycle_drive(self, p, lc, cand, cand_fp: str, broken, hists, tag: str,
                            wait) -> dict:
        """(d)'s checks on the live seq platform; returns what the log
        reports."""
        import numpy as np

        from ccfd_tpu_torch.ops import seq_quant
        from ccfd_tpu_torch.params import params_fingerprint

        torch = self.torch
        out: dict = {}
        canary = p.registries["lifecycle"].counter("ccfd_lifecycle_canary_rows_total")

        def verdict(v: int, what: str) -> float:
            t = time.perf_counter()
            wait(lambda: lc.store.get(v).stage in ("CHAMPION", "REJECTED", "ROLLED_BACK"),
                 f"{tag}: {what}", SEQ_LC_VERDICT_S)
            return time.perf_counter() - t

        out["v"] = lc.submit_candidate(cand, label_watermark=0)
        out["promote_s"] = verdict(out["v"], "the int8 candidate's verdict")
        with lc._mu:
            rec = lc.store.get(out["v"])
            champ = lc.store.champion()
            served_fp = params_fingerprint(p.scorer.params)
            quantized = seq_quant.is_quantized(p.scorer.params)
        out["canary"] = (canary.value({"arm": "champion"}), canary.value({"arm": "challenger"}))
        if rec.stage != "CHAMPION" or not min(out["canary"]) > 0:
            raise AssertionError(f"{tag}: the int8 candidate ended {rec.stage}, canary rows "
                                 f"{out['canary']}; trail {lc.store.audit_trail(rec.version)}")
        if not (served_fp == cand_fp == champ.checkpoint_hash and quantized):
            raise AssertionError(f"{tag}: served {served_fp[:12]} (int8 {quantized}), "
                                 f"candidate {cand_fp[:12]}, champion v{champ.version} "
                                 f"{champ.checkpoint_hash[:12]}")
        # the promoted serving graph on fixed histories against the CPU
        with p.scorer._params_lock:
            params, fn = p.scorer.params, p.scorer._apply
        got = p.scorer._score_direct(hists, params, fn)
        want = seq_quant.apply_serving(cand, torch.from_numpy(hists), p.scorer.compute_dtype,
                                       pos_length=SEQ_L).float().numpy()
        out["dp"] = float(np.abs(got - want).max())
        if not out["dp"] <= SEQ_TOL["q8"]:
            raise AssertionError(f"{tag}: the promoted graph's p {out['dp']:.3e} from the CPU "
                                 f"seq_q8 (bar {SEQ_TOL['q8']:.0e})")
        # a broken quantization: rejected, the champion untouched
        out["bad"] = lc.submit_candidate(broken, label_watermark=0)
        out["reject_s"] = verdict(out["bad"], "the broken candidate's verdict")
        rec = lc.store.get(out["bad"])
        if (rec.stage != "REJECTED" or lc.champion != out["v"]
                or params_fingerprint(p.scorer.params) != cand_fp):
            raise AssertionError(f"{tag}: the broken candidate ended {rec.stage}, champion "
                                 f"v{lc.champion} (want v{out['v']}, fingerprint unchanged)")
        out["bad_reason"] = [e["detail"].get("reason") for e in lc.store.audit_trail(rec.version)
                             if e["detail"].get("to") == "REJECTED"][0]
        return out

    @staticmethod
    def seq_wait(pred, tag: str, what: str, timeout: float = 180.0) -> None:
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                raise AssertionError(f"{tag}: timed out waiting for {what}")
            time.sleep(0.02)

    # -- tasks: the user-task model and the investigator -------------------
    def tasks(self) -> None:
        """(a) The user-task model on the card against the CPU, (b) the
        operator with the investigator and the model on, bounced on its
        state file, (c) the ``tasks`` and ``investigate`` commands against
        (b)'s engine REST."""
        self.tasks_model()
        b1 = self.tasks_operator()
        self.reports["fused_mlp_bf16"]["launches"] += b1

    def tasks_model(self) -> None:
        import numpy as np

        from ccfd_tpu_torch.process.engine import Task
        from ccfd_tpu_torch.process.usertask_model import OnlineUserTaskModel

        torch = self.torch
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            cpu = OnlineUserTaskModel(warmup=False, device="cpu", seed=SEED)
            card = OnlineUserTaskModel(device=self.dev, seed=SEED)
            card.warmup_join(60)
            card.set_params(cpu.params)  # one carried init
            rng = np.random.default_rng(SEED)
            fits: dict = {}
            worst = {"params": 0.0, "predict": 0.0}
            probe = Task(task_id=0, pid=0, name="probe",
                         vars={"transaction": {"Amount": 900.0, "V17": -1.0}, "proba": 0.7})
            for i in range(TASK_COMPLETIONS):
                amount, v17 = float(rng.uniform(0, 2000)), float(rng.normal())
                t = Task(task_id=i + 1, pid=i + 1, name="fraud-investigation",
                         vars={"transaction": {"Amount": amount, "V17": v17, "Time": float(i)},
                               "proba": float(rng.uniform())})
                t.status, t.outcome = "completed", (amount > 1000) != (rng.uniform() < 0.1)
                before = cpu.last_loss
                cpu.observe(t)
                t0 = time.perf_counter()
                card.observe(t)
                dt = time.perf_counter() - t0
                if cpu.last_loss is not before:  # a fit ran
                    n = 1
                    while n < card.n_examples:
                        n *= 2
                    fits.setdefault(n, []).append(dt * 1e3)
                if card.trained:
                    for k, v in card.params.items():
                        worst["params"] = max(worst["params"],
                                              float(np.abs(v - cpu.params[k]).max()))
                    worst["predict"] = max(worst["predict"],
                                           abs(card.predict(probe)[1] - cpu.predict(probe)[1]))
            if not card.trained or worst["params"] > 1e-5 or worst["predict"] > 1e-5:
                raise AssertionError(f"tasks (a): card vs CPU {worst} (bar 1e-5)")
            lat = []
            for _ in range(TASK_PREDICTS):
                t0 = time.perf_counter()
                card.predict(probe)
                lat.append((time.perf_counter() - t0) * 1e3)
            log("tasks", f"(a) user-task model, {TASK_COMPLETIONS} human completions on the "
                f"card and the CPU from one init: after every fit max|d param| "
                f"{worst['params']:.3e}, max|d confidence| {worst['predict']:.3e} (bar 1e-5); "
                f"predict on the card {quantiles(np.sort(lat))}; fit ms by bucket "
                + ", ".join(f"{b}: {np.median(v):.3f} ({len(v)} fits)"
                            for b, v in sorted(fits.items())) + f" on {self.card}")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    def tasks_operator(self) -> int:
        """(b) The operator (the port's CR) with the investigator on,
        ``engine.usertask_model`` and its state file, and TASK_ROWS producer
        transactions, then a second wave of TASK_SECOND_ROWS once the model
        has trained: the investigator's completions by outcome, the model
        trained on human decisions only (no auto-closed task observed), the
        second wave's tasks suggested or auto-closed, B1's launches equal to
        the router's dispatches; (c) the commands while the first wave's
        queue is open; then down() and up() on the same state file. Returns
        B1's launches."""
        import numpy as np

        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

        tag = "tasks (b)"
        tmp = tempfile.mkdtemp(prefix="ccfd_tasks_")
        state = os.path.join(tmp, "usertask.npz")
        rest_port = free_port()
        cr = self.platform_cr(tmp, scorer={"model": "mlp", "train_steps": 0, "rest": False},
                              retrain={"enabled": False}, store={"enabled": False},
                              bus={"log_dir": None},
                              engine={"crash_recovery": False, "usertask_model": True,
                                      "usertask_state_file": state, "rest": True,
                                      "rest_port": rest_port},
                              investigator={"enabled": True, "rate_per_s": TASK_RATE},
                              producer={"transactions": TASK_ROWS})
        cfg = Config.from_env({**os.environ, **TASK_ENV})
        counters = self.counters()
        self._cli_completed = 0
        p = Platform(PlatformSpec.from_cr(cr, cfg=cfg))
        p.up(wait_ready_s=120)
        try:
            scorer, model, engine = p.scorer, p.usertask_model, p.engine
            url = f"http://127.0.0.1:{rest_port}"
            if model.device.type != self.dev.type or engine.prediction_service is not model:
                raise AssertionError(f"{tag}: the user-task model is not the card's "
                                     "prediction service")
            auto, suggested, observed = set(), [], set()
            predict, listener = model.predict, engine.task_listener

            def watched_predict(task):
                out = predict(task)
                if out[1] >= cfg.confidence_threshold:
                    auto.add(task.task_id)  # the engine auto-closes this task
                elif out[0] is not None:
                    suggested.append(task.task_id)  # pre-filled for the human
                return out

            def watched_listener(task):
                observed.add(task.task_id)
                listener(task)

            model.predict, engine.task_listener = watched_predict, watched_listener
            for c in counters.values():
                c.reset()
            d0 = scorer.dispatch_total()
            # the in-process investigator slowed to one completion a second
            # while the commands work the queue, then back to its rate
            p.investigator.rate_per_s = 1.0
            self.seq_wait(lambda: len(engine.tasks("open")) >= 20, tag, "open tasks")
            self.tasks_cli(url)
            p.investigator.rate_per_s = TASK_RATE
            self.seq_wait(p.wait_producer, tag, "the producer")
            kie = p.registries["kie"]
            opened = kie.histogram("fraud_investigation_amount")
            for wave, n in (("first", TASK_ROWS), ("second", TASK_ROWS + TASK_SECOND_ROWS)):
                if wave == "second":
                    self.seq_wait(lambda: model.trained, tag, "the model's first fit")
                    rows = self.rows[:TASK_SECOND_ROWS]
                    recs = [{**{f: float(r[j]) for j, f in enumerate(FEATURE_NAMES)},
                             "id": TASK_ROWS + i} for i, r in enumerate(rows)]
                    for i in range(0, len(recs), 1000):
                        p.broker.produce_batch(p.cfg.kafka_topic, recs[i:i + 1000])
                if not p.wait_routed(180):
                    raise AssertionError(f"{tag}: the router did not drain the {wave} wave")
                time.sleep(TASK_SETTLE_S)  # the no-reply timers open the tasks
                self.seq_wait(lambda: not engine.tasks("open"), tag,
                              f"the {wave} wave's queue drained", 300)
                if wave == "first":
                    first_opened = opened.count()
            inv = p.registries["investigator"].counter("investigator_tasks_completed_total")
            by = {o: inv.value({"outcome": o}) for o in ("approved", "cancelled")}
            launched = {k: c.value for k, c in counters.items()}
            dispatched = scorer.dispatch_total() - d0
            routed = p.registries["router"].counter("transaction_outgoing_total").total()
            total_opened = opened.count()
        finally:
            p.down()
        # what down() saved (the investigator stops first): the bounce must
        # restore exactly this
        n_examples, trained, params = model.n_examples, model.trained, model.params
        log(tag, f"{' '.join(f'{k}={v}' for k, v in TASK_ENV.items())}: {TASK_ROWS} + "
            f"{TASK_SECOND_ROWS} transactions routed ({routed:.0f}), {first_opened} + "
            f"{total_opened - first_opened} investigations opened; investigator completions "
            f"{by} (+ {self._cli_completed} by the commands); the model trained {trained} "
            f"on {n_examples} human decisions ({len(observed)} observed), auto-closed "
            f"{len(auto)} tasks and pre-filled {len(suggested)}, none of the auto-closed "
            f"observed: {not (auto & observed)}; B1 launches {launched}, router dispatches "
            f"{dispatched} on {self.card}")
        if first_opened < TASK_MIN_TASKS or not (by["approved"] and by["cancelled"]):
            raise AssertionError(f"{tag}: {first_opened} investigations, completions {by}")
        if (not trained or not auto or not suggested or auto & observed
                or n_examples != len(observed)):
            raise AssertionError(f"{tag}: trained {trained}, {len(auto)} auto-closed, "
                                 f"{len(suggested)} pre-filled, {len(auto & observed)} "
                                 f"auto-closed observed, {n_examples} examples for "
                                 f"{len(observed)} human completions")
        others = {k: v for k, v in launched.items() if k != "fused_mlp_bf16" and v}
        if launched["fused_mlp_bf16"] != dispatched or others or not dispatched:
            raise AssertionError(f"{tag}: B1 launches {launched} for {dispatched} router "
                                 "dispatches (the prediction service must not score on B1)")
        # down() saved the model: up() on the same state file restores it
        p = Platform(PlatformSpec.from_cr(cr, cfg=cfg))
        p.up(wait_ready_s=120)
        try:
            m = p.usertask_model
            same = m.trained and m.n_examples == n_examples and all(
                np.array_equal(v, params[k]) for k, v in m.params.items())
        finally:
            p.down()
        if not same:
            raise AssertionError(f"{tag}: the bounce did not restore the user-task model")
        log(tag, f"down() and up() on {os.path.basename(state)}: trained, {n_examples} "
            "examples and the params restored bit for bit")
        return launched["fused_mlp_bf16"]

    def tasks_cli(self, url: str) -> None:
        """(c) ``tasks`` lists the open tasks and completes one; ``investigate``
        works the queue for TASK_INVESTIGATE_S and completes tasks."""
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = REPO
        cmd = [sys.executable, "-m", "ccfd_tpu_torch"]
        out = subprocess.run(cmd + ["tasks", "--engine-url", url], env=env, cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        listed = json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0 else {}
        if not listed.get("count"):
            raise AssertionError(f"tasks (c): `tasks` exited {out.returncode}: {out.stderr[-800:]}")
        # the newest open task: the in-process investigator works from the
        # oldest
        first = max(t["task_id"] for t in listed["tasks"])
        out = subprocess.run(cmd + ["tasks", "--engine-url", url, "--complete", str(first),
                                    "--outcome", "rejected"], env=env, cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        done = json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0 else {}
        # the in-process investigator may take the task first: the engine's
        # error then, and the CLI exits 2
        self._cli_completed = 1
        if out.returncode != 0 or done != {"completed": first, "outcome": "rejected",
                                           "is_fraud": True}:
            raise AssertionError(f"tasks (c): `tasks --complete` exited {out.returncode}: "
                                 f"{out.stdout[-400:]} {out.stderr[-800:]}")
        mport = free_port()
        proc = subprocess.Popen(cmd + ["investigate", "--engine-url", url, "--rate", "50",
                                       "--metrics-port", str(mport), "--seed", str(SEED)],
                                env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        try:
            time.sleep(TASK_INVESTIGATE_S)
            m = scrape(f"http://127.0.0.1:{mport}/prometheus")
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                err = proc.communicate(timeout=30)[1]
            except subprocess.TimeoutExpired:
                proc.kill()
                err = proc.communicate()[1]
        by = {o: m.get(f'investigator_tasks_completed_total{{outcome="{o}"}}', 0.0)
              for o in ("approved", "cancelled")}
        self._cli_completed += int(sum(by.values()))
        if not sum(by.values()) or proc.returncode != 0:
            raise AssertionError(f"tasks (c): `investigate` completed {by}, exit "
                                 f"{proc.returncode}: {err[-800:]}")
        log("tasks", f"(c) `tasks` listed {listed['count']} open tasks and completed task "
            f"{first} as rejected (exit {out.returncode}); `investigate` completed {by} in "
            f"{TASK_INVESTIGATE_S} s against the engine REST")


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
