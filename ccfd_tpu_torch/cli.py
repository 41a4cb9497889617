"""Command-line entry points of the port.

  python -m ccfd_tpu_torch train [--steps 500] [--checkpoint-dir DIR]
                                 [--test-frac F] [--device cuda|cpu]
  python -m ccfd_tpu_torch serve [--device cuda|cpu] [--params PATH]
                                 [--checkpoint-dir DIR] [--gbt-dir DIR]
                                 [--train [--train-steps 300]]
                                 [--host H] [--port N]
  python -m ccfd_tpu_torch score [--input CSV] [--output PATH] [--depth 2]
                                 [--checkpoint-dir DIR] [--quantized-dir DIR]
                                 [--gbt-dir DIR] [--device cuda|cpu]
  python -m ccfd_tpu_torch quantize --out PATH [--params PATH]
                                    [--checkpoint-dir DIR]
                                    [--test-frac F] [--device cuda|cpu]
  python -m ccfd_tpu_torch demo [--transactions N] [--rate R]
                                [--reply-timeout S] [--drain-s S]
                                [--wire-format dict|csv] [--seed N]
                                [--train-steps 200] [--params PATH]
                                [--device cuda|cpu]
  python -m ccfd_tpu_torch bus [--host H] [--port 9092] [--dir D]
  python -m ccfd_tpu_torch engine [--host H] [--port 8090]
                                  [--state-file S [--save-interval-s 5]]
  python -m ccfd_tpu_torch router [--metrics-port 8091] [--workers N]
                                  [--params PATH] [--device cuda|cpu]
  python -m ccfd_tpu_torch notify [--reply-prob P] [--approve-prob P]
                                  [--seed N] [--metrics-port 8080]
  python -m ccfd_tpu_torch producer [--limit N] [--rate R]
                                    [--wire-format dict|csv]
  python -m ccfd_tpu_torch audit [--topic T] [--group G] [--limit N]
                                 [--follow]
  python -m ccfd_tpu_torch audit TX_ID [--url URL] [--dir D] [--json]
                                 [--lifecycle-dir D] [--incident-dir D]
  python -m ccfd_tpu_torch lifecycle [--dir D] [--audit] [--version N] [--json]
  python -m ccfd_tpu_torch replay [--dir D] [--since-seq N] [--until-seq N]
                                  [--from-incident BUNDLE.json]
                                  [--what-if-threshold T | --live [--cr CR]
                                   [--device cuda|cpu]] [--state-dir D]
                                  [--window-id W] [--no-resume] [--json]
  python -m ccfd_tpu_torch analyze [--nbins 32] [--top-corr 8] [--drift-split]
                                   [--device cuda|cpu]
  python -m ccfd_tpu_torch investigate [--engine-url URL] [--rate 50]
                                       [--trust 0.9] [--fraud-rate 0.05]
                                       [--seed N] [--metrics-port 8082]
  python -m ccfd_tpu_torch tasks [--engine-url URL] [--status open]
                                 [--complete TASK_ID --outcome approved|rejected]
  python -m ccfd_tpu_torch up [-f CR.yaml] [--exit-after-producer]
                              [--drain-s 120] [--device cuda|cpu]
  python -m ccfd_tpu_torch manifests [-f CR.yaml] --out DIR
  python -m ccfd_tpu_torch store serve|put|ls [--root D] [--host H]
                                 [--port 9000] [--endpoint URL] [--file F]
  python -m ccfd_tpu_torch loadgen [--url URL] [--clients 8] [--rows 16]
                                   [--seconds 10] [--path P]
  python -m ccfd_tpu_torch doctor [--probe-s 30] [--device cuda|cpu]
                                  [--checkpoint-dir D] [--quantized-dir D]

``train`` is the reference's ``cmd_train`` for the MLP family: the dataset
of ``training_dataset`` (the CSV at CCFD_CSV, else the Kaggle-shaped
surrogate; CCFD_SURROGATE_ROWS shrinks it), a held-out split from
``default_rng(0)``, ``fit_mlp`` in float32 on ``--device`` (the card by
default), the held-out ``auc_mlp``, and a ``CheckpointManager`` step at
``--steps`` in ``--checkpoint-dir``. It prints the reference's JSON keys;
``auc_sklearn_logreg`` is null, as the reference prints it without
scikit-learn (the port does not import it). ``--family hgb`` exits 2 with
the reference's message for a missing scikit-learn (the port fits no tree
ensemble: ``checkpoints_gbt/params.npz`` is the reference's ``train
--family hgb`` output), and ``--from-store`` (training on the store, A14b) is
refused by name.

``serve`` is the Seldon-contract REST scorer of the reference's
``python -m ccfd_tpu serve``, on the card unless ``--device cpu`` is given.
It serves ``--params`` (an ``.npz``) when given; with ``--train``, an MLP
``fit_mlp`` trains for ``--train-steps`` on ``load_dataset()`` first, as the
reference's does; otherwise, for the MLP, the newest ``train`` step in
``--checkpoint-dir``; without one, the committed checkpoint
(``assets/mlp_step_1200.npz``, the reference's ``checkpoints/step_1200``).
The knobs of ``config.Config`` come from the environment (CCFD_MODEL,
CCFD_DTYPE, CCFD_BATCH_SIZES, CCFD_Q8_WIRE, ...). It answers through the C++
REST front (``serving/native_front.py``) unless CCFD_NATIVE_FRONT=0 selects
the Python server; its start-up line names the payload decoder and the
transport. With ``CCFD_MODEL=mlp_q8`` it serves int8 params: those of a q8
``.npz`` (``quantize``'s output), or ``quantize_mlp`` of an f32 one, which
for the committed checkpoint equals the reference's
``checkpoints_q8/step_1200``.

The model is any registered one (``CCFD_MODEL``: ``mlp``, ``mlp_q8``,
``logreg``, ``modelfull``, ``gbt``, ``gbt_mxu``). ``CCFD_GRAPH_CR`` names a
SeldonDeployment-shaped CR (``deploy/model/graph_ensemble.json``) that
``serve`` and ``score`` load and serve in its place, as the reference's do
(``serving/graph.py``); ``serve --train`` with a graph exits 2. Params, by
model (``served_params``): the MLP family as above; ``gbt`` the newest
``train --family hgb`` artifact in ``--gbt-dir`` (default
``./checkpoints_gbt``), else the registry's empty ensemble; ``logreg``,
``modelfull``, ``gbt_mxu`` and graphs their seeded init, as the reference
serves them with ``params=None``.

``score`` is the reference's ``cmd_score``: offline bulk scoring, the rows
of ``--input`` (else CCFD_CSV, else the synthetic stream) through
``Scorer.score_pipelined`` with ``--depth`` dispatches in flight, the
probabilities written to ``--output`` as the reference's CSV, and its JSON
line (``rows``, ``seconds``, ``tx_s``, ``flagged_fraud``,
``fraud_threshold``, ``mean_proba``, ``output``, ``checkpoint``). It reads
the model and its params as ``serve`` does; for ``mlp_q8``,
``--quantized-dir`` names a directory of int8 checkpoint steps in the npz
form.

Deviations in where params come from. The default ``--checkpoint-dir`` of
``train``, ``serve`` and ``quantize`` is ``./checkpoints_torch``, where the
reference's is ``./checkpoints``: that directory holds the reference's
orbax steps, which the port does not read (``parallel/checkpoint.py``
reads and writes the reference's npz form). Where the reference's ``serve``
without a ``train`` step serves ``PRNGKey(0)`` params, the port serves the
committed checkpoint. The port's ``fit_mlp`` draws its init from a seeded
``torch.Generator`` (``parallel/train.py``), so its trained params differ
from the reference's, drawn from the same distribution.

``quantize`` is the reference's ``cmd_quantize``: f32 params in (``--params``,
else the newest step in ``--checkpoint-dir``, else the committed
checkpoint), a q8 ``.npz`` out, and one JSON line of evidence that
quantization kept the model's quality: the f32-to-int8 delta (AUC and
probability) on a seeded sample of the training dataset. The f32 side runs
the served ``mlp`` graph on ``--device`` (the card by default), the int8
side the host-tier forward, as the reference does.

``demo`` is the reference's ``python -m ccfd_tpu demo``: the decision
pipeline in one process, producer -> bus -> router -> Scorer -> rules ->
process engine -> notification service (``build_pipeline``), with the
online trainer beside the router. Without ``--params`` it does what the
reference's does: ``load_dataset(n_synthetic=max(transactions, 4000))``
(the CSV at CCFD_CSV instead), ``fit_mlp`` for ``--train-steps`` in float32
on the card, then serves the result; with ``--params`` it serves that file
on the Kaggle-shaped surrogate's rows. Either way an ``OnlineTrainer``
(``TrainConfig()``: bf16) trains on the labels of resolved fraud cases
every 0.5 s and hot-swaps its params into the Scorer (CCFD_RETRAIN_BATCH,
CCFD_RETRAIN_MIN_LABELS); the summary counts them in ``retrain_swaps``.
The int8 model's params are not trainable, so under ``CCFD_MODEL=mlp_q8``
the demo serves the quantized params without a trainer (the reference's
demo serves only the MLP). ``backend`` names the torch device.
CCFD_FUSED_DECISION=1 wires the decision plane (serving/fused.py) into the
router, as the reference's operator does; every swap then runs the plane's
prepublish grid. The demo runs its own in-process bus, durable under
CCFD_BUS_DIR and retained under CCFD_BUS_RETENTION_*, and its engine
streams audit events under CCFD_AUDIT_TOPIC, as the reference's does.

``bus``, ``engine``, ``router``, ``notify`` and ``producer`` are the
reference's service roles, each its own process, wired by the reference's
environment: ``BROKER_URL=http://host:port`` (the ``bus`` role; anything
else is an in-process bus), ``KIE_SERVER_URL=http://host:port`` (the
``engine`` role, which the router requires) and, for the router's scorer,
``SELDON_URL`` (an http:// URL: a ``serve`` process over the Seldon REST
contract; anything else: a local ``Scorer`` on ``--device``, the card by
default). ``BROKER_URL=kafka://bootstrap:9092`` puts every role on a Kafka
cluster through ``bus/kafka_adapter.py`` (it needs kafka-python, and
raises the reference's error when it is absent); an in-process bus is
durable under CCFD_BUS_DIR (CCFD_BUS_FSYNC fsyncs every append) and
retained under CCFD_BUS_RETENTION_RECORDS/_OVERRIDES, as the reference's.

``bus --dir D`` keeps the bus's topics, records and committed group
offsets in a segment log under D (``bus/log.py``), byte for byte the
reference's, so a bus SIGKILLed and restarted on D serves the same offsets.
``engine --state-file S`` loads S at start when it exists (a corrupt file
is quarantined and the newest retained generation that verifies loads),
saves it every ``--save-interval-s`` and on SIGTERM or SIGINT, and prints
the load and the last save with their times and sizes. With
CCFD_AUDIT_TOPIC the engine streams its audit events onto that topic,
keyed by pid, and ``audit`` tails them (one JSON event a line; ``--follow``
keeps consuming). ``audit <tx_id>`` reconstructs one decision of the
provenance plane (observability/audit.py): from a live exporter with
``--url``, else offline, read-only, from the audit segments under ``--dir``
(CCFD_AUDIT_DIR); the lineage join reads the model lifecycle's version
store (``--lifecycle-dir``, CCFD_LIFECYCLE_DIR) with the hash parity of the
decision's champion, and the incident join the bundle open when it was
made (``--incident-dir``, CCFD_INCIDENT_DIR, or the exporter's
``/incidents/<id>``). ``lifecycle`` prints that store's lineage and audit trail;
``replay`` summarizes a recorded window of the audit segments, backtests a
threshold on it host-side (``--what-if-threshold``) or re-drives it through
a live platform on the card (``--live``); ``analyze`` summarizes the
dataset on the card (``analytics/engine.py``). CCFD_FAULTS arms the router role's standing
fault plan (``runtime/faults.py``): a ``scorer`` injector around the
``SeldonClient`` or the local score function, an ``engine`` injector around
``start_process``, ``start_process_batch`` and ``signal``, counted in
``faults_injected_total{edge,kind}``.

The router role is the production wiring: the degradation ladder on (its
host tier the local Scorer's numpy forward; on SELDON_URL there is none,
as in the reference, and a failed edge falls to the rules tier), overload
control on (CCFD_OVERLOAD), tracing at CCFD_TRACE_SAMPLE, and a
``ParallelRouter`` when CCFD_ROUTER_WORKERS (or ``--workers``) is not 1;
its metrics and traces are served on ``--metrics-port`` (/prometheus,
/traces), as notify's are. The router decodes the CSV wire with the native
decoder (``native.decode_csv``). Knobs that select an unported part
(``Config.unported``) are refused by name, by ``serve`` as by the roles.

The router role scores ``CCFD_MODEL`` with what ``serve`` would serve for
it (where the reference's role serves the seeded init of every model) and
does not load ``CCFD_GRAPH_CR``, as the reference's role does not.

``up`` is the reference's operator entry (``platform/operator.py``): the
platform CR (default: the port's, ``ccfd_tpu_torch/assets/platform_cr.yaml``,
which is the reference's ``deploy/platform_cr.yaml`` with the blocks the
port does not have switched off) brought up in the reference's run-book
order, the scorer on the card unless ``--device cpu``. A CR that leaves a
component the port does not have on is refused with one error naming each
and the ROADMAP item that ports it. With ``--exit-after-producer`` it waits
(within ``--drain-s``) for the producer to finish and the router to
dispose of every produced row, then 2 s for timers and signals, prints every
registry (after a scrape-time refresh), the stage profile and the device
snapshot, and exits 0; without it, it serves until SIGTERM or SIGINT. Its
ready line names the served model, device, kernel and the params' sha256
(``params.digest``).
``manifests`` writes the reference's k8s documents for the port
(``platform/k8s.py``: the port's command, image and ``nvidia.com/gpu``).
``store`` is the reference's object-store command: ``serve`` the S3-shaped
store, ``put`` the dataset (or ``--file``) as ``filename`` in ``s3bucket``,
``ls`` the bucket; the producer reads from it when ``s3endpoint`` is set.
``loadgen`` drives a running ``serve`` (or any Seldon-contract endpoint)
with subprocess raw-socket clients (``utils/loadgen.py``) and prints one
JSON report; it exits 3 on any error. ``doctor`` prints one JSON health
report: the device probed in a subprocess under ``--probe-s`` (a wedged
card times out instead of hanging it), the kernel libraries built and
current for their sources, the toolchain, the bus and store, the
checkpoints and the environment in effect; it exits 3 unless the device
answered.

``investigate`` and ``tasks`` are the reference's investigator commands
over the engine's KIE-shaped REST contract (``--engine-url``, else
KIE_SERVER_URL): ``investigate`` runs the seeded, rate-limited
``InvestigatorService`` (``process/investigator.py``) against the open-task
queue and serves its counters on ``--metrics-port``; ``tasks`` prints the
tasks of ``--status`` as one JSON line, and ``--complete ID --outcome
approved|rejected`` completes one (approved = legitimate, rejected =
fraud), the human decision the user-task model learns from.

``demo``, ``serve``, ``up`` and the ``bus``, ``engine``, ``router`` and ``notify``
roles raise Python's gen-0 GC threshold before their hot loops start, as
the reference does (``utils/gctune.py``; CCFD_GC_THRESHOLD=0 opts out), and
their start-up lines print it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any

from ccfd_tpu_torch.config import Config


DEFAULT_CHECKPOINT_DIR = "./checkpoints_torch"
GBT_DIR = "./checkpoints_gbt"  # the reference's `train --family hgb` writes here
MLP_FAMILY = ("mlp", "mlp_q8")
RETRAIN_INTERVAL_S = 0.5  # the demo's OnlineTrainer poll, as the reference's


def build_server(cfg: Config, device: str | None = None,
                 params_path: str | None = None, checkpoint_dir: str | None = None,
                 params: Any = None, gbt_dir: str | None = None):
    """The warmed-up ``PredictionServer`` that ``serve`` runs (not yet
    listening): a ``Scorer`` on ``device`` (default: the card) for the
    config's model, or the CCFD_GRAPH_CR graph (``with_graph``), serving
    ``params`` when given, else ``served_params(cfg, params_path,
    checkpoint_dir, gbt_dir)``. Raises ``NotImplementedError`` naming any
    knob set to an unported part."""
    from ccfd_tpu_torch.serving.server import PredictionServer

    _refuse_unported(cfg, "serve")
    cfg = with_graph(cfg)
    if params is None:
        params = served_params(cfg, params_path, checkpoint_dir, gbt_dir)
    return PredictionServer(make_scorer(cfg, params, device), cfg)


def with_graph(cfg: Config) -> Config:
    """``cfg`` with CCFD_GRAPH_CR's graph loaded, registered and in place of
    CCFD_MODEL, as the reference's ``serve`` and ``score`` do; ``cfg`` as
    it is when no CR is set."""
    if not cfg.graph_cr:
        return cfg
    from ccfd_tpu_torch.serving.graph import load_graph_cr

    return dataclasses.replace(cfg, model_name=load_graph_cr(cfg.graph_cr).name)


def make_scorer(cfg: Config, params: Any, device: Any = None):
    """A warmed-up ``Scorer`` on ``device`` (default: the card) with the
    config's model, buckets, wire and dispatch deadline (off unless the
    environment sets it)."""
    from ccfd_tpu_torch.device import resolve
    from ccfd_tpu_torch.serving.scorer import Scorer

    dev = resolve(device)
    scorer = Scorer(model_name=cfg.model_name, params=params, batch_sizes=cfg.batch_sizes,
                    compute_dtype=cfg.compute_dtype, device=dev, q8_wire=cfg.q8_wire,
                    dispatch_deadline_ms=cfg.scorer_dispatch_deadline_ms(dev.type == "cuda"))
    scorer.warmup()
    return scorer


def served_params(cfg: Config, params_path: str | None = None,
                  checkpoint_dir: str | None = None, gbt_dir: str | None = None,
                  quantized_dir: str | None = None) -> dict | None:
    """The params ``serve``, ``score``, the router role and ``demo
    --params`` serve for the config's model:

    - ``mlp`` and ``mlp_q8``: ``params_path`` when given; else for the MLP
      the newest step in ``checkpoint_dir``, for ``mlp_q8`` the newest step
      in ``quantized_dir``, when it holds one; else the committed
      checkpoint. Quantized when the model is ``mlp_q8`` and they are f32.
    - ``gbt``: the newest ``train --family hgb`` artifact in ``gbt_dir``
      (default ``./checkpoints_gbt``), None when there is none;
    - any other model (``logreg``, ``modelfull``, ``gbt_mxu``, a graph):
      None.

    None means the Scorer's seeded init (the registry's), as the reference
    passes ``params=None``. ``params_path`` holds MLP params: for another
    model it raises ``ValueError``."""
    from ccfd_tpu_torch.params import DEFAULT_PARAMS, load_params

    if cfg.model_name not in MLP_FAMILY:
        if params_path:
            raise ValueError(f"--params holds MLP or int8 MLP params, not params of "
                             f"CCFD_MODEL={cfg.model_name!r}")
        return restore_gbt_params(gbt_dir) if cfg.model_name == "gbt" else None
    from ccfd_tpu_torch.params import MLP_LIKE, Q8_LIKE

    params = None
    if params_path:
        params = load_params(params_path)
    else:
        restored = (restore_checkpoint(checkpoint_dir, MLP_LIKE) if cfg.model_name == "mlp"
                    else restore_checkpoint(quantized_dir, Q8_LIKE))
        params = restored[0] if restored is not None else None
    return for_model(cfg, load_params(DEFAULT_PARAMS) if params is None else params)


def for_model(cfg: Config, params: Any) -> Any:
    """``params`` as the configured model takes them: f32 MLP params are
    quantized for ``mlp_q8``."""
    from ccfd_tpu_torch.ops import quant

    if cfg.model_name == "mlp_q8" and not quant.is_quantized(params):
        return quant.quantize_mlp(params)
    return params


def restore_checkpoint(checkpoint_dir: str | None, like: dict) -> tuple[dict, int] | None:
    """(params, step): the newest step in ``checkpoint_dir`` as params
    structured like ``like`` (``params.MLP_LIKE`` for a ``train`` step,
    ``Q8_LIKE`` for int8 ones; CPU tensors); None when the directory does
    not exist or holds no step. Creates no directory."""
    from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager

    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    mgr = CheckpointManager(checkpoint_dir)
    if mgr.latest_step() is None:
        return None
    params, step = mgr.restore(like)
    print(f"[checkpoint] restored step={step} from {checkpoint_dir}", file=sys.stderr)
    return params, step


def restore_gbt_params(gbt_dir: str | None) -> dict | None:
    """The ``train --family hgb`` artifact (``<gbt_dir>/params.npz``, default
    ``./checkpoints_gbt``) as gbt params, through the verified read (a
    corrupt file is quarantined and the newest retained generation that
    verifies is read); None when there is none or none is readable, as the
    reference's ``_restore_gbt_params``."""
    import io
    import zipfile

    import numpy as np
    import torch

    from ccfd_tpu_torch.runtime.durability import CorruptArtifactError, read_artifact

    path = os.path.join(gbt_dir or GBT_DIR, "params.npz")
    try:
        raw = read_artifact(path, artifact="gbt_params")
        with np.load(io.BytesIO(raw)) as z:
            params = {k: torch.from_numpy(z[k])
                      for k in ("feature", "threshold", "leaf", "base")}
    except FileNotFoundError:
        return None
    except (OSError, ValueError, KeyError, zipfile.BadZipFile, CorruptArtifactError) as e:
        print(f"[checkpoint] unreadable gbt params at {path} ({e!r}); "
              "serving fresh init", file=sys.stderr)
        return None
    print(f"[checkpoint] restored gbt params from {path}", file=sys.stderr)
    return params


def train_mlp(X: Any, y: Any, steps: int, device: Any = None) -> dict:
    """``fit_mlp`` in float32 on ``device`` (default: the card): how the
    reference's ``train``, ``serve --train`` and ``demo`` train."""
    from ccfd_tpu_torch.parallel.train import TrainConfig, fit_mlp

    return fit_mlp(X, y, steps=steps, tc=TrainConfig(compute_dtype="float32"), device=device)


@dataclasses.dataclass
class Pipeline:
    """The decision pipeline ``build_pipeline`` wires, with its registries
    and, when armed, the decision plane (``decision``)."""

    cfg: Config
    broker: Any
    scorer: Any
    engine: Any
    router: Any
    notify: Any
    producer: Any
    decision: Any
    reg_router: Any
    reg_kie: Any
    reg_notify: Any
    trainer: Any = None
    reg_retrain: Any = None
    _threads: list = dataclasses.field(default_factory=list)

    def start(self, poll_timeout_s: float = 0.02) -> None:
        """The router's pipelined loop, the notification service and, when
        there is one, the online trainer (every RETRAIN_INTERVAL_S while it
        has no new labels, as the reference's demo), each on its own
        thread."""
        self._threads = [self.router.start(poll_timeout_s=poll_timeout_s),
                         self.notify.start(poll_timeout_s=poll_timeout_s)]
        if self.trainer is not None:
            self._threads.append(self.trainer.start(interval_s=RETRAIN_INTERVAL_S))

    def stop(self, timeout_s: float = 30.0) -> None:
        """Stop every loop and wait for them (the router routes the batch it
        has in flight first; the trainer finishes its round)."""
        self.router.stop()
        self.notify.stop()
        if self.trainer is not None:
            self.trainer.stop()
        for t in self._threads:
            t.join(timeout=timeout_s)
        alive = [t.name for t in self._threads if t.is_alive()]
        self._threads = []
        if alive:
            raise RuntimeError(f"pipeline threads did not stop: {alive}")

    def summary(self) -> dict:
        """The reference demo's summary counters."""
        rr, kie = self.reg_router, self.reg_kie
        out = rr.counter("transaction_outgoing_total")
        return {
            "transactions": int(rr.counter("transaction_incoming_total").value()),
            "fraud_routed": int(out.value({"type": "fraud"})),
            "standard_routed": int(out.value({"type": "standard"})),
            "notifications": int(rr.counter("notifications_outgoing_total").value()),
            "approved_amount_n": kie.histogram("fraud_approved_amount").count(),
            "rejected_amount_n": kie.histogram("fraud_rejected_amount").count(),
            "low_amount_auto_n": kie.histogram("fraud_approved_low_amount").count(),
            "investigations_n": kie.histogram("fraud_investigation_amount").count(),
            "open_tasks": len(self.engine.tasks()),
            "retrain_swaps": int(self.reg_retrain.counter("retrain_param_swaps_total").value())
            if self.reg_retrain is not None else 0,
        }


def build_pipeline(cfg: Config, dataset: Any = None, device: str | None = None,
                   params: Any = None, clock: Any = None, seed: int = 0) -> Pipeline:
    """The decision pipeline, not yet started: an in-process ``Broker``
    (``local_broker``: durable under CCFD_BUS_DIR), the
    three registries, a warmed-up ``Scorer`` on ``device`` (default: the
    card) serving ``params`` (default: ``served_params(cfg)``), the engine
    with the fraud and standard processes and a ``ScorerPredictionService``
    over the same scorer, the ``Router`` (the rules of CCFD_RULES, else
    the FRAUD_THRESHOLD rule; the decision plane when CCFD_FUSED_DECISION
    is set), the seeded ``NotificationService`` and a ``Producer`` over
    ``dataset``. ``clock`` (default: wall clock) drives the engine's
    timers. No online trainer (``build_demo`` adds one). Raises
    ``NotImplementedError`` naming any knob set to a part of the reference
    this port does not have yet."""
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.notify.service import NotificationService
    from ccfd_tpu_torch.process.fraud import build_engine
    from ccfd_tpu_torch.process.prediction import ScorerPredictionService
    from ccfd_tpu_torch.producer.producer import Producer
    from ccfd_tpu_torch.router.router import Router
    from ccfd_tpu_torch.router.rules import RuleSet, default_rules
    from ccfd_tpu_torch.serving.fused import FusedDecisionScorer

    _refuse_unported(cfg, "the pipeline")
    broker = local_broker(cfg)
    reg_router, reg_kie, reg_notify = Registry(), Registry(), Registry()
    scorer = make_scorer(cfg, served_params(cfg) if params is None else params, device)
    engine = build_engine(cfg, broker, reg_kie, clock=clock,
                          prediction_service=ScorerPredictionService(scorer.score))
    # one RuleSet instance for the plane and the router (the router
    # disarms a plane compiled from another)
    rules = (RuleSet.from_file(cfg.rules_file) if cfg.rules_file
             else default_rules(cfg.fraud_threshold))
    decision = None
    if cfg.fused_decision:
        fds = FusedDecisionScorer(scorer, rules, registry=reg_router,
                                  strict=cfg.fused_decision_strict)
        if fds.enabled:  # refused: the warning said why; staged
            fds.warmup()
            scorer.add_prepublish_hook(fds.prepublish)
            decision = fds
    router = Router(cfg, broker, scorer.score, engine, reg_router, rules=rules,
                    decision_fn=decision)
    notify = NotificationService(cfg, broker, reg_notify, seed=seed)
    producer = Producer(cfg, broker, dataset)
    return Pipeline(cfg=cfg, broker=broker, scorer=scorer, engine=engine,
                    router=router, notify=notify, producer=producer,
                    decision=decision, reg_router=reg_router, reg_kie=reg_kie,
                    reg_notify=reg_notify)


def run_demo(pipe: Pipeline, transactions: int, rate: float | None = None,
             wire_format: str = "dict", drain_s: float = 30.0) -> float:
    """The reference demo's run: start the loops, produce ``transactions``
    rows, wait until the router has consumed them all (at most
    ``drain_s``), then one reply timeout and a second more so the engine's
    timers fire; stop. Returns the wall time in seconds."""
    pipe.start(poll_timeout_s=0.02)
    try:
        t0 = time.perf_counter()
        pipe.producer.run(limit=transactions, rate_per_s=rate, wire_format=wire_format)
        incoming = pipe.reg_router.counter("transaction_incoming_total")
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline and incoming.value() < transactions:
            time.sleep(0.1)
        time.sleep(pipe.cfg.customer_reply_timeout_s + 1.0)
        return time.perf_counter() - t0
    finally:
        pipe.stop()


def demo_dataset(transactions: int):
    """The transactions ``demo --params`` serves: the CSV at CCFD_CSV, else
    the Kaggle-shaped surrogate the committed checkpoint was trained on."""
    from ccfd_tpu_torch.data.ccfd import load_dataset
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

    if os.environ.get("CCFD_CSV"):
        return load_dataset()
    return kaggle_surrogate(n=max(transactions, 4000))


def build_demo(cfg: Config, transactions: int, train_steps: int = 200,
               params_path: str | None = None, device: str | None = None,
               seed: int = 0) -> Pipeline:
    """What ``demo`` runs, not yet started: with ``params_path``, that file
    on ``demo_dataset``'s rows; else, as the reference's demo,
    ``train_mlp`` for ``train_steps`` on ``load_dataset(n_synthetic=
    max(transactions, 4000))`` on ``device`` (default: the card), served on
    the same rows. Then ``build_pipeline`` and, for the MLP, an
    ``OnlineTrainer`` (``TrainConfig()``) over clones of the Scorer's params
    that publishes into it (``Pipeline.trainer``; the int8 model's params
    are not trainable, so ``mlp_q8`` has none)."""
    from ccfd_tpu_torch.data.ccfd import load_dataset
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.parallel.online import OnlineTrainer

    _refuse_unported(cfg, "the pipeline")  # before the training, not after
    if not params_path and cfg.model_name not in MLP_FAMILY:
        raise ValueError(f"demo trains the MLP; CCFD_MODEL={cfg.model_name!r} params would "
                         "not match: set CCFD_MODEL=mlp or mlp_q8, or pass --params")
    if params_path:
        ds = demo_dataset(transactions)
        params = served_params(cfg, params_path)
        print(f"[demo] dataset: {ds.n} rows; serving {params_path}", file=sys.stderr)
    else:
        ds = load_dataset(n_synthetic=max(transactions, 4000))
        print(f"[demo] dataset: {ds.n} rows; training flagship MLP...", file=sys.stderr)
        params = for_model(cfg, train_mlp(ds.X, ds.y, train_steps, device))
    pipe = build_pipeline(cfg, ds, device=device, seed=seed, params=params)
    if pipe.scorer.spec.name == "mlp":
        pipe.reg_retrain = Registry()
        pipe.trainer = OnlineTrainer(cfg, pipe.broker, pipe.scorer, pipe.scorer.params,
                                     registry=pipe.reg_retrain)
    return pipe


def cmd_demo(args: argparse.Namespace) -> int:
    cfg = dataclasses.replace(Config.from_env(), customer_reply_timeout_s=args.reply_timeout)
    pipe = build_demo(cfg, args.transactions, args.train_steps, args.params, args.device,
                      args.seed)
    _tune_gc()  # before the hot loops start
    elapsed = run_demo(pipe, args.transactions, rate=args.rate,
                       wire_format=args.wire_format, drain_s=args.drain_s)
    summary = pipe.summary()
    summary.update(wall_s=round(elapsed, 2), backend=str(pipe.scorer.device))
    print(json.dumps(summary))
    return 0


def _refuse_unported(cfg: Config, what: str = "this role") -> None:
    unported = cfg.unported()
    if unported:
        raise NotImplementedError(
            f"not ported yet, unset to run {what}: " + "; ".join(unported))


def _tune_gc() -> int:
    """The reference's service GC tuning (utils/gctune.py); returns the
    gen-0 threshold now in force, for the start-up line."""
    import gc

    from ccfd_tpu_torch.utils.gctune import tune_for_service

    tune_for_service()
    return gc.get_threshold()[0]


def _tracing_for(cfg: Config, registry, component: str):
    """(tracer, sink) for a role, or (None, None) when CCFD_TRACE_SAMPLE=0.
    The tracer lands spans in the role's scraped registry; the sink's own
    sampler metrics live in a "tracing" registry the role also exports."""
    if cfg.trace_sample <= 0:
        return None, None
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.observability.trace import SpanSink, Tracer

    sink = SpanSink(sample=cfg.trace_sample, slow_s=cfg.trace_slow_ms / 1e3,
                    registry=Registry())
    return Tracer(registry, component=component, sink=sink), sink


def local_broker(cfg: Config, log_dir: str | None = None):
    """An in-process Broker as the config asks for it: durable in
    ``log_dir`` (default CCFD_BUS_DIR; none: in memory), fsync per append
    under CCFD_BUS_FSYNC, retention under CCFD_BUS_RETENTION_*."""
    from ccfd_tpu_torch.bus.broker import Broker

    return Broker(log_dir=log_dir or cfg.bus_log_dir or None, fsync=cfg.bus_fsync,
                  retention_records=cfg.bus_retention_records or None,
                  retention_overrides=cfg.parsed_retention_overrides())


def _broker_for(cfg: Config, registry=None):
    """BROKER_URL decides the transport: http:// -> a RemoteBroker against a
    ``bus`` process; kafka:// -> the Kafka adapter (its produce counters
    into ``registry`` when given); anything else -> ``local_broker``."""
    from ccfd_tpu_torch.bus.client import broker_from_url

    kwargs = ({"registry": registry}
              if registry is not None and cfg.broker_url.startswith("kafka://") else {})
    remote = broker_from_url(cfg.broker_url, **kwargs)
    return remote if remote is not None else local_broker(cfg)


def _sigterm_as_interrupt() -> None:
    """SIGTERM ends a role as SIGINT does (KeyboardInterrupt), so it stops
    its servers on either."""
    import signal

    def interrupt(signum, frame):  # noqa: ARG001
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, interrupt)


def _serve_forever() -> None:
    _sigterm_as_interrupt()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def cmd_bus(args: argparse.Namespace) -> int:
    """The networked bus (the reference's Kafka-cluster role), durable when
    --dir (or CCFD_BUS_DIR) is given."""
    from ccfd_tpu_torch.bus.server import BrokerServer
    from ccfd_tpu_torch.metrics.prom import Registry

    cfg = Config.from_env()
    _refuse_unported(cfg)
    log_dir = args.dir or cfg.bus_log_dir or None
    t0 = time.perf_counter()
    broker = local_broker(cfg, log_dir)
    opened_ms = (time.perf_counter() - t0) * 1e3
    registry = Registry()
    tracer, _sink = _tracing_for(cfg, registry, "bus")
    srv = BrokerServer(broker, registry=registry, tracer=tracer)
    port = srv.start(args.host, args.port)
    where = (f"durable: {log_dir}, fsync={'on' if cfg.bus_fsync else 'off'}, "
             f"opened and replayed in {opened_ms:.3f} ms" if log_dir else "memory")
    print(f"[bus] listening on {args.host}:{port} ({where}) gc_threshold={_tune_gc()}",
          file=sys.stderr, flush=True)
    _serve_forever()
    srv.stop()
    broker.close()
    return 0


def cmd_engine(args: argparse.Namespace) -> int:
    """The KIE-shaped engine server (the reference's ccd-service on :8090),
    persistent with --state-file: loaded at start, saved every
    --save-interval-s and on SIGTERM or SIGINT."""
    from ccfd_tpu_torch.process.fraud import build_engine
    from ccfd_tpu_torch.process.server import EngineServer

    cfg = Config.from_env()
    _refuse_unported(cfg)
    engine = build_engine(cfg, _broker_for(cfg))
    state = args.state_file
    if state and os.path.exists(state):
        t0 = time.perf_counter()
        engine.load(state)
        print(f"[engine] loaded {state} in {(time.perf_counter() - t0) * 1e3:.3f} ms: "
              f"{len(engine.instances('active'))} active instances, "
              f"{len(engine.tasks())} open tasks", file=sys.stderr, flush=True)
    tracer, _sink = _tracing_for(cfg, engine.registry, "kie")
    srv = EngineServer(engine, tracer=tracer)
    port = srv.start(args.host, args.port)
    print(f"[engine] KIE REST on {args.host}:{port} "
          f"definitions={list(engine.definitions())} gc_threshold={_tune_gc()}"
          + (f" state_file={state}" if state else ""), file=sys.stderr, flush=True)
    _sigterm_as_interrupt()
    try:
        while True:
            time.sleep(args.save_interval_s if state else 3600)
            if state:
                engine.save(state)
    except KeyboardInterrupt:
        if state:
            t0 = time.perf_counter()
            engine.save(state)
            print(f"[engine] saved {state} ({os.path.getsize(state)} bytes) in "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms", file=sys.stderr, flush=True)
    srv.stop()
    return 0


def build_router(cfg: Config, device: str | None = None, params_path: str | None = None,
                 workers: int | None = None):
    """What the ``router`` role runs, not yet started: (router, registry,
    trace sink, exporter collectors). The bus from BROKER_URL, the engine
    REST client on KIE_SERVER_URL, the scorer (a ``SeldonClient`` when
    SELDON_URL is http://, else a warmed ``Scorer`` on ``device``), the
    ladder's host tier (the local Scorer's numpy forward; none on
    SELDON_URL, as in the reference, so a failed edge falls to the rules
    tier), CCFD_FAULTS's ``scorer`` and ``engine`` injectors around those
    edges, ``OverloadControl`` when CCFD_OVERLOAD is on, the tracer, and a
    single ``Router`` for one worker, else a ``ParallelRouter``."""
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.process.client import EngineRestClient
    from ccfd_tpu_torch.router.router import Router

    _refuse_unported(cfg)
    registry = Registry()
    broker = _broker_for(cfg, registry)
    tracer, sink = _tracing_for(cfg, registry, "router")
    fault_plan = None
    if cfg.faults_spec:
        from ccfd_tpu_torch.runtime.faults import FaultPlan

        fault_plan = FaultPlan.from_string(cfg.faults_spec)
    scorer_faults = fault_plan.injector("scorer", registry) if fault_plan else None
    collectors = []
    if cfg.seldon_url.startswith("http"):
        from ccfd_tpu_torch.serving.client import SeldonClient

        score_fn = SeldonClient(cfg, faults=scorer_faults, tracer=tracer).score
        host_score_fn = None  # the ladder falls from the remote edge to rules
        on_card = False
    else:
        from ccfd_tpu_torch.serving.server import DeadlineCounters, publish_launches

        scorer = make_scorer(cfg, served_params(cfg, params_path), device)
        score_fn = scorer.score
        if scorer_faults is not None:
            score_fn = scorer_faults.wrap_fn(score_fn)
        host_score_fn = scorer.host_score if scorer.has_host_forward else None
        on_card = scorer.device.type == "cuda"
        g_launches = registry.gauge(
            "ccfd_kernel_launches", "CUDA kernel launches in this process")
        g_dispatches = registry.gauge(
            "ccfd_scorer_dispatches", "the Scorer's bucket dispatches in this process")
        deadline = DeadlineCounters(registry, scorer)

        def publish() -> None:
            publish_launches(g_launches)
            g_dispatches.set(scorer.dispatch_total())
            deadline.sync()
        collectors.append(publish)
    engine = EngineRestClient(cfg.kie_server_url, timeout_s=cfg.seldon_timeout_ms / 1000.0,
                              retries=cfg.client_retries, tracer=tracer)
    engine_faults = fault_plan.injector("engine", registry) if fault_plan else None
    if engine_faults is not None:
        engine = engine_faults.wrap(
            engine, methods=("start_process", "start_process_batch", "signal"))
    workers = cfg.router_workers if workers is None else workers
    overload = None
    if cfg.overload_enabled:
        from ccfd_tpu_torch.runtime.overload import OverloadControl

        n_eff = workers if workers > 0 else max(1, len(broker.end_offsets(cfg.kafka_topic)))
        overload = OverloadControl.from_config(cfg, registry, max_batch=4096,
                                               workers=n_eff, on_card=on_card)
    if workers == 1:
        router = Router(cfg, broker, score_fn, engine, registry=registry,
                        host_score_fn=host_score_fn, degrade=True, tracer=tracer,
                        overload=overload)
    else:
        from ccfd_tpu_torch.router.parallel import ParallelRouter

        router = ParallelRouter(cfg, broker, score_fn, engine, registry=registry,
                                workers=workers, host_score_fn=host_score_fn,
                                degrade=True, tracer=tracer, coalesce=cfg.router_coalesce,
                                overload=overload)
    return router, registry, sink, collectors


def cmd_router(args: argparse.Namespace) -> int:
    """The decision router (the reference's ccd-fuse): remote bus, remote or
    local scorer, remote engine; metrics on --metrics-port."""
    from ccfd_tpu_torch.metrics.exporter import MetricsExporter

    cfg = Config.from_env()
    if not cfg.kie_server_url.startswith("http"):
        print("[router] the router role needs KIE_SERVER_URL=http://... "
              "(run `python -m ccfd_tpu_torch engine`)", file=sys.stderr)
        return 2
    router, registry, sink, collectors = build_router(cfg, args.device, args.params,
                                                      args.workers)
    regs = {"router": registry}
    if sink is not None:
        regs["tracing"] = sink.registry
    exporter = MetricsExporter(regs, host="0.0.0.0", port=args.metrics_port, sink=sink,
                               collectors=collectors).start()
    scorer = (f"remote {cfg.seldon_url}" if cfg.seldon_url.startswith("http")
              else "local Scorer")
    print(f"[router] consuming {cfg.kafka_topic!r} from {cfg.broker_url} "
          f"(bus transport {'http' if cfg.broker_url.startswith('http') else 'in-process'}); "
          f"decoder=native (CSV wire); scorer={scorer}; gc_threshold={_tune_gc()}; "
          f"metrics on :{exporter.endpoint.rsplit(':', 1)[1]}/prometheus",
          file=sys.stderr, flush=True)
    _sigterm_as_interrupt()
    try:
        router.run(poll_timeout_s=0.05)
    except KeyboardInterrupt:
        router.close()
    exporter.stop()
    return 0


def cmd_notify(args: argparse.Namespace) -> int:
    """The notification service (the reference's notification-service)."""
    from ccfd_tpu_torch.metrics.exporter import MetricsExporter
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.notify.service import NotificationService

    cfg = Config.from_env()
    _refuse_unported(cfg)
    registry = Registry()
    tracer, sink = _tracing_for(cfg, registry, "notify")
    svc = NotificationService(cfg, _broker_for(cfg), registry, reply_prob=args.reply_prob,
                              approve_prob=args.approve_prob, seed=args.seed, tracer=tracer)
    regs = {"notify": registry}
    if sink is not None:
        regs["tracing"] = sink.registry
    exporter = MetricsExporter(regs, host="0.0.0.0", port=args.metrics_port,
                               sink=sink).start()
    print(f"[notify] consuming {cfg.customer_notification_topic!r} from {cfg.broker_url}; "
          f"metrics on :{exporter.endpoint.rsplit(':', 1)[1]}/prometheus "
          f"gc_threshold={_tune_gc()}", file=sys.stderr, flush=True)
    _sigterm_as_interrupt()
    try:
        svc.run(poll_timeout_s=0.05)
    except KeyboardInterrupt:
        svc.stop()
    exporter.stop()
    return 0


def cmd_producer(args: argparse.Namespace) -> int:
    """The transaction producer (the reference's ProducerDeployment): the CSV
    at CCFD_CSV or the synthetic stream, onto the producer topic."""
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.producer.producer import Producer

    cfg = Config.from_env()
    _refuse_unported(cfg)
    registry = Registry()
    tracer, _sink = _tracing_for(cfg, registry, "producer")
    n = Producer(cfg, _broker_for(cfg), registry=registry, tracer=tracer).run(
        limit=args.limit, rate_per_s=args.rate, wire_format=args.wire_format)
    print(f"[producer] streamed {n} rows to {cfg.producer_topic!r}", file=sys.stderr,
          flush=True)
    return 0


def _engine_client(cfg: Config, url: str):
    from ccfd_tpu_torch.process.client import EngineRestClient

    return EngineRestClient(url, timeout_s=cfg.seldon_timeout_ms / 1000.0,
                            retries=cfg.client_retries)


def cmd_investigate(args: argparse.Namespace) -> int:
    """Investigator simulation working the engine's task queue over the
    KIE-shaped REST contract: seeded verdicts, rate-limited, trusting
    confident console pre-fills; the decisions train the user-task model."""
    from ccfd_tpu_torch.metrics.exporter import MetricsExporter
    from ccfd_tpu_torch.process.investigator import InvestigatorService

    cfg = Config.from_env()
    url = args.engine_url or cfg.kie_server_url
    svc = InvestigatorService(
        _engine_client(cfg, url), rate_per_s=args.rate, trust_threshold=args.trust,
        base_fraud_rate=args.fraud_rate, seed=args.seed)
    exporter = MetricsExporter({"investigator": svc.registry}, host="0.0.0.0",
                               port=args.metrics_port).start()
    print(f"[investigate] working {url} at <= {args.rate}/s; metrics on "
          f":{exporter.endpoint.rsplit(':', 1)[1]}/prometheus", file=sys.stderr, flush=True)
    _sigterm_as_interrupt()
    try:
        svc.run()
    except KeyboardInterrupt:
        svc.stop()
    exporter.stop()
    return 0


def cmd_tasks(args: argparse.Namespace) -> int:
    """The investigator's CLI: list and complete user tasks on the engine.
    Completing with --outcome approved/rejected is the decision the
    user-task model learns from."""
    cfg = Config.from_env()
    url = args.engine_url or cfg.kie_server_url
    if not url.startswith("http"):
        print(f"[tasks] KIE_SERVER_URL={url!r} is not an http engine endpoint; "
              "start one with `python -m ccfd_tpu_torch engine` and point "
              "--engine-url at it", file=sys.stderr)
        return 2
    client = _engine_client(cfg, url)
    if args.complete is not None:
        # the engine's completion payload is the boolean is_fraud verdict
        # (truthy cancels the transaction): map the investigator's words
        # explicitly, since the raw string "approved" is truthy
        verdicts = {"approved": False, "rejected": True, "false": False, "true": True}
        if args.outcome is None or args.outcome.lower() not in verdicts:
            print("[tasks] --complete requires --outcome approved|rejected "
                  "(approved = legitimate transaction, rejected = confirmed fraud)",
                  file=sys.stderr)
            return 2
        is_fraud = verdicts[args.outcome.lower()]
        try:
            client.complete_task(args.complete, is_fraud)
        except (RuntimeError, OSError) as e:
            print(f"[tasks] engine error: {e}", file=sys.stderr)
            return 2
        print(json.dumps({"completed": args.complete, "outcome": args.outcome.lower(),
                          "is_fraud": is_fraud}))
        return 0
    try:
        views = client.tasks(args.status)
    except (RuntimeError, OSError) as e:
        print(f"[tasks] engine error: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"status": args.status, "count": len(views), "tasks": views}))
    return 0


def _audit_fetch_json(url: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return json.loads(resp.read().decode())
    except (urllib.error.URLError, OSError, ValueError):
        return None


def cmd_audit_reconstruct(args: argparse.Namespace, cfg: Config) -> int:
    """``audit <tx_id>``: the decision record stamped at the route seam,
    read from the live exporter with ``--url`` (``/decisions/<tx_id>``) or
    OFFLINE from the audit segments under ``--dir`` (CCFD_AUDIT_DIR),
    read-only, as the reference's. The lineage join reads the version that
    scored it from the lifecycle's store (``--lifecycle-dir``,
    CCFD_LIFECYCLE_DIR; read-only) with the hash parity of the decision's
    stamp against the lineage's; the incident join finds the bundle that
    was open when the decision was made (the live exporter's
    ``/incidents/<id>``, else ``--incident-dir``, CCFD_INCIDENT_DIR); the
    trace join asks the live exporter for the kept trace."""
    doc: dict = {"tx_id": args.tx_id}
    record = None
    base = args.url.rstrip("/") if args.url else ""
    if base:
        record = _audit_fetch_json(f"{base}/decisions/{args.tx_id}")
    if record is None:
        audit_dir = args.dir or cfg.audit_dir
        if audit_dir:
            from ccfd_tpu_torch.observability.audit import AuditLog

            # readonly: an inspection command never truncates the live log
            # out from under a running platform
            record = AuditLog(dir=audit_dir, readonly=True,
                              max_records=cfg.audit_ring).get(args.tx_id)
    if record is None:
        print(f"[audit] no decision record for {args.tx_id!r} (checked "
              + (f"{base}/decisions and " if base else "")
              + f"dir={args.dir or cfg.audit_dir or '<unset>'})", file=sys.stderr)
        return 2
    doc["record"] = record
    lc_dir = args.lifecycle_dir or cfg.lifecycle_dir
    if lc_dir and record.get("version") is not None:
        from ccfd_tpu_torch.lifecycle.versions import VersionStore

        try:
            store = VersionStore(os.path.join(lc_dir, "versions.json"), recover=False)
            v = store.get(int(record["version"]))
            doc["lineage"] = {
                "version": v.to_dict(),
                "events": store.audit_trail(v.version),
                # the compliance check: the hash stamped on the decision is
                # the hash the lineage records for that version
                "hash_parity": (record.get("hash") is not None
                                and v.checkpoint_hash == record.get("hash")),
            }
        except (OSError, ValueError, KeyError, TypeError) as e:
            doc["lineage"] = {"error": repr(e)}
    # the incident join: what was burning while this decision was made
    inc_id = record.get("incident")
    if inc_id:
        bundle = _audit_fetch_json(f"{base}/incidents/{inc_id}") if base else None
        if bundle is None:
            inc_dir = args.incident_dir or cfg.incident_dir
            if inc_dir:
                try:
                    with open(os.path.join(inc_dir, f"{inc_id}.json")) as f:
                        bundle = json.load(f)
                except (OSError, ValueError):
                    bundle = None
        doc["incident"] = ({"id": bundle.get("id"), "trigger": bundle.get("trigger"),
                            "generated_unix": bundle.get("generated_unix"), "found": True}
                           if bundle is not None else {"id": inc_id, "found": False})
    trace_id = record.get("trace")
    if trace_id and base:
        tr = _audit_fetch_json(f"{base}/traces/{trace_id}")
        doc["trace"] = ({"trace_id": trace_id, "spans": len(tr.get("spans", [])),
                         "kept": True}
                        if tr is not None else {"trace_id": trace_id, "kept": False})
    elif trace_id:
        doc["trace"] = {"trace_id": trace_id, "kept": None}
    if args.json:
        print(json.dumps(doc, indent=1, default=str))
        return 0
    r = record
    print(f"decision tx={r.get('tx')} uid={r.get('uid')} seq={r.get('seq')}")
    print(f"  score: proba={r.get('proba')} threshold={r.get('threshold')} "
          f"-> rule={r.get('rule')} branch={r.get('branch')} pid={r.get('pid')}")
    cause = f" ({r['cause']})" if r.get("cause") else ""
    print(f"  served by: {r.get('tier', '?')} tier{cause}  priority={r.get('priority')}"
          + (f"  events={r['events']}" if r.get("events") else ""))
    print(f"  model: version={r.get('version')} hash={r.get('hash')}")
    lin = doc.get("lineage")
    if lin and "version" in lin:
        v = lin["version"]
        print(f"  lineage: v{v['version']} stage={v['stage']} parent={v['parent']} "
              f"labels@{v['label_watermark']} hash_parity={lin['hash_parity']}")
    elif lin:
        print(f"  lineage: unreadable ({lin['error']})")
    inc = doc.get("incident")
    if inc:
        mark = "" if inc.get("found") else " (bundle not found)"
        print(f"  incident: {inc['id']}{mark}"
              + (f" trigger={inc['trigger']}" if inc.get("trigger") else ""))
    trc = doc.get("trace")
    if trc:
        kept = {True: "kept", False: "not retained",
                None: "offline (query --url for spans)"}[trc.get("kept")]
        print(f"  trace: {trc['trace_id']} [{kept}]")
    return 0


def cmd_audit(args: argparse.Namespace) -> int:
    """With a tx id: reconstruct that decision (the provenance plane,
    observability/audit.py; ``cmd_audit_reconstruct``). Without one: tail
    the engine's audit stream (CCFD_AUDIT_TOPIC), one JSON event a line;
    ``--follow`` keeps consuming, otherwise it drains what is there and
    exits."""
    cfg = Config.from_env()
    if args.tx_id:
        return cmd_audit_reconstruct(args, cfg)
    _refuse_unported(cfg, "audit")
    topic = args.topic or cfg.audit_topic
    if not topic:
        # without CCFD_AUDIT_TOPIC the engine emits nothing: say so
        print("[audit] CCFD_AUDIT_TOPIC is unset (the engine's audit stream is OFF); "
              "tailing the default topic 'ccd-audit'", file=sys.stderr)
        topic = "ccd-audit"
    consumer = _broker_for(cfg).consumer(args.group, (topic,))
    printed = 0
    try:
        while True:
            # poll at most what the limit leaves: a poll commits what it
            # returns, and events fetched past the limit would be skipped
            want = min(1024, args.limit - printed) if args.limit else 1024
            recs = consumer.poll(want, 0.5 if args.follow else 0.0)
            for rec in recs:
                print(json.dumps(rec.value))
                printed += 1
                if args.limit and printed >= args.limit:
                    return 0
            if not recs and not args.follow:
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        consumer.close()


def cmd_replay(args: argparse.Namespace) -> int:
    """``replay``: the bulk replay & backtest console (replay/).

    Offline (default): scan the recorded window out of the audit segments
    read-only and summarize it; with ``--what-if-threshold`` run the
    host-side backtest (which recorded decisions flip under the new
    threshold): no platform, no bus. With ``--live``: bring a platform up
    (on the card unless ``--device cpu``), re-produce the window through
    the real bus -> router -> scorer path under ``bulk`` admission, and
    print the verdict-parity report (divergences classified by cause);
    exit 1 when parity does not hold."""
    cfg = Config.from_env()
    audit_dir = args.dir or cfg.audit_dir
    if not audit_dir:
        print("[replay] no audit dir: pass --dir or set CCFD_AUDIT_DIR (windows are "
              "reconstructed from the audit segments)", file=sys.stderr)
        return 2
    since, until = args.since_seq, args.until_seq
    if args.from_incident:
        from ccfd_tpu_torch.replay.service import bundle_window

        with open(args.from_incident) as f:
            rng = bundle_window(json.load(f))
        if rng is None:
            print(f"[replay] {args.from_incident} embeds no decision summaries; "
                  "nothing to re-drive", file=sys.stderr)
            return 2
        since, until = rng
    if args.live:
        from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

        if args.cr:
            spec = PlatformSpec.from_yaml(args.cr, cfg=cfg)
        else:
            # a minimal replay platform: bus + scorer + engine + router +
            # the audit and replay planes over the recorded segments
            spec = PlatformSpec.from_cr({"spec": {
                "audit": {"dir": audit_dir},
                "replay": {"enabled": True, "dir": args.state_dir or cfg.replay_dir},
                "monitoring": {"enabled": False}, "health": {"enabled": False},
                "analytics": {"enabled": False}, "retrain": {"enabled": False},
                "notify": {"enabled": False},
            }}, cfg=cfg)
        p = Platform(spec, device=args.device).up()
        try:
            if p.replay is None:
                print("[replay] the platform came up without the replay component "
                      "(CR replay.enabled / audit plane off?)", file=sys.stderr)
                return 2
            report = p.replay.run_window(since, until, window_id=(args.window_id or None),
                                         resume=not args.no_resume)
        finally:
            p.down()
        print(json.dumps(report if args.json else {
            k: report[k] for k in ("window_id", "total", "replayed", "match", "divergence",
                                   "drop", "ghost", "causes", "parity", "rows_per_s")}))
        return 0 if report.get("parity") else 1

    from ccfd_tpu_torch.observability.audit import AuditLog
    from ccfd_tpu_torch.replay.service import ReplayService

    audit = AuditLog(dir=audit_dir, readonly=True, max_records=cfg.audit_ring)
    if args.what_if_threshold is not None:
        svc = ReplayService(cfg, None, audit, state_dir=(args.state_dir or None))
        report = svc.run_window(since, until, mode="whatif", threshold=args.what_if_threshold,
                                window_id=(args.window_id or None))
        print(json.dumps(report if args.json else {
            k: report[k] for k in ("window_id", "total", "threshold", "flips", "flip_rate",
                                   "mean_abs_delta")}))
        return 0
    recs = audit.scan_window(since, until)
    tiers: dict[str, int] = {}
    for r in recs:
        t = str(r.get("tier", "device"))
        tiers[t] = tiers.get(t, 0) + 1
    print(json.dumps({
        "records": len(recs),
        "rescorable": sum(1 for r in recs if r.get("row") is not None),
        "seq": ([int(recs[0].get("seq", -1)), int(recs[-1].get("seq", -1))]
                if recs else None),
        "tiers": tiers,
    }))
    return 0


def cmd_lifecycle(args: argparse.Namespace) -> int:
    """``lifecycle``: the model lifecycle's versioned lineage and transition
    audit trail (lifecycle/versions.py), read-only from the store the
    platform's ``lifecycle.state_dir`` (or CCFD_LIFECYCLE_DIR) points at: no
    running platform needed. Reads the reference's store too."""
    from ccfd_tpu_torch.lifecycle.versions import VersionStore

    cfg = Config.from_env()
    state_dir = args.dir or cfg.lifecycle_dir
    if not state_dir:
        print("[lifecycle] no state dir: pass --dir or set CCFD_LIFECYCLE_DIR (the CR's "
              "lifecycle.state_dir)", file=sys.stderr)
        return 2
    path = os.path.join(state_dir, "versions.json")
    if not os.path.exists(path):
        print(f"[lifecycle] no lineage at {path}", file=sys.stderr)
        return 2
    try:
        # recover=False: an inspection never quarantines the live lineage
        # out from under a running platform
        store = VersionStore(path, recover=False)
    except (OSError, ValueError, KeyError, TypeError) as e:
        print(f"[lifecycle] lineage at {path} is unreadable ({e!r}); the controller "
              "quarantines and re-bootstraps it at next bring-up", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({"versions": [v.to_dict() for v in store.versions()],
                          "audit": store.audit_trail(args.version or None)}, indent=1))
        return 0
    champ = store.champion()
    print(f"champion: v{champ.version}" if champ else "champion: none")
    for v in store.versions():
        mark = "*" if champ and v.version == champ.version else " "
        print(f"{mark} v{v.version:<4} stage={v.stage:<12} "
              f"parent={v.parent if v.parent is not None else '-':<4} "
              f"labels@{v.label_watermark:<8} "
              f"ckpt={v.checkpoint_step if v.checkpoint_step is not None else '-'}")
    if args.audit:
        for e in store.audit_trail(args.version or None):
            detail = json.dumps(e["detail"], sort_keys=True)
            print(f"  {e['ts']:.3f} v{e['version']} {e['event']}: {detail}")
    return 0


def cmd_analyze(args: argparse.Namespace) -> int:
    """``analyze``: the dataset analytics report (the reference's
    JupyterHub + Spark notebook workflow) as one command, summarized on the
    card unless ``--device cpu``; ``workers`` is 1 (one device, no mesh)."""
    import numpy as np

    from ccfd_tpu_torch.analytics.engine import AnalyticsEngine
    from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES, load_dataset

    ds = load_dataset()
    engine = AnalyticsEngine(device=args.device, nbins=args.nbins)
    report = engine.summarize(ds.X, ds.y)
    out = report.to_dict()
    out["workers"] = 1
    # the strongest off-diagonal correlations
    corr = report.corr.copy()
    idx = np.triu_indices_from(corr, k=1)
    order = np.argsort(-np.abs(corr[idx]))[: args.top_corr]
    out["top_correlations"] = [
        {"a": FEATURE_NAMES[idx[0][k]], "b": FEATURE_NAMES[idx[1][k]],
         "corr": float(corr[idx][k])}
        for k in order]
    if args.drift_split:
        half = ds.n // 2
        scores = engine.drift(engine.summarize(ds.X[:half]), ds.X[half:])
        worst = int(np.argmax(scores))
        out["drift_self_check"] = {"max_psi": float(scores[worst]),
                                   "worst_feature": FEATURE_NAMES[worst]}
    print(json.dumps(out))
    return 0


PORT_CR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                       "platform_cr.yaml")


def cmd_up(args: argparse.Namespace) -> int:
    """The operator entry: CR file -> running platform (the reference's
    run-book, README.md:44-537, as one command)."""
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec, refuse

    spec = PlatformSpec.from_yaml(args.file)
    refuse(spec)  # before anything starts
    if args.exit_after_producer and not spec.component("producer").enabled:
        print("[up] --exit-after-producer given but producer is disabled in the CR",
              file=sys.stderr)
        return 2
    _sigterm_as_interrupt()
    platform = Platform(spec, device=args.device)
    try:
        platform.up()
        print(json.dumps(platform.status(), indent=2), file=sys.stderr)
        sc = platform.scorer
        if sc is not None:
            from ccfd_tpu_torch.params import digest

            grid = sc.executable_grid()
            # the seq family is torch code: its grid names no kernel
            served = (f"scorer {grid['model']} on {sc.device}, kernel "
                      f"{grid.get('kernel', 'none (torch code)')}, "
                      f"params sha256 {digest(sc.params)}")
        else:
            served = "no local scorer"
        print(f"[up] platform ready: {served}; gc_threshold={_tune_gc()}",
              file=sys.stderr, flush=True)
        if args.exit_after_producer:
            t0 = time.monotonic()
            platform.wait_producer(timeout_s=args.drain_s)
            routed = platform.wait_routed(max(0.0, args.drain_s - (time.monotonic() - t0)))
            print(f"[up] producer done; router {'drained' if routed else 'NOT drained'} "
                  f"after {time.monotonic() - t0:.3f} s", file=sys.stderr, flush=True)
            time.sleep(2.0)  # let timers and signals drain
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if platform.exporter is not None:
            platform.exporter.refresh()  # the scrape-time gauges, current
        for name, reg in platform.registries.items():
            print(f"--- {name} ---", file=sys.stderr)
            print(reg.render(), file=sys.stderr)
        # the planner's inputs at exit: the stage profile and the device
        # snapshot, one JSON line each
        if platform.profiler is not None:
            print(f"--- profile ---\n{json.dumps(platform.profiler.snapshot())}",
                  file=sys.stderr)
        if platform.device_telemetry is not None:
            print(f"--- device ---\n{json.dumps(platform.device_telemetry.snapshot())}",
                  file=sys.stderr)
        platform.down()
    return 0


def cmd_manifests(args: argparse.Namespace) -> int:
    """Per-service k8s manifests from the platform CR (the reference's
    deploy/*.yaml topology for the port's image and commands)."""
    from ccfd_tpu_torch.platform.k8s import write_manifests
    from ccfd_tpu_torch.platform.operator import PlatformSpec

    spec = PlatformSpec.from_yaml(args.file)
    print(json.dumps({"written": write_manifests(spec, args.out)}))
    return 0


def cmd_store(args: argparse.Namespace) -> int:
    """Object-store operations: the reference run-book's Ceph/S3 steps
    (README.md:136-343: serve the store, upload the CSV, `aws s3 ls`)."""
    from ccfd_tpu_torch.store.client import S3Client
    from ccfd_tpu_torch.store.objectstore import Credentials, ObjectStore
    from ccfd_tpu_torch.store.server import StoreServer

    cfg = Config.from_env()
    creds = Credentials(cfg.access_key_id or "ccfd-access",
                        cfg.secret_access_key or "ccfd-secret")
    if args.action == "serve":
        store = ObjectStore(root=args.root)
        store.add_credentials(creds)
        store.create_bucket(cfg.s3_bucket)
        srv = StoreServer(store, host=args.host, port=args.port).start()
        print(json.dumps({"endpoint": srv.endpoint, "bucket": cfg.s3_bucket}), flush=True)
        _serve_forever()
        srv.stop()
        return 0
    # an explicit --endpoint beats the s3endpoint env var
    client = S3Client(args.endpoint or cfg.s3_endpoint or "http://127.0.0.1:9000", creds)
    if args.action == "put":
        if args.file:
            with open(args.file, "rb") as f:
                data = f.read()
        else:  # the synthetic (or CCFD_CSV) dataset as creditcard.csv
            from ccfd_tpu_torch.data.ccfd import load_dataset, to_csv_bytes

            data = to_csv_bytes(load_dataset())
        client.create_bucket(cfg.s3_bucket)
        client.put(cfg.s3_bucket, cfg.filename, data)
        print(json.dumps({"bucket": cfg.s3_bucket, "key": cfg.filename, "bytes": len(data)}))
    elif args.action == "ls":
        print(json.dumps({"bucket": cfg.s3_bucket, "keys": client.list(cfg.s3_bucket)}))
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    cfg = Config.from_env()
    params = None
    if args.train and cfg.graph_cr:
        print("[serve] --train trains the MLP; a CCFD_GRAPH_CR graph has graph-shaped "
              "params — unset --train or unset CCFD_GRAPH_CR", file=sys.stderr)
        return 2
    if args.train:
        if cfg.model_name != "mlp":
            print(f"[serve] --train trains the MLP; CCFD_MODEL={cfg.model_name!r} params "
                  "would not match: unset --train or set CCFD_MODEL=mlp", file=sys.stderr)
            return 2
        from ccfd_tpu_torch.data.ccfd import load_dataset

        _refuse_unported(cfg, "serve")  # before the training, not after
        ds = load_dataset()
        params = train_mlp(ds.X, ds.y, args.train_steps, args.device)
    srv = build_server(cfg, device=args.device, params_path=args.params,
                       checkpoint_dir=args.checkpoint_dir, params=params,
                       gbt_dir=args.gbt_dir)
    gc0 = _tune_gc()
    host = args.host if args.host is not None else cfg.serve_host
    port = srv.start(host, args.port if args.port is not None else cfg.serve_port)
    grid = srv.scorer.executable_grid()
    print(f"[serve] model={grid['model']} device={srv.scorer.device} "
          f"kernel={'on' if grid['fused'] else 'off'} "
          f"int8_wire={'on' if grid['int8_wire'] else 'off'} decoder=native "
          f"transport={srv.transport} dispatch_deadline_ms={grid['dispatch_deadline_ms']} "
          f"gc_threshold={gc0} listening on "
          f"{host}:{port}", file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def training_dataset():
    """(dataset, source) that ``train`` and ``quantize`` run on, as the
    reference's ``_training_dataset``: the CSV at CCFD_CSV, else the
    Kaggle-shaped surrogate (CCFD_SURROGATE_ROWS rows when set, else the
    full table)."""
    from ccfd_tpu_torch.data.ccfd import load_dataset
    from ccfd_tpu_torch.data.surrogate import SURROGATE_VERSION, kaggle_surrogate

    if os.environ.get("CCFD_CSV"):
        return load_dataset(), os.environ["CCFD_CSV"]
    rows = int(os.environ.get("CCFD_SURROGATE_ROWS", "0") or 0)
    if rows > 0:
        return kaggle_surrogate(n=rows), f"surrogate:{SURROGATE_VERSION}:n={rows}"
    return kaggle_surrogate(), f"surrogate:{SURROGATE_VERSION}"


def held_out_split(n: int, test_frac: float):
    """(test, train) row indices: the reference's held-out split, a
    ``default_rng(0)`` permutation whose first ``test_frac`` is held out."""
    import numpy as np

    order = np.random.default_rng(0).permutation(n)
    n_test = max(1, int(n * test_frac))
    return order[:n_test], order[n_test:]


def cmd_train(args: argparse.Namespace) -> int:
    """Offline training of the MLP: held-out AUC, then a checkpoint step
    that ``serve`` and ``quantize`` read by default."""
    import torch

    from ccfd_tpu_torch.device import resolve
    from ccfd_tpu_torch.models import mlp
    from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
    from ccfd_tpu_torch.utils.metrics_math import roc_auc

    if args.family == "hgb":
        print("[train] --family hgb needs scikit-learn (the port does not import it)",
              file=sys.stderr)
        return 2
    if args.from_store:
        raise NotImplementedError(
            "train --from-store (training on the object store's CSV, ROADMAP A14b) is not "
            "ported yet; the store itself is (`store`, the producer's s3endpoint)")
    dev = resolve(args.device)
    ds, source = training_dataset()
    test, train = held_out_split(ds.n, args.test_frac)
    t0 = time.perf_counter()
    params = train_mlp(ds.X[train], ds.y[train], args.steps, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    proba = mlp.apply(params, torch.from_numpy(ds.X[test]).to(dev)).cpu().numpy()
    auc_mlp = roc_auc(ds.y[test], proba)
    path = CheckpointManager(args.checkpoint_dir).save(args.steps, params)
    print(f"[train] fit_mlp: {args.steps} steps of 1024 rows in {fit_s:.3f} s "
          f"({args.steps / fit_s:.1f} steps/s) on {dev}", file=sys.stderr)
    print(json.dumps({
        "checkpoint": path, "rows": int(ds.n), "steps": args.steps,
        "source": source, "test_rows": int(len(test)),
        "auc_mlp": round(auc_mlp, 5),
        # the reference's logistic-regression baseline needs scikit-learn,
        # which the port does not import: null, as the reference prints it
        # without scikit-learn
        "auc_sklearn_logreg": None,
    }))
    return 0


def cmd_quantize(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from ccfd_tpu_torch.device import resolve
    from ccfd_tpu_torch.models import mlp
    from ccfd_tpu_torch.ops import quant
    from ccfd_tpu_torch.params import (
        DEFAULT_PARAMS,
        MLP_LIKE,
        load_params,
        save_params,
        to_device,
    )
    from ccfd_tpu_torch.utils.metrics_math import roc_auc

    dev = resolve(args.device)
    src, step, params = args.params, None, None
    if not src:
        restored = restore_checkpoint(args.checkpoint_dir, MLP_LIKE)
        if restored is not None:
            params, step = restored
            src = os.path.join(args.checkpoint_dir, f"step_{step}")
        else:
            src = DEFAULT_PARAMS
    if params is None:
        params = load_params(src)
    if quant.is_quantized(params):
        print(f"[quantize] {src} already holds int8 params", file=sys.stderr)
        return 2
    qp = quant.quantize_mlp(params)

    ds, _source = training_dataset()
    te = held_out_split(ds.n, args.test_frac)[0]
    p32 = mlp.apply(to_device(params, dev), torch.from_numpy(ds.X[te]).to(dev)).cpu().numpy()
    p8 = quant.apply_numpy(qp, ds.X[te])
    save_params(qp, args.out)
    print(json.dumps({
        "source": str(src),
        "source_step": step,
        "eval_rows": int(len(te)),
        "auc_f32": round(roc_auc(ds.y[te], p32), 6),
        "auc_int8": round(roc_auc(ds.y[te], p8), 6),
        "max_prob_delta": round(float(np.abs(p8 - p32).max()), 6),
        "evidence": "f32-to-int8 delta on a sampled evaluation set",
        "out": str(args.out),
        "serve_with": f"CCFD_MODEL=mlp_q8 python -m ccfd_tpu_torch serve --params {args.out}",
    }))
    return 0


def cmd_score(args: argparse.Namespace) -> int:
    """Offline bulk scoring: CSV rows in, probabilities out, through the
    Scorer's pipelined bucketed dispatch; the reference's JSON line."""
    import numpy as np

    from ccfd_tpu_torch.data.ccfd import load_dataset

    cfg = Config.from_env()
    _refuse_unported(cfg, "score")
    cfg = with_graph(cfg)
    ds = load_dataset(path=args.input or None)
    params = served_params(cfg, checkpoint_dir=args.checkpoint_dir, gbt_dir=args.gbt_dir,
                           quantized_dir=args.quantized_dir)
    scorer = make_scorer(cfg, params, args.device)
    t0 = time.perf_counter()
    proba = scorer.score_pipelined(ds.X, depth=args.depth)
    elapsed = time.perf_counter() - t0
    if args.output:
        with open(args.output, "w") as f:
            f.write("proba_1\n")
            f.write("\n".join(repr(float(p)) for p in proba) + "\n")
    print(json.dumps({
        "rows": int(ds.n),
        "seconds": round(elapsed, 3),
        "tx_s": round(ds.n / max(elapsed, 1e-9), 1),
        "flagged_fraud": int((proba >= cfg.fraud_threshold).sum()),
        "fraud_threshold": cfg.fraud_threshold,
        # the mean of no rows is NaN, which is not JSON
        "mean_proba": round(float(np.mean(proba)), 6) if ds.n else None,
        "output": args.output or None,
        "checkpoint": params is not None,
    }))
    return 0


def cmd_loadgen(args: argparse.Namespace) -> int:
    """Drive a RUNNING scorer endpoint (local or remote) with the
    subprocess raw-socket clients of ``utils/loadgen.py``; one JSON report
    on stdout. Exits 3 when any request errored or a client failed, so it
    serves as a smoke gate in a deploy pipeline."""
    from ccfd_tpu_torch.utils.loadgen import run_loadgen

    cfg = Config.from_env()
    report = run_loadgen(args.url, clients=args.clients, rows_per_request=args.rows,
                         seconds=args.seconds, path=args.path, token=cfg.seldon_token)
    print(json.dumps(report))
    return 0 if report["errors"] == 0 and report["failed_clients"] == 0 else 3


# the doctor's device probe, run in a subprocess under --probe-s: a wedged
# card (a CUDA context that never answers) times the probe out
# instead of hanging the doctor. It names the device, times a small
# product's round trip and reads the card's name and power limit.
DOCTOR_PROBE = r"""
import json, subprocess, sys, time
import torch
dev = sys.argv[1]
out = {"torch": torch.__version__, "cuda": torch.version.cuda}
if dev == "cuda":
    if not torch.cuda.is_available():
        print(json.dumps({**out, "error": "torch.cuda.is_available() is False"}))
        raise SystemExit(1)
    out.update(platform="gpu", devices=torch.cuda.device_count(),
               name=torch.cuda.get_device_name(0),
               capability=list(torch.cuda.get_device_capability(0)))
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        out["nvidia_smi"] = smi.stdout.strip().splitlines() if smi.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        out["nvidia_smi"] = None
else:
    out.update(platform="cpu", devices=1, name="cpu")
x = torch.zeros((16, 30), device=dev)
(x @ x.T).sum().item()
t0 = time.perf_counter()
for _ in range(5):
    (x @ x.T).sum().item()
out["dispatch_rtt_ms"] = round((time.perf_counter() - t0) / 5 * 1e3, 3)
print(json.dumps(out))
"""


def cmd_doctor(args: argparse.Namespace) -> int:
    """One-shot operational health report, one JSON object on stdout; exit
    0 only when the device answered (the card unless ``--device cpu``).
    Everything that could hang on a wedged card runs in a SUBPROCESS under
    ``--probe-s``. Sections: the device (name, count, the card's name and
    power limit as nvidia-smi reports them, torch and CUDA versions, a
    small product's round trip), the kernel libraries (built under
    ``build/`` and current for their sources: the library name carries the
    sources' hash), the toolchain, the bus and store reachability for
    networked URLs, the checkpoints, and the environment contract in
    effect."""
    import subprocess

    cfg = Config.from_env()
    dev = args.device or "cuda"
    report: dict[str, Any] = {"ok": True}
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-c", DOCTOR_PROBE, dev], timeout=args.probe_s,
                           capture_output=True, text=True)
        lines = r.stdout.strip().splitlines()
        if r.returncode == 0 and lines:
            report["device"] = json.loads(lines[-1])
            report["device"]["probe_s"] = round(time.perf_counter() - t0, 2)
        else:
            try:  # the probe's own verdict (no CUDA), else its stderr's tail
                report["device"] = dict(json.loads(lines[-1]))
            except (IndexError, ValueError, TypeError):
                report["device"] = {"error": (r.stderr or "probe failed").strip()[-300:]}
            report["ok"] = False
    except subprocess.TimeoutExpired:
        report["device"] = {
            "error": f"WEDGED: no answer within {args.probe_s:.0f}s (the device probe "
                     "hangs: the card is stuck; restart the process "
                     "that holds it)"}
        report["ok"] = False

    # the kernel libraries: built and current for their sources
    from ccfd_tpu_torch import native
    from ccfd_tpu_torch.ops import _build

    kernels: dict[str, Any] = {}
    for name in _build.SOURCES:
        target = _build._target(name)
        kernels[name] = {"built": target.exists(), "path": str(target)}
    try:
        target = native.library_path()
        kernels["native"] = {"built": target.exists(), "path": str(target)}
    except Exception as e:  # noqa: BLE001 - report, don't crash the doctor
        kernels["native"] = {"built": False, "error": str(e)[-300:]}
    report["kernels"] = kernels
    try:
        report["nvcc"] = _build.nvcc_path()
    except RuntimeError as e:
        report["nvcc"] = f"absent: {e}"

    def tcp_check(url: str) -> str:
        import socket
        from urllib.parse import urlparse

        if not url.startswith(("http://", "https://", "kafka://")):
            return "in-process (nothing to dial)"
        p = urlparse(url)
        port = p.port or {"kafka": 9092, "https": 443}.get(p.scheme, 80)
        try:
            with socket.create_connection((p.hostname, port), timeout=3):
                return "reachable"
        except OSError as e:
            return f"unreachable: {e}"

    report["bus"] = {"url": cfg.broker_url, "status": tcp_check(cfg.broker_url)}
    if cfg.s3_endpoint:
        report["store"] = {"url": cfg.s3_endpoint, "status": tcp_check(cfg.s3_endpoint)}

    from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager

    for label, d in (("checkpoint", args.checkpoint_dir), ("quantized", args.quantized_dir)):
        try:
            step = CheckpointManager(d).latest_step() if d else None
        except Exception:  # noqa: BLE001 - an unreadable dir reads as absent
            step = None
        report[label] = {"dir": d, "latest_step": step}
    report["gbt"] = {"dir": GBT_DIR,
                     "present": os.path.exists(os.path.join(GBT_DIR, "params.npz"))}
    on_card = report["device"].get("platform") == "gpu"
    report["config"] = {
        "model": cfg.model_name,
        "compute_dtype": cfg.compute_dtype,
        "fraud_threshold": cfg.fraud_threshold,
        "seldon_timeout_ms": cfg.seldon_timeout_ms,
        "dispatch_deadline_ms": cfg.dispatch_deadline_ms,
        # what serving would arm, resolved from the SUBPROCESS probe's
        # platform: this process never touches the device
        "dispatch_deadline_ms_effective": cfg.scorer_dispatch_deadline_ms(on_card),
        "host_tier_rows": cfg.host_tier_rows,
        "batch_sizes": list(cfg.batch_sizes),
        "unported": cfg.unported(),
    }
    print(json.dumps(report))
    return 0 if report["ok"] else 3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ccfd_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="offline-train the flagship MLP and write a checkpoint")
    t.add_argument("--steps", type=int, default=500)
    t.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    t.add_argument("--family", choices=("mlp", "hgb"), default="mlp",
                   help="hgb needs scikit-learn, which the port does not import (exit 2)")
    t.add_argument("--from-store", action="store_true",
                   help="read the CSV from the object store (not ported)")
    t.add_argument("--test-frac", type=float, default=0.2)
    t.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where to train (default: the card)")
    t.set_defaults(fn=cmd_train)
    s = sub.add_parser("serve", help="Seldon-contract REST scorer")
    s.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where to score (default: the card)")
    src = s.add_mutually_exclusive_group()
    src.add_argument("--params", default=None,
                     help=".npz of MLP or int8 MLP params (default: the newest step in "
                     "--checkpoint-dir, else the committed checkpoint)")
    src.add_argument("--train", action="store_true", help="train the MLP before serving")
    s.add_argument("--train-steps", type=int, default=300)
    s.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR,
                   help="serve the newest `train` step there when present (the MLP)")
    s.add_argument("--gbt-dir", default=GBT_DIR,
                   help="tree params dir used when CCFD_MODEL=gbt "
                   "(written by the reference's `train --family hgb`)")
    s.add_argument("--host", default=None, help="bind address (CCFD_SERVE_HOST)")
    s.add_argument("--port", type=int, default=None, help="port (CCFD_SERVE_PORT)")
    s.set_defaults(fn=cmd_serve)
    q = sub.add_parser("quantize", help="int8-quantize f32 MLP params (mlp_q8)")
    q.add_argument("--params", default=None,
                   help="f32 .npz to quantize (default: the newest step in "
                   "--checkpoint-dir, else the committed checkpoint)")
    q.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    q.add_argument("--out", required=True, help="where to write the int8 .npz")
    q.add_argument("--test-frac", type=float, default=0.2)
    q.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the f32 evidence forward runs (default: the card)")
    q.set_defaults(fn=cmd_quantize)
    sc = sub.add_parser("score", help="offline bulk scoring: CSV -> probabilities")
    sc.add_argument("--input", default="", help="creditcard.csv path (default: "
                    "CCFD_CSV, else the synthetic stream)")
    sc.add_argument("--output", default="", help="write proba_1 CSV here")
    sc.add_argument("--depth", type=int, default=2, help="pipelined dispatch depth")
    sc.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR,
                    help="the newest `train` step there when present (the MLP)")
    sc.add_argument("--quantized-dir", default=None,
                    help="int8 checkpoint dir (npz steps) used when CCFD_MODEL=mlp_q8 "
                    "(default: the committed checkpoint, quantized)")
    sc.add_argument("--gbt-dir", default=GBT_DIR,
                    help="tree params dir used when CCFD_MODEL=gbt")
    sc.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to score (default: the card)")
    sc.set_defaults(fn=cmd_score)
    d = sub.add_parser("demo", help="run the decision pipeline in-process")
    d.add_argument("--transactions", type=int, default=2000)
    d.add_argument("--rate", type=float, default=None,
                   help="rows a second (default: as fast as the bus takes them)")
    d.add_argument("--reply-timeout", type=float, default=2.0,
                   help="seconds a flagged customer has to reply")
    d.add_argument("--drain-s", type=float, default=30.0)
    d.add_argument("--wire-format", choices=("dict", "csv"), default="dict")
    d.add_argument("--seed", type=int, default=0, help="the customers' replies")
    d.add_argument("--train-steps", type=int, default=200)
    d.add_argument("--params", default=None,
                   help=".npz of MLP or int8 MLP params to serve (default: train the MLP)")
    d.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where to score (default: the card)")
    d.set_defaults(fn=cmd_demo)
    bus = sub.add_parser("bus", help="networked bus (the Kafka-cluster role)")
    bus.add_argument("--host", default="0.0.0.0")
    bus.add_argument("--port", type=int, default=9092)
    bus.add_argument("--dir", default=None,
                     help="durable segment-log dir (default: CCFD_BUS_DIR; none: memory)")
    bus.set_defaults(fn=cmd_bus)
    en = sub.add_parser("engine", help="KIE-shaped process engine server")
    en.add_argument("--host", default="0.0.0.0")
    en.add_argument("--port", type=int, default=8090)
    en.add_argument("--state-file", default=None,
                    help="engine snapshot: loaded at start, saved every --save-interval-s "
                    "and on SIGTERM/SIGINT")
    en.add_argument("--save-interval-s", type=float, default=5.0)
    en.set_defaults(fn=cmd_engine)
    ro = sub.add_parser("router", help="the decision router role")
    ro.add_argument("--metrics-port", type=int, default=8091)
    ro.add_argument("--workers", type=int, default=None,
                    help="partition-parallel worker loops sharing one coalesced scorer "
                    "dispatch (default: CCFD_ROUTER_WORKERS; 1 = a single router, "
                    "0 = one per bus partition)")
    ro.add_argument("--params", default=None,
                    help=".npz of MLP or int8 MLP params (default: the committed checkpoint)")
    ro.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the local scorer scores (default: the card)")
    ro.set_defaults(fn=cmd_router)
    no = sub.add_parser("notify", help="the notification service role")
    no.add_argument("--reply-prob", type=float, default=0.8)
    no.add_argument("--approve-prob", type=float, default=0.7)
    no.add_argument("--seed", type=int, default=0)
    no.add_argument("--metrics-port", type=int, default=8080)
    no.set_defaults(fn=cmd_notify)
    pr = sub.add_parser("producer", help="the transaction producer role")
    pr.add_argument("--limit", type=int, default=None)
    pr.add_argument("--rate", type=float, default=None)
    pr.add_argument("--wire-format", choices=("dict", "csv"), default="csv")
    pr.set_defaults(fn=cmd_producer)
    au = sub.add_parser("audit", help="reconstruct one decision by tx id (the decision "
                        "provenance plane), or tail the engine's audit event stream")
    au.add_argument("tx_id", nargs="?", default=None,
                    help="transaction id (or partition:offset uid) to reconstruct; "
                    "omit to tail the engine's audit stream")
    au.add_argument("--dir", default="", help="audit log dir (default: CCFD_AUDIT_DIR)")
    au.add_argument("--url", default="",
                    help="live exporter endpoint: fetch the record, the incident bundle "
                    "and the kept trace over HTTP before the on-disk artifacts")
    au.add_argument("--json", action="store_true",
                    help="emit the full reconstruction document as JSON")
    au.add_argument("--lifecycle-dir", default="",
                    help="lifecycle state dir for the lineage join (default: "
                    "CCFD_LIFECYCLE_DIR)")
    au.add_argument("--incident-dir", default="",
                    help="incident bundle dir for the incident join (default: "
                    "CCFD_INCIDENT_DIR)")
    au.add_argument("--topic", default="", help="default: CCFD_AUDIT_TOPIC")
    au.add_argument("--group", default="audit-tail",
                    help="consumer group (offsets persist per group)")
    au.add_argument("--follow", action="store_true", help="keep consuming")
    au.add_argument("--limit", type=int, default=0, help="stop after N events")
    au.set_defaults(fn=cmd_audit)
    inv = sub.add_parser("investigate",
                         help="investigator simulation over the KIE REST contract")
    inv.add_argument("--engine-url", default="",
                     help="engine REST base (default: KIE_SERVER_URL)")
    inv.add_argument("--rate", type=float, default=50.0,
                     help="max task completions per second")
    inv.add_argument("--trust", type=float, default=0.9,
                     help="follow the console pre-fill at/above this prediction confidence")
    inv.add_argument("--fraud-rate", type=float, default=0.05,
                     help="independent-verdict fraud probability")
    inv.add_argument("--seed", type=int, default=0)
    inv.add_argument("--metrics-port", type=int, default=8082)
    inv.set_defaults(fn=cmd_investigate)
    tk = sub.add_parser("tasks", help="investigator workflow: list/complete engine user tasks")
    tk.add_argument("--engine-url", default="",
                    help="engine REST base (default: KIE_SERVER_URL)")
    tk.add_argument("--status", default="open")
    tk.add_argument("--complete", type=int, default=None, metavar="TASK_ID")
    tk.add_argument("--outcome", default=None, help="approved | rejected (with --complete)")
    tk.set_defaults(fn=cmd_tasks)
    rp = sub.add_parser("replay", help="bulk replay & backtest: re-score a recorded audit "
                        "window with verdict-parity conservation (replay plane)")
    rp.add_argument("--dir", default="",
                    help="audit log dir holding the recorded window (default: CCFD_AUDIT_DIR)")
    rp.add_argument("--since-seq", type=int, default=None,
                    help="window start (DecisionRecord seq, inclusive)")
    rp.add_argument("--until-seq", type=int, default=None,
                    help="window end (DecisionRecord seq, inclusive)")
    rp.add_argument("--from-incident", default="",
                    help="incident bundle JSON: re-drive the decisions in flight across "
                    "the breach window")
    rp.add_argument("--what-if-threshold", type=float, default=None,
                    help="host-side backtest: which recorded decisions flip under this "
                    "FRAUD_THRESHOLD (never touches the live path)")
    rp.add_argument("--live", action="store_true",
                    help="bring the platform up and re-produce the window through the live "
                    "serving path under bulk admission")
    rp.add_argument("--cr", default="",
                    help="CR file for --live (default: a minimal replay platform over --dir)")
    rp.add_argument("--state-dir", default="",
                    help="durable replay-cursor dir (default: CCFD_REPLAY_DIR)")
    rp.add_argument("--window-id", default="",
                    help="explicit window id (cursor key; default: the seq range)")
    rp.add_argument("--no-resume", action="store_true",
                    help="ignore an existing cursor and restart the window from its first row")
    rp.add_argument("--json", action="store_true",
                    help="emit the full report (bounded findings included) as JSON")
    rp.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where --live's scorer scores (default: the card)")
    rp.set_defaults(fn=cmd_replay)
    lc = sub.add_parser("lifecycle",
                        help="model-lifecycle lineage + audit trail (versions console)")
    lc.add_argument("--dir", default="", help="lifecycle state dir (default: CCFD_LIFECYCLE_DIR)")
    lc.add_argument("--audit", action="store_true", help="print the transition audit trail too")
    lc.add_argument("--version", type=int, default=0,
                    help="restrict the audit trail to one version id")
    lc.add_argument("--json", action="store_true", help="emit the full lineage+audit as JSON")
    lc.set_defaults(fn=cmd_lifecycle)
    an = sub.add_parser("analyze", help="dataset analytics report (Spark/notebook analog)")
    an.add_argument("--nbins", type=int, default=32)
    an.add_argument("--top-corr", type=int, default=8)
    an.add_argument("--drift-split", action="store_true",
                    help="also run a first-half vs second-half drift self-check")
    an.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the summary runs (default: the card)")
    an.set_defaults(fn=cmd_analyze)
    up = sub.add_parser("up", help="bring up the platform from a CR file")
    up.add_argument("-f", "--file", default=PORT_CR)
    up.add_argument("--exit-after-producer", action="store_true")
    up.add_argument("--drain-s", type=float, default=120.0)
    up.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the scorer scores (default: the card)")
    up.set_defaults(fn=cmd_up)
    mf = sub.add_parser("manifests", help="emit k8s manifests from the CR")
    mf.add_argument("-f", "--file", default=PORT_CR)
    mf.add_argument("-o", "--out", required=True, help="directory to write the manifests to")
    mf.set_defaults(fn=cmd_manifests)
    st = sub.add_parser("store", help="S3-shaped object store (serve/put/ls)")
    st.add_argument("action", choices=("serve", "put", "ls"))
    st.add_argument("--root", default=None, help="persistence dir (serve)")
    st.add_argument("--host", default="127.0.0.1")
    st.add_argument("--port", type=int, default=9000)
    st.add_argument("--endpoint", default=None,
                    help="store endpoint (overrides the s3endpoint env)")
    st.add_argument("--file", default=None, help="local file to upload (put)")
    st.set_defaults(fn=cmd_store)
    lg = sub.add_parser("loadgen", help="drive a deployed scorer's REST endpoint "
                        "(JSON report)")
    lg.add_argument("--url", default="http://127.0.0.1:8000")
    lg.add_argument("--clients", type=int, default=8)
    lg.add_argument("--rows", type=int, default=16)
    lg.add_argument("--seconds", type=float, default=10.0)
    lg.add_argument("--path", default=None, help="request path (default: the URL's own "
                    "path, else /api/v0.1/predictions)")
    lg.set_defaults(fn=cmd_loadgen)
    dr = sub.add_parser("doctor", help="environment and device health report (JSON)")
    dr.add_argument("--probe-s", type=float, default=30.0,
                    help="device probe timeout (the probe runs in a subprocess)")
    dr.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    dr.add_argument("--quantized-dir", default=None)
    dr.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the device to probe (default: the card)")
    dr.set_defaults(fn=cmd_doctor)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
