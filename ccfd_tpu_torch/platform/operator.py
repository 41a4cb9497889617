"""Platform operator: CR-shaped spec -> running pipeline, in run-book order.

The port of ccfd_tpu/platform/operator.py. ``PlatformSpec`` parses the
reference's CR (``deploy/platform_cr.yaml``: one block per component, each
with ``enabled`` and free-form options, the same components on by default)
and ``Platform`` brings the components up in the reference's run-book
order, every long-lived service under the ``Supervisor`` (restart on
crash), with health probes and one Prometheus exporter:

   0  the fault plans: edge (CR ``chaos.faults`` with chaos on, or
      CCFD_FAULTS), device (``chaos.device_faults`` or CCFD_DEVICE_FAULTS)
      and storage (``chaos.storage_faults`` or CCFD_STORAGE_FAULTS), the
      last two installed process-wide; a CR plan under
      ``chaos.fault_interval_s`` starts inactive and the chaos monkey
      duty-cycles it. Then the durability block (the ``StoragePinGate``
      the router's heal-gate seam binds), overload control, tracing (and
      the trace-correlated JSON logs), the stage profiler, the device
      telemetry plane, and 0f the decision provenance plane (``audit``:
      one ``AuditLog`` shared by every router worker, its flusher a
      supervised service)
   1  store (the S3-shaped object store, seeded with the dataset)
   2  bus (in process, durable with ``log_dir``; or a client of ``url``:
      ``http://`` for a ``bus`` role, ``kafka://`` for a cluster)
  2b  mesh (``mesh.devices`` > 1: the named (data, fsdp, tp) mesh of
      logical shards, N CPU shards on a CPU platform or the first N
      cards, clamped to those visible, and its partitioner from
      ``param_partition``; the scorer, the
      seq scorer (``seq_parallel``), the trainer and the analytics engine
      are built against it, and the router pool's pause barrier arms the
      partitioner's publish gate (6); 1 is inert)
   3  scorer (``train_steps`` of ``fit_mlp`` on the card first; the REST
      front with ``rest``); for ``model: seq|seq_q8`` the history-aware
      ``SeqScorer`` on the committed ``assets/seq_init.npz`` (the
      reference's ``seq.init(PRNGKey(0))`` with its normalizer), which the
      router feeds records and the REST front does not serve
  3b  the model lifecycle (``lifecycle``: version store, candidate
      checkpoints, shadow tap, evaluator, canary gate; default on, as the
      reference's CR has it): the router's score lane is wrapped with the
      shadow tap inside and the canary gate outside (a ``SeqScorer``
      offers its assembled histories to the tap and serves the canary
      slice itself), one scorer-edge breaker is shared by the ladder and
      the canary guardrail, the audit
      records join the champion's lineage, the heal ladder's respawn rung
      restores the champion checkpoint, and the trainer (7) hands its
      candidates to the controller
   4  engine (``state_file``, ``rest``; ``usertask_model``: the learned
      user-task model as its prediction service and task listener, saved
      to ``usertask_state_file``), 5 notify, 6 router (the decision
      plane with ``scorer.fused_decision``; the replay plane's verdict tap
      on the audit seam and the supervised ``ReplayService`` with
      ``replay`` or CCFD_REPLAY; with ``fleet`` the ledger tap inside it
      and commit-after-route on the tx consumer), 6b crash recovery
      (``engine.crash_recovery``: the ``CheckpointCoordinator``; a seq
      scorer's histories join the cut as ``history``), 6c the
      investigator (re-pointed at a restored engine)
   7  retrain (the ``OnlineTrainer``: candidates to the lifecycle, or
      ``swap_params`` with ``retrain.direct_swap`` or the lifecycle off),
      7b analytics (``analytics``: the drift monitor on the transaction
      topic, its reference summarized on the card from the dataset), 7c
      the SLO engine, 7c2 the capacity observatory (``capacity``: the
      queueing model over the stage profile, seeded with the live
      actuators), 7d the incident flight recorder (``incident``: the
      snapshot ring; bundles on the SLO breach edge, the heal supervisor's
      quarantines, the storage quarantines; watchdog kills snapshot; the
      audit records carry the open bundle's id), 7e the device heal
      supervisor (``heal``: default on with a local scorer, CCFD_HEAL=0
      kills it; the router's gate is the storage pin composed with it)
   8  monitoring (the exporter: /prometheus, /profile, /healthz,
      /debug/device, /debug/profile, /decisions, /incidents, /capacity)
      and health (/healthz, /readyz); 8b the fleet member (``fleet``, off
      by default, over a networked ``bus.url``: heartbeat endpoint, gossip
      loop, admission share, parity gate composed into the router's gate,
      the aggregator's member-kill bundles)
   9  the supervisor starts, readiness is awaited, then the producer;
  10  chaos (opt-in): the monkey's seeded kills of supervised services and
      its fault storms.

The scorer serves on the card (``device=None``) unless the caller names
the CPU, as every entry point of the port. The knobs that select a part
the port does not have are refused by name, all at once, before anything
starts (``refused``). Where the reference degrades a CR with a warning,
the port degrades it the same way, with the reference's warning:

- retrain under a seq scorer is skipped: no ``retrain`` service;
- ``scorer.fused_decision`` without an in-process row scorer (remote or
  seq), with the lifecycle (the canary gate overrides scores after a fused
  verdict fired), or over a mesh scorer (``serving/fused.py``: its decision
  program has no sharded composition) serves the staged path, B1 and the
  host rules; ``scorer.fused_decision_strict`` raises instead, before any
  service starts;
- ``mesh.devices`` above the visible CUDA devices clamps to them, drops
  to pure data parallel when the clamped count breaks ``fsdp`` x ``tp``
  and turns sequence parallelism off where it cannot run
  (``resolve_mesh_shape``); 0 means every visible CUDA device, and one
  device serves unsharded. On a CPU platform N names N logical CPU shards
  (the reference's virtual CPU devices), and 0 serves unsharded;
- ``CCFD_GRAPH_CR`` is not read: the operator serves ``scorer.model``
  (``serve`` loads graphs).

None of these moves a request off the card: a clamped mesh is the card,
the staged path is B1.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any, Mapping

from ccfd_tpu_torch.config import Config


@dataclasses.dataclass(frozen=True)
class ComponentSpec:
    enabled: bool = True
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def opt(self, key: str, default: Any = None) -> Any:
        return self.options.get(key, default)


# the reference's component list (ccfd_tpu/platform/operator.py:35-95)
_COMPONENTS = (
    "store", "bus", "scorer", "engine", "notify", "router", "producer",
    "retrain", "investigator", "analytics", "monitoring", "health", "chaos",
    "tracing", "lifecycle", "overload", "slo", "device", "incident", "heal",
    "mesh", "durability", "audit", "fleet", "replay", "capacity",
)
# absent blocks default on, except these (the reference's choice)
_OFF_BY_DEFAULT = ("producer", "store", "chaos", "investigator", "fleet", "replay")

# components the reference's operator builds that the port does not have,
# with the ROADMAP item that ports each (none since A15b)
REFUSED_COMPONENTS: Mapping[str, str] = {}
# scorer models the operator serves (every other is refused or unknown)
SCORER_MODELS = ("mlp", "mlp_q8", "logreg", "modelfull", "gbt", "gbt_mxu", "seq", "seq_q8")
SEQ_MODELS = ("seq", "seq_q8")
# the reference operator's seq params: seq.init(PRNGKey(0)) normalized on
# synthetic_dataset(n=4096, fraud_rate=0.01, seed=0), exported as an npz
SEQ_INIT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "seq_init.npz")


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    components: Mapping[str, ComponentSpec]
    cfg: Config

    @staticmethod
    def from_cr(cr: Mapping[str, Any], cfg: Config | None = None) -> "PlatformSpec":
        """Parse a CR-shaped mapping: top-level ``spec`` holds one block per
        component, each with ``enabled`` plus free-form options; a bare
        bool is the block's ``enabled``."""
        spec = cr.get("spec", cr)
        comps: dict[str, ComponentSpec] = {}
        for name in _COMPONENTS:
            block = spec.get(name, {})
            if isinstance(block, bool):
                block = {"enabled": block}
            comps[name] = ComponentSpec(
                enabled=bool(block.get("enabled", name not in _OFF_BY_DEFAULT)),
                options={k: v for k, v in block.items() if k != "enabled"},
            )
        return PlatformSpec(components=comps, cfg=cfg or Config.from_env())

    @staticmethod
    def from_yaml(path: str, cfg: Config | None = None) -> "PlatformSpec":
        import yaml

        with open(path) as f:
            return PlatformSpec.from_cr(yaml.safe_load(f) or {}, cfg=cfg)

    def component(self, name: str) -> ComponentSpec:
        return self.components.get(name, ComponentSpec(enabled=False))

    def refused(self) -> list[str]:
        """Every part of this spec (and of its config's environment) the
        port does not have, each named; [] when the platform can come up."""
        out = [f"{name} ({item})" for name, item in REFUSED_COMPONENTS.items()
               if self.component(name).enabled]
        out.extend(self.cfg.unported())
        return out


def refuse(spec: PlatformSpec) -> None:
    """Raise ``NotImplementedError`` naming every refused part of ``spec``."""
    refused = spec.refused()
    if refused:
        raise NotImplementedError(
            "refused by the port; disable or unset each to bring the platform up: "
            + "; ".join(refused))


def resolve_mesh_shape(n: int, avail: int, fsdp: int, tp: int,
                       seq_parallel: str) -> tuple[int, int, int, str]:
    """(devices, fsdp, tp, seq_parallel) that ``avail`` devices can serve
    for a CR's ``mesh:`` block, as the reference's operator resolves it
    (``ccfd_tpu/platform/operator.py:825-860``), each change logged with
    the reference's warning: 0 is every device; a count above ``avail``
    clamps to it, and drops to pure data parallel (fsdp = tp = 1) when
    the clamped count is not a multiple of fsdp x tp; sequence
    parallelism needs a tp axis > 1 and more than one device. A result of
    1 device serves unsharded."""
    log_ = logging.getLogger(__name__)
    if n == 0:
        n = avail
    if n > avail:
        # a CR sized for a larger machine still serves, clamped, loudly
        log_.warning("mesh.devices=%d but only %d local devices; clamping (a CPU "
                     "platform serves N logical CPU shards)", n, avail)
        n = avail
        if n % (fsdp * tp) != 0:
            log_.warning("clamped mesh: %d devices not divisible by fsdp*tp=%d; "
                         "serving pure data-parallel instead", n, fsdp * tp)
            fsdp = tp = 1
    if tp <= 1 and seq_parallel != "none":
        if n > 1:
            log_.warning("mesh.seq_parallel=%s needs a tp axis > 1 (have tp=%d); "
                         "disabling sequence parallelism", seq_parallel, tp)
        seq_parallel = "none"
    if n <= 1:
        seq_parallel = "none"
    return n, fsdp, tp, seq_parallel


class Platform:
    """Brings a PlatformSpec up/down; owns every component's lifecycle."""

    def __init__(self, spec: PlatformSpec, device: Any = None):
        self.spec = spec
        self.cfg = spec.cfg
        self.device = device  # the scorer's; None = the card
        self.registries: dict[str, Any] = {}
        self.supervisor = None
        self.broker = None
        self.scorer = None
        self.engine = None
        self.engine_server = None
        self.engine_port = None
        self.store_server = None
        self.prediction_server = None
        self.prediction_host = "127.0.0.1"
        self.prediction_port = 0
        self.exporter = None
        self.health_server = None
        self.fault_plan = None  # runtime/faults.FaultPlan when configured
        self.device_fault_plan = None  # runtime/faults.DeviceFaultPlan
        self.storage_fault_plan = None  # runtime/faults.StorageFaultPlan
        self._device_storm_driven = False
        self._storage_storm_driven = False
        self.chaos = None  # runtime/chaos.ChaosMonkey when chaos is on
        self.heal = None  # runtime/heal.DeviceSupervisor when heal is on
        self.audit = None  # observability/audit.AuditLog when audit is on
        self.trace_sink = None  # observability/trace.SpanSink when enabled
        self.profiler = None    # observability/profile.StageProfiler
        self.slo = None         # observability/slo.SLOEngine when enabled
        self.capacity = None    # observability/capacity.CapacityModel when enabled
        self.recorder = None    # observability/incident.FlightRecorder when enabled
        self.device_telemetry = None  # observability/device.DeviceTelemetry
        self.storage_gate = None  # runtime/durability.StoragePinGate
        self.fused_decision = None  # serving/fused.FusedDecisionScorer
        self._overload = None   # runtime/overload.OverloadControl (router)
        self.router = None
        self.recovery = None  # CheckpointCoordinator when crash_recovery on
        self.investigator = None  # process/investigator.InvestigatorService
        self.usertask_model = None  # process/usertask_model.OnlineUserTaskModel
        self.lifecycle = None   # lifecycle.LifecycleController when enabled
        self.analytics = None   # analytics/engine.DriftMonitor when enabled
        self.replay = None      # replay/service.ReplayService when enabled
        self.replay_tap = None  # replay/service.ReplayVerdictTap (replay on)
        self.fleet = None       # fleet/member.FleetMember when fleet is on
        self.fleet_ledger = None  # fleet/ledger.FleetLedgerTap (fleet on)
        self.mesh = None         # parallel/mesh.Mesh when the mesh is on (devices > 1)
        self.partitioner = None  # parallel/partition.Partitioner over it
        self._mesh_param_partition = "replicated"
        self._mesh_seq_parallel = "none"
        self._usertask_state_file = None
        self._engine_factory = None
        self._engine_state_file = None
        self._producer_done = threading.Event()
        self._broker_is_client = False
        self._collectors: list = []
        self._up = False

    # -- bring-up, in the run-book's dependency order ---------------------
    def up(self, wait_ready_s: float = 30.0) -> "Platform":
        from ccfd_tpu_torch.runtime.supervisor import Supervisor

        if self._up:
            return self
        refuse(self.spec)
        spec, cfg = self.spec, self.cfg
        self._refuse_strict_decision()
        if cfg.graph_cr:
            logging.getLogger(__name__).warning(
                "CCFD_GRAPH_CR=%s is not read by the operator: it serves scorer.model "
                "(`serve` loads the graph)", cfg.graph_cr)
        self.supervisor = Supervisor()

        # 0. fault plans (runtime/faults.py), the reference's opt-in rules:
        # a CR plan only with the chaos block on (chaos is always opt-in),
        # else the env's standing plan. A CR plan under a storm interval
        # (chaos.fault_interval_s) starts inactive and the monkey drives
        # its duty cycle (step 10); a standing env plan stays ACTIVE.
        self._up_fault_plans()

        # 0b. durability: the CR block overlays the CCFD_STORAGE_* knobs, the
        # ccfd_storage_* counters land in a scraped registry, and the
        # storage pin the router's heal-gate seam binds (step 6)
        from ccfd_tpu_torch.runtime import durability

        dur_spec = spec.component("durability")
        if dur_spec.enabled:
            durability.configure(
                retain=int(dur_spec.opt("retain", cfg.storage_retain)),
                fsync=bool(dur_spec.opt("fsync", cfg.storage_fsync)),
                sweep=bool(dur_spec.opt("sweep", cfg.storage_sweep)))
            durability.bind_registry(self._registry("storage"))
            self.storage_gate = durability.StoragePinGate(registry=self._registry("storage"))
        else:
            durability.configure(retain=0, sweep=False)

        # 0a. overload control: the CR block overlays the CCFD_OVERLOAD_*
        # knobs once, for the REST gate (step 3) and the router (step 6)
        ov_spec = spec.component("overload")
        ov_overrides: dict[str, Any] = {}
        if not ov_spec.enabled:
            ov_overrides["overload_enabled"] = False
        else:
            for opt, field in (
                ("target_ms", "overload_target_ms"),
                ("serve_target_ms", "overload_serve_target_ms"),
                ("min_inflight", "overload_min_inflight"),
                ("max_inflight", "overload_max_inflight"),
                ("codel_target_ms", "overload_codel_target_ms"),
                ("serve_codel_target_ms", "overload_serve_codel_target_ms"),
                ("rest_queue_rows", "overload_rest_queue_rows"),
                ("dispatch_deadline_ms", "overload_dispatch_deadline_ms"),
            ):
                if ov_spec.opt(opt) is not None:
                    ov_overrides[field] = type(getattr(cfg, field))(ov_spec.opt(opt))
        if ov_overrides:
            self.cfg = cfg = dataclasses.replace(cfg, **ov_overrides)
            # the CR may select the batcher's queue policies: still refused
            refuse(dataclasses.replace(spec, cfg=cfg))

        # 0b. distributed tracing: one tail-sampling sink for every
        # component tracer, and the trace-correlated JSON logs
        tr_spec = spec.component("tracing")
        if tr_spec.enabled:
            from ccfd_tpu_torch.observability.trace import SpanSink

            self.trace_sink = SpanSink(
                sample=float(tr_spec.opt("sample", cfg.trace_sample)),
                slow_s=float(tr_spec.opt("slow_ms", cfg.trace_slow_ms)) / 1e3,
                max_retained=int(tr_spec.opt("max_retained", 256)),
                registry=self._registry("tracing"))
            if tr_spec.opt("json_logs", True):
                from ccfd_tpu_torch.observability import slog

                slog.configure("platform")

        # 0c. the stage profiler: fed by the router, the REST path, the
        # decision plane and the span sink; the builds' attribution
        slo_spec = spec.component("slo")
        if slo_spec.enabled and cfg.slo_enabled:
            from ccfd_tpu_torch.observability.profile import StageProfiler

            self.profiler = StageProfiler(registry=self._registry("slo"),
                                          overload_registry=self._registry("router"))
            if self.trace_sink is not None:
                self.trace_sink.add_listener(self.profiler.on_span)
            if bool(slo_spec.opt("compile_events", True)):
                self.profiler.arm_compile_listener()

        # 0d. device & transfer telemetry: the scorer stages through it
        dev_spec = spec.component("device")
        if dev_spec.enabled and cfg.device_enabled:
            from ccfd_tpu_torch.observability.device import DeviceTelemetry

            self.device_telemetry = DeviceTelemetry(registry=self._registry("device"))

        # 0f. the decision provenance plane: ONE AuditLog every router
        # worker stamps into, built before the router; its flusher is a
        # supervised service. CCFD_AUDIT=0 (or audit.enabled: false) kills
        # it: nothing stamped, /decisions 404s
        aud_spec = spec.component("audit")
        if aud_spec.enabled and cfg.audit_enabled:
            self._up_audit(aud_spec)

        # 1. store (Ceph/S3, reference README.md:136-269): serves the dataset
        if spec.component("store").enabled:
            self._up_store()

        # 2. bus (Kafka, README.md:87-134)
        if spec.component("bus").enabled:
            self._up_bus()
        else:
            needs_bus = [n for n in ("engine", "notify", "router", "retrain", "producer")
                         if spec.component(n).enabled]
            if needs_bus:
                raise ValueError(f"bus disabled in CR but required by: {needs_bus}")

        # 2b. the mesh and its partitioner (parallel/partition.py): the
        # scorer, the seq scorer and the trainer are built against it
        if spec.component("mesh").enabled:
            self._up_mesh(spec.component("mesh"))

        # 3. model serving (Seldon, README.md:271-301)
        if spec.component("scorer").enabled:
            self._up_scorer()

        # 3b. the model lifecycle: before the router, whose score lane it
        # wraps, and before retrain, whose candidates it governs; needs the
        # local scorer and the bus (shadow pairs and labels ride topics)
        if (spec.component("lifecycle").enabled and self.scorer is not None
                and self.broker is not None):
            self._up_lifecycle()

        # 4. process engine (KIE, README.md:345-408)
        if spec.component("engine").enabled:
            self._up_engine()

        # 5. notification service (README.md:410-422)
        if spec.component("notify").enabled:
            self._up_notify()

        # 6. router (README.md:424-459)
        if spec.component("router").enabled:
            self._up_router()

        # 6b. engine crash recovery: aligned checkpoints + bus rewind
        if (spec.component("engine").enabled
                and spec.component("engine").opt("crash_recovery", False)
                and self.engine is not None and self.router is not None):
            self._up_crash_recovery()

        # 6c. the investigator simulation (the demo's Business Central
        # humans): drains the task queue and feeds the user-task model
        if spec.component("investigator").enabled and self.engine is not None:
            self._up_investigator()

        # 7. online retrain: candidates to the lifecycle (3b), or the direct
        # swap with the lifecycle off or retrain.direct_swap. The trainer's
        # step is the MLP's: under a seq scorer retrain is skipped, as the
        # reference skips it
        if spec.component("retrain").enabled and self.scorer is not None:
            from ccfd_tpu_torch.serving.history import SeqScorer

            if isinstance(self.scorer, SeqScorer):
                logging.getLogger(__name__).warning(
                    "retrain enabled but scorer model is 'seq': online retrain targets "
                    "the MLP family; skipping retrain")
            else:
                self._up_retrain()

        # 7b. analytics: the drift monitor (the notebooks + Spark analog)
        if spec.component("analytics").enabled and self.broker is not None:
            self._up_analytics()

        # 7c. SLO engine over the components whose histograms it reads
        if self.profiler is not None:
            from ccfd_tpu_torch.observability.slo import SLOEngine
            from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

            self.slo = SLOEngine.from_config(
                cfg, self.registries, self._registry("slo"), profiler=self.profiler,
                options=slo_spec.options, telemetry=self.device_telemetry)
            interval = float(slo_spec.opt("interval_s", cfg.slo_interval_s))
            self.supervisor.add_thread_service(
                "slo", lambda: self.slo.run(interval_s=interval), self.slo.stop,
                policy=RestartPolicy.ALWAYS, reset=self.slo.reset)

        # 7c2. the capacity observatory: the queueing model fitted over the
        # live stage profile, served at /capacity and /capacity/whatif;
        # CCFD_CAPACITY=0 (or capacity.enabled: false) kills it
        cap_spec = spec.component("capacity")
        if cap_spec.enabled and cfg.capacity_enabled and self.profiler is not None:
            self._up_capacity(cap_spec)

        # 7d. the incident flight recorder: the snapshot ring as a
        # supervised service; the SLO breach edge, the heal supervisor, the
        # dispatch watchdog and the storage quarantines feed it; served at
        # /incidents. CCFD_INCIDENT=0 (or incident.enabled: false) kills it
        inc_spec = spec.component("incident")
        if inc_spec.enabled and cfg.incident_enabled:
            self._up_incident(inc_spec)

        # 7e. the device heal supervisor: default on with a local scorer;
        # CCFD_HEAL=0 (or heal.enabled: false) kills the plane
        heal_spec = spec.component("heal")
        if heal_spec.enabled and cfg.heal_enabled and self.scorer is not None:
            self._up_heal(heal_spec)

        # 8. monitoring (README.md:487-537)
        if spec.component("monitoring").enabled:
            from ccfd_tpu_torch.metrics.exporter import MetricsExporter

            mon = spec.component("monitoring")
            self.exporter = MetricsExporter(
                self.registries, host=mon.opt("host", "127.0.0.1"),
                port=int(mon.opt("port", 0)), sink=self.trace_sink,
                collectors=self._collectors, profiler=self.profiler,
                telemetry=self.device_telemetry, health=self._health_verdict,
                audit=self.audit, recorder=self.recorder,
                capacity=self.capacity).start()
            self._wire_memory_probes()

        if spec.component("health").enabled:
            from ccfd_tpu_torch.runtime.health import HealthServer

            h = spec.component("health")
            self.health_server = HealthServer(
                self.supervisor, host=h.opt("host", "127.0.0.1"),
                port=int(h.opt("port", 0))).start()

        # 8b. the fleet member (fleet/member.py): heartbeat endpoint, gossip
        # loop and the fleet actuators (admission rescale, parity
        # quarantine, aggregator duty). Built after everything it observes
        # (router, overload, scorer, recorder) and before the supervisor
        # starts, so the gossip loop runs supervised
        fl_spec = spec.component("fleet")
        if fl_spec.enabled and self.broker is not None:
            self._up_fleet(fl_spec)

        self.supervisor.start()
        if not self.supervisor.wait_ready(timeout_s=wait_ready_s):
            raise TimeoutError(f"platform not ready after {wait_ready_s}s: "
                               f"{self.supervisor.status()}")

        # 9. producer last (README.md:461-485): starts the traffic
        if spec.component("producer").enabled:
            self._up_producer()

        # 10. chaos (opt-in): seeded kills of supervised services and the
        # fault storms, so the recovery machinery is exercised, not trusted
        if spec.component("chaos").enabled:
            self._up_chaos()
        self._up = True
        return self

    # -- per-component builders -------------------------------------------
    def _registry(self, name: str):
        from ccfd_tpu_torch.metrics.prom import Registry

        if name not in self.registries:
            self.registries[name] = Registry()
            if self.exporter is not None:  # registries created post-start
                self.exporter.add(name, self.registries[name])
        return self.registries[name]

    def _tracer(self, component: str):
        """A component tracer on the component's scraped registry and the
        shared sink; None with tracing off."""
        if self.trace_sink is None:
            return None
        from ccfd_tpu_torch.observability.trace import Tracer

        return Tracer(self._registry(component), component=component, sink=self.trace_sink)

    def _up_fault_plans(self) -> None:
        from ccfd_tpu_torch.runtime import faults

        cfg = self.cfg
        chaos = self.spec.component("chaos")
        seed = int(chaos.opt("seed", 0))
        storm = chaos.opt("fault_interval_s", None) if chaos.enabled else None
        edge_text = (chaos.opt("faults", "") if chaos.enabled else "") or cfg.faults_spec
        if edge_text:
            self.fault_plan = faults.FaultPlan.from_string(
                edge_text, seed=seed, active=storm is None)
        # the device plan: installed process-wide, because its seams (the
        # scorers' launch and staging copies, the telemetry overlay) sit
        # inside helpers no injector proxy can wrap. Only a CR plan under a
        # storm interval is the monkey's to duty-cycle
        cr_dev = chaos.opt("device_faults", "") if chaos.enabled else ""
        self._device_storm_driven = bool(cr_dev) and storm is not None
        if cr_dev or cfg.device_faults_spec:
            self.device_fault_plan = faults.DeviceFaultPlan.from_string(
                cr_dev or cfg.device_faults_spec, seed=seed,
                active=not self._device_storm_driven)
            faults.install_device_faults(self.device_fault_plan)
        # the storage plan: drawn inside durability.atomic_write_bytes and
        # the audit log's append, so also process-wide
        cr_sto = chaos.opt("storage_faults", "") if chaos.enabled else ""
        self._storage_storm_driven = bool(cr_sto) and storm is not None
        if cr_sto or cfg.storage_faults_spec:
            self.storage_fault_plan = faults.StorageFaultPlan.from_string(
                cr_sto or cfg.storage_faults_spec, seed=seed,
                active=not self._storage_storm_driven)
            faults.install_storage_faults(self.storage_fault_plan)

    def _up_audit(self, c: ComponentSpec) -> None:
        from ccfd_tpu_torch.observability.audit import AuditLog
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        cfg = self.cfg
        self.audit = AuditLog(
            dir=(c.opt("dir", cfg.audit_dir) or None),
            max_records=int(c.opt("ring", cfg.audit_ring)),
            segment_bytes=int(c.opt("segment_bytes", cfg.audit_segment_bytes)),
            retain_segments=int(c.opt("segments", cfg.audit_segments)),
            registry=self._registry("audit"))
        flush_s = float(c.opt("flush_interval_s", cfg.audit_flush_interval_s))
        audit = self.audit
        self.supervisor.add_thread_service(
            "audit", lambda: audit.run(interval_s=flush_s), audit.stop,
            policy=RestartPolicy.ALWAYS, reset=audit.reset)

    def _up_heal(self, c: ComponentSpec) -> None:
        """The DeviceSupervisor over the local scorer: canaries bounded by
        the router's dispatch watchdog, quarantine pins the router's ladder
        to the host tier (the gate sits above the breaker), and the
        re-promotion is warm. The router's gate composes it with the storage
        pin: an unverifiable-params pin blocks the host tier too, the
        supervisor only the card. With the lifecycle up the respawn rung
        restores the champion's checkpoint (under the controller's lock, so
        a respawn racing a rollback leaves one consistent tree); without it
        the rung re-publishes the scorer's own params. With the incident
        plane on, quarantines and re-promotions dump bundles."""
        from ccfd_tpu_torch.runtime.heal import DeviceSupervisor
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        cfg = self.cfg
        self.heal = DeviceSupervisor(
            self.scorer,
            registry=self._registry("heal"),
            breaker=getattr(self.router, "_breaker", None),
            telemetry=self.device_telemetry,
            profiler=self.profiler,
            recorder=self.recorder,
            overload=self._overload,
            canary_rows=int(c.opt("canary_rows", 16)),
            canary_deadline_ms=float(c.opt("canary_deadline_ms",
                                           cfg.heal_canary_deadline_ms)),
            suspect_strikes=int(c.opt("suspect_strikes", cfg.heal_suspect_strikes)),
            probation_canaries=int(c.opt("probation_canaries",
                                         cfg.heal_probation_canaries)),
            parity_tol=float(c.opt("parity_tol", cfg.heal_parity_tol)),
            oom_ratio=float(c.opt("oom_ratio", cfg.heal_oom_ratio)),
            compile_storm_per_s=float(c.opt("compile_storm_per_s",
                                            cfg.heal_compile_storm_per_s)),
            backoff_base_s=float(c.opt("backoff_base_s", cfg.heal_backoff_base_s)),
            backoff_cap_s=float(c.opt("backoff_cap_s", cfg.heal_backoff_cap_s)),
            flap_window_s=float(c.opt("flap_window_s", cfg.heal_flap_window_s)),
            respawn_fn=(self.lifecycle.restore_champion
                        if self.lifecycle is not None else None))
        if self.router is not None:
            if self.storage_gate is not None:
                from ccfd_tpu_torch.runtime.durability import ComposedHealGate

                self.router.set_heal_gate(ComposedHealGate(self.storage_gate, self.heal))
            else:
                self.router.set_heal_gate(self.heal)
        interval = float(c.opt("interval_s", cfg.heal_interval_s))
        heal = self.heal
        self.supervisor.add_thread_service(
            "heal", lambda: heal.run(interval_s=interval), heal.stop,
            policy=RestartPolicy.ALWAYS, reset=heal.reset)

    def _up_fleet(self, c: ComponentSpec) -> None:
        """The FleetMember over this platform: the router's tx consumers
        (ownership and epoch), the router registry's accounting counters,
        the served params' fingerprint, the flight recorder (the
        aggregator's kill bundles) and, with a fleet-wide bound, the
        overload plane's budget. Its parity gate composes with the storage
        pin and the heal supervisor on the router's gate: any quarantine
        pins down, and a stale champion blocks the host tier too."""
        from ccfd_tpu_torch.fleet.member import FleetMember
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        cfg = self.cfg
        member = str(c.opt("member", cfg.fleet_member) or f"member-{os.getpid()}")
        peers = c.opt("peers", None)
        if peers is None:
            peers = [p.strip() for p in cfg.fleet_peers.split(",") if p.strip()]
        fingerprint_fn = None
        if self.scorer is not None and hasattr(self.scorer, "params"):
            from ccfd_tpu_torch.params import params_fingerprint

            scorer = self.scorer
            fingerprint_fn = lambda: params_fingerprint(scorer.params)  # noqa: E731
        router = self.router

        def consumers_fn():
            if router is None:
                return []
            if hasattr(router, "workers"):  # ParallelRouter pool
                return [w._tx_consumer for w in router.workers
                        if getattr(w, "_tx_consumer", None) is not None]
            tx = getattr(router, "_tx_consumer", None)
            return [tx] if tx is not None else []

        router_reg = self.registries.get("router")

        def counters_fn():
            def tot(name):
                m = router_reg.get(name) if router_reg is not None else None
                return int(m.total()) if m is not None else 0

            return {
                "incoming": tot("transaction_incoming_total"),
                "routed": tot("transaction_outgoing_total"),
                "shed": tot("router_shed_total"),
                "errors": (tot("router_score_errors_total")
                           + tot("router_process_start_errors_total")
                           + tot("transaction_decode_errors_total")),
            }

        gmi = int(c.opt("global_max_inflight", cfg.fleet_global_max_inflight))
        self.fleet = FleetMember(
            member, self._registry("fleet"), peers=peers,
            heartbeat_host=c.opt("heartbeat_host", "127.0.0.1"),
            heartbeat_port=int(c.opt("heartbeat_port", cfg.fleet_heartbeat_port)),
            ttl_s=float(c.opt("ttl_s", cfg.fleet_ttl_s)),
            overload=self._overload if gmi > 0 else None,
            recorder=self.recorder, fingerprint_fn=fingerprint_fn,
            consumers_fn=consumers_fn, counters_fn=counters_fn,
            global_max_inflight=gmi or None)
        self.fleet.start_server()
        if router is not None:
            gates = [g for g in (self.storage_gate, self.heal, self.fleet.parity_gate)
                     if g is not None]
            if len(gates) > 1:
                from ccfd_tpu_torch.runtime.durability import ComposedHealGate

                router.set_heal_gate(ComposedHealGate(*gates))
            else:
                router.set_heal_gate(gates[0])
        interval = float(c.opt("gossip_interval_s", cfg.fleet_gossip_interval_s))
        fleet = self.fleet
        self.supervisor.add_thread_service(
            "fleet", lambda: fleet.run(interval_s=interval), fleet.stop,
            policy=RestartPolicy.ALWAYS, reset=fleet.reset)

    def _up_capacity(self, c: ComponentSpec) -> None:
        """The CapacityModel over the stage profiler, seeded with the live
        actuators (router workers, the largest batch bucket, the batcher
        deadline, the router's admission limit) so a what-if is a delta
        against what runs; its refresh is a supervised service."""
        from ccfd_tpu_torch.observability.capacity import CapacityModel
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        cfg = self.cfg
        self.capacity = CapacityModel(
            self.profiler, registry=self._registry("capacity"),
            baseline_path=(c.opt("baseline_file", cfg.capacity_baseline_file) or None),
            regression_tolerance=float(c.opt("regression_tolerance",
                                             cfg.capacity_regression_tolerance)),
            min_samples=int(c.opt("min_samples", cfg.capacity_min_samples)))
        workers = int(self.spec.component("router").opt("workers", cfg.router_workers))
        self.capacity.set_actuators(
            workers=max(1, workers),
            batch=(max(cfg.batch_sizes) if cfg.batch_sizes else None),
            deadline_ms=cfg.batch_deadline_ms,
            max_inflight=(int(self._overload.budget.limit)
                          if self._overload is not None else None))
        interval = float(c.opt("interval_s", cfg.capacity_interval_s))
        cap = self.capacity
        self.supervisor.add_thread_service(
            "capacity", lambda: cap.run(interval_s=interval), cap.stop,
            policy=RestartPolicy.ALWAYS, reset=cap.reset)

    def _up_incident(self, c: ComponentSpec) -> None:
        """The FlightRecorder: bundles embed the in-flight decisions (audit)
        and the capacity model's breach-time verdict. It listens on the SLO
        engine's breach edge, snapshots on the router's watchdog kills,
        dumps on storage quarantines, and stamps the open bundle's id on
        the decisions routed while an SLO breaches (with no SLO engine
        there is no notion of "still open", so nothing is stamped)."""
        from ccfd_tpu_torch.observability.incident import FlightRecorder
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        cfg = self.cfg
        rec = self.recorder = FlightRecorder(
            self.registries, registry=self._registry("incident"), profiler=self.profiler,
            telemetry=self.device_telemetry, sink=self.trace_sink,
            ring=int(c.opt("ring", cfg.incident_ring)),
            out_dir=(c.opt("dir", cfg.incident_dir) or None),
            max_bundles=int(c.opt("max_bundles", 16)),
            timeout_debounce_s=float(c.opt("timeout_debounce_s", 2.0)),
            audit=self.audit, capacity=self.capacity)
        eng = self.slo
        if eng is not None:
            eng.add_breach_listener(rec.on_breach)
        if self.audit is not None:
            def open_incident():
                if eng is None or not eng.any_breaching():
                    return None
                return rec.last_incident_id()

            self.audit.incident_fn = open_incident
        if self._overload is not None:
            self._overload.recorder = rec
        if self.storage_gate is not None:
            from ccfd_tpu_torch.runtime import durability

            durability.set_recorder(rec.incident)
        interval = float(c.opt("interval_s", cfg.incident_interval_s))
        self.supervisor.add_thread_service(
            "incident", lambda: rec.run(interval_s=interval), rec.stop,
            policy=RestartPolicy.ALWAYS, reset=rec.reset)

    def _up_chaos(self) -> None:
        from ccfd_tpu_torch.runtime.chaos import ChaosMonkey

        c = self.spec.component("chaos")
        targets = c.opt("targets", None)
        self.chaos = ChaosMonkey(
            self.supervisor,
            interval_s=float(c.opt("interval_s", 30.0)),
            seed=int(c.opt("seed", 0)),
            # targets: [] is a valid choice: storms only, no kills
            targets=list(targets) if targets is not None else None,
            registry=self._registry("chaos"),
            fault_plan=self.fault_plan,
            device_fault_plan=(self.device_fault_plan
                               if self._device_storm_driven else None),
            storage_fault_plan=(self.storage_fault_plan
                                if self._storage_storm_driven else None),
            fault_interval_s=(float(c.opt("fault_interval_s"))
                              if c.opt("fault_interval_s") else None),
            fault_duration_s=float(c.opt("fault_duration_s", 2.0)),
        ).start()

    def _up_store(self) -> None:
        from ccfd_tpu_torch.data.ccfd import load_dataset, to_csv_bytes
        from ccfd_tpu_torch.store.objectstore import Credentials, ObjectStore
        from ccfd_tpu_torch.store.server import StoreServer

        c = self.spec.component("store")
        cfg = self.cfg
        store = ObjectStore(root=c.opt("root"))
        store.add_credentials(Credentials(cfg.access_key_id or "ccfd-access",
                                          cfg.secret_access_key or "ccfd-secret"))
        store.create_bucket(cfg.s3_bucket)
        if c.opt("seed_dataset", True):
            try:
                store.get(cfg.s3_bucket, cfg.filename)
            except Exception:  # noqa: BLE001 - absent: upload (README.md:303-343)
                store.put(cfg.s3_bucket, cfg.filename, to_csv_bytes(load_dataset()))
        self.store_server = StoreServer(store, host=c.opt("host", "127.0.0.1"),
                                        port=int(c.opt("port", 0))).start()
        # repoint the producer's endpoint at the live store
        self.cfg = dataclasses.replace(
            self.cfg, s3_endpoint=self.store_server.endpoint,
            access_key_id=self.cfg.access_key_id or "ccfd-access",
            secret_access_key=self.cfg.secret_access_key or "ccfd-secret")

    def _up_bus(self) -> None:
        """With ``bus.url`` (or a non-inproc BROKER_URL) the platform is a
        client of a shared networked bus; else the in-process Broker."""
        bus_spec = self.spec.component("bus")
        cfg = self.cfg
        bus_url = bus_spec.opt("url", "") or (
            "" if cfg.broker_url.startswith("inproc") else cfg.broker_url)
        if bus_url:
            from ccfd_tpu_torch.bus.client import broker_from_url

            self._broker_is_client = True
            self.broker = broker_from_url(bus_url, registry=self._registry("bus"))
            if self.broker is None:
                raise ValueError(f"bus.url {bus_url!r}: expected http:// (networked bus "
                                 "server) or kafka:// (real cluster)")
            return
        from ccfd_tpu_torch.bus.broker import Broker

        self.broker = Broker(default_partitions=int(bus_spec.opt("partitions", 3)),
                             log_dir=bus_spec.opt("log_dir", "") or None,
                             fsync=bool(bus_spec.opt("fsync", False)))

    def _staged_decision(self) -> str | None:
        """The reference's words for why ``scorer.fused_decision`` serves
        the staged path on this spec: no in-process row scorer (remote or
        seq), or the lifecycle's serving lane; None when the plane is
        built (which still declines a mesh scorer, serving/fused.py)."""
        spec = self.spec
        scorer = spec.component("scorer")
        if not scorer.enabled or scorer.opt("model", self.cfg.model_name) in SEQ_MODELS:
            return ("scorer.fused_decision needs an in-process row Scorer (remote and seq "
                    "scorers have no fusable decision program); serving the staged path")
        if spec.component("lifecycle").enabled and spec.component("bus").enabled:
            return ("scorer.fused_decision is incompatible with the lifecycle serving lane "
                    "(the canary gate overrides scores after the fused verdict fires); "
                    "serving the staged path")
        return None

    def _refuse_strict_decision(self) -> None:
        """Under ``scorer.fused_decision_strict`` raise, before anything
        starts, the RuntimeError the reference raises in its router step
        where the plane would serve the staged path."""
        spec, cfg = self.spec, self.cfg
        sc = spec.component("scorer")
        if not (spec.component("router").enabled
                and bool(sc.opt("fused_decision", cfg.fused_decision))
                and bool(sc.opt("fused_decision_strict", cfg.fused_decision_strict))):
            return
        reason = self._staged_decision()
        mesh = spec.component("mesh")
        if reason is None and mesh.enabled:
            n = int(mesh.opt("devices", cfg.mesh_devices))
            avail = self._mesh_avail(n)
            if min(n or avail, avail) > 1:
                from ccfd_tpu_torch.serving.fused import MESH_DECLINED

                reason = f"fused decision refused: {MESH_DECLINED}"
        if reason is not None:
            raise RuntimeError(reason)

    def _mesh_avail(self, n: int) -> int:
        """The devices a ``mesh.devices: n`` block can have: the visible
        CUDA devices, or on a CPU platform n logical CPU shards (the
        reference's virtual CPU devices; for 0, the one CPU device)."""
        import torch

        from ccfd_tpu_torch.device import resolve

        if resolve(self.device).type == "cpu":
            return n if n > 0 else 1
        return torch.cuda.device_count()

    def _up_mesh(self, c: ComponentSpec) -> None:
        """Build the serving mesh and its partitioner from the CR ``mesh:``
        block over the ``CCFD_MESH_*`` knobs: ``devices`` (0 = every visible
        CUDA device, N = the first N cards; on a CPU platform N logical CPU
        shards, and 0 the one CPU device), ``fsdp``/``tp`` (data absorbs the
        rest), ``param_partition`` (replicated | rules) and ``seq_parallel``
        (none | ring | ulysses), resolved by ``resolve_mesh_shape``: a count
        above the visible devices clamps with the reference's warnings, and
        one device serves unsharded, with no mesh and no gauges. The
        ``ccfd_mesh_devices`` and ``ccfd_mesh_axis_size`` gauges land in the
        ``mesh`` registry."""
        import torch

        from ccfd_tpu_torch.device import resolve

        cfg = self.cfg
        n = int(c.opt("devices", cfg.mesh_devices))
        avail = self._mesh_avail(n)
        if n == 0 and resolve(self.device).type == "cpu":
            logging.getLogger(__name__).warning(
                "mesh.devices=0 on a CPU platform: one CPU device, serving unsharded "
                "(name N for N logical CPU shards)")
        n, fsdp, tp, self._mesh_seq_parallel = resolve_mesh_shape(
            n, avail, max(1, int(c.opt("fsdp", cfg.mesh_fsdp))),
            max(1, int(c.opt("tp", cfg.mesh_tp))),
            str(c.opt("seq_parallel", cfg.mesh_seq_parallel) or "none"))
        if n <= 1:
            return
        from ccfd_tpu_torch.parallel.mesh import make_named_mesh
        from ccfd_tpu_torch.parallel.partition import partitioner_from_config

        dev = resolve(self.device)
        if dev.type == "cpu":
            devices = [dev] * n
        else:
            devices = [torch.device("cuda", i) for i in range(n)]
        model = self.spec.component("scorer").opt("model", cfg.model_name)
        self.mesh = make_named_mesh(devices, fsdp=fsdp, tp=tp)
        self._mesh_param_partition = str(c.opt("param_partition", cfg.mesh_param_partition))
        self.partitioner = partitioner_from_config(self.mesh, self._mesh_param_partition,
                                                   model=str(model))
        reg = self._registry("mesh")
        reg.gauge("ccfd_mesh_devices",
                  "devices in the live serving mesh (absent/0 = unsharded)").set(
            float(self.mesh.size))
        g_axis = reg.gauge("ccfd_mesh_axis_size", "named serving-mesh axis sizes")
        for axis, size in self.mesh.shape.items():
            g_axis.set(float(size), labels={"axis": str(axis)})

    def _up_scorer(self) -> None:
        from ccfd_tpu_torch.serving.scorer import Scorer

        c = self.spec.component("scorer")
        cfg = self.cfg
        model = c.opt("model", cfg.model_name)
        if model not in SCORER_MODELS:
            raise ValueError(f"scorer.model {model!r}: the operator serves "
                             f"{', '.join(SCORER_MODELS)}")
        if model in SEQ_MODELS:
            self._up_seq_scorer(model)
            return
        params = None
        if c.opt("train_steps", 0):
            from ccfd_tpu_torch.data.ccfd import load_dataset
            from ccfd_tpu_torch.parallel.train import TrainConfig, fit_mlp

            ds = load_dataset()
            params = fit_mlp(ds.X, ds.y, steps=int(c.opt("train_steps")),
                             tc=TrainConfig(compute_dtype="float32"), device=self.device)
            if model == "mlp_q8":
                from ccfd_tpu_torch.ops import quant

                params = quant.quantize_mlp(params)
        from ccfd_tpu_torch.device import resolve

        dev = resolve(self.device)
        self.scorer = Scorer(
            model_name=model, params=params,
            compute_dtype=c.opt("dtype", cfg.compute_dtype), batch_sizes=cfg.batch_sizes,
            device=None if self.mesh is not None else dev, q8_wire=cfg.q8_wire,
            dispatch_deadline_ms=cfg.scorer_dispatch_deadline_ms(dev.type == "cuda"),
            telemetry=self.device_telemetry, partitioner=self.partitioner)
        self.scorer.warmup()
        if self.device_telemetry is not None:
            self.device_telemetry.register_executable_source(
                "scorer", self.scorer.executable_grid)
        self._publish_launches(self._registry("seldon"))
        from ccfd_tpu_torch.serving.server import SCORER_ROWS, publish_rows

        g_rows, scorer = self._registry("seldon").gauge(*SCORER_ROWS), self.scorer
        self._collectors.append(lambda: publish_rows(g_rows, scorer))
        if c.opt("rest", False):
            from ccfd_tpu_torch.serving.server import PredictionServer

            self.prediction_server = PredictionServer(
                self.scorer, self.cfg, self._registry("seldon"),
                tracer=self._tracer("seldon"), profiler=self.profiler)
            self.prediction_host = c.opt("host", "127.0.0.1")
            self.prediction_port = self.prediction_server.start(
                self.prediction_host, int(c.opt("port", 0)))

    def _up_seq_scorer(self, model: str) -> None:
        """The history-aware seq family, streamed through the router
        (history lives where the stream is); the REST front stays row-based,
        as in the reference."""
        from ccfd_tpu_torch.device import resolve
        from ccfd_tpu_torch.params import load_tree
        from ccfd_tpu_torch.serving.history import SeqScorer

        c = self.spec.component("scorer")
        cfg = self.cfg
        params = load_tree(SEQ_INIT)
        if model == "seq_q8":
            from ccfd_tpu_torch.ops.seq_quant import quantize_seq

            params = quantize_seq(params)
        self.scorer = SeqScorer(
            params, length=int(c.opt("history_length", 64)), batch_sizes=cfg.batch_sizes,
            compute_dtype=c.opt("dtype", cfg.compute_dtype),
            max_customers=int(c.opt("max_customers", 20_000)),
            registry=self._registry("seldon"),
            stripes=int(c.opt("seq_stripes", cfg.seq_stripes)),
            inflight=int(c.opt("seq_inflight", cfg.seq_inflight)),
            len_buckets=tuple(c.opt("seq_len_buckets", cfg.seq_len_buckets)),
            telemetry=self.device_telemetry,
            device=None if self.mesh is not None else resolve(self.device),
            partitioner=self.partitioner, seq_parallel=self._mesh_seq_parallel)
        self.scorer.warmup()
        if self.device_telemetry is not None:
            self.device_telemetry.register_executable_source(
                "seq", self.scorer.executable_grid)
        self._publish_launches(self._registry("seldon"))

    def _publish_launches(self, registry) -> None:
        """Scrape-time ``ccfd_kernel_launches{kernel}`` (every hand kernel's
        launches in this process) and ``ccfd_scorer_dispatches`` (the
        Scorer's bucket dispatches) on ``registry``."""
        from ccfd_tpu_torch.serving.server import publish_launches

        g_launches = registry.gauge("ccfd_kernel_launches",
                                    "CUDA kernel launches in this process")
        g_dispatches = registry.gauge("ccfd_scorer_dispatches",
                                      "the Scorer's bucket dispatches in this process")
        scorer = self.scorer

        def publish() -> None:
            publish_launches(g_launches)
            g_dispatches.set(scorer.dispatch_total())

        self._collectors.append(publish)

    def _up_engine(self) -> None:
        from ccfd_tpu_torch.process.fraud import build_engine
        from ccfd_tpu_torch.process.prediction import ScorerPredictionService

        c = self.spec.component("engine")
        listener = None
        if c.opt("usertask_model", False):
            # the learned user-task model (the reference system's second
            # Seldon model): trains on investigator decisions and replaces
            # the fraud-scorer-backed prediction service
            from ccfd_tpu_torch.process.usertask_model import OnlineUserTaskModel

            self.usertask_model = OnlineUserTaskModel(
                min_examples=int(c.opt("usertask_min_examples", 32)), device=self.device)
            self._usertask_state_file = c.opt("usertask_state_file", "") or None
            if self._usertask_state_file and os.path.exists(self._usertask_state_file):
                try:
                    self.usertask_model.load(self._usertask_state_file)
                except Exception:  # noqa: BLE001 - unusable beyond every generation
                    logging.getLogger(__name__).exception(
                        "usertask state %s unusable; starting cold", self._usertask_state_file)
            pred = self.usertask_model
            listener = self.usertask_model.observe
        else:
            pred = (ScorerPredictionService(self.scorer.score)
                    if self.scorer is not None else None)

        def engine_factory():
            # crash recovery rebuilds with the same wiring; the shared
            # registry keeps counters cumulative across engine epochs
            return build_engine(self.cfg, self.broker, self._registry("kie"),
                                prediction_service=pred, task_listener=listener)

        self._engine_factory = engine_factory
        self.engine = engine_factory()
        state_file = c.opt("state_file", "")
        self._engine_state_file = state_file or None
        if state_file and os.path.exists(state_file):
            try:
                self.engine.load(state_file)
            except Exception:  # noqa: BLE001 - corrupt beyond every generation
                logging.getLogger(__name__).exception(
                    "engine state %s unusable; starting cold", state_file)
        if state_file or self._usertask_state_file:
            # periodic checkpoint: a crash between saves loses at most
            # save_interval_s of process state
            from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

            interval = float(c.opt("save_interval_s", 5.0))
            stop = threading.Event()

            def checkpoint_loop() -> None:
                while not stop.wait(interval):
                    self._save_engine_state()

            self.supervisor.add_thread_service("engine-persist", checkpoint_loop, stop.set,
                                               policy=RestartPolicy.ALWAYS, reset=stop.clear)
        if c.opt("rest", False):
            # started after the snapshot restore: an early remote start
            # would make restore() refuse a non-empty engine
            from ccfd_tpu_torch.process.server import EngineServer

            self.engine_server = EngineServer(self.engine, tracer=self._tracer("kie"))
            self.engine_port = self.engine_server.start(
                c.opt("rest_host", "127.0.0.1"), int(c.opt("rest_port", 0)))

    def _up_notify(self) -> None:
        from ccfd_tpu_torch.notify.service import NotificationService
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        c = self.spec.component("notify")
        notify = NotificationService(self.cfg, self.broker, self._registry("notify"),
                                     seed=int(c.opt("seed", 0)),
                                     tracer=self._tracer("notify"))
        self.supervisor.add_thread_service(
            "notify", lambda: notify.run(poll_timeout_s=0.02), notify.stop,
            policy=RestartPolicy.ALWAYS, reset=notify.reset)

    def _up_router(self) -> None:
        from ccfd_tpu_torch.router.router import Router
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        c = self.spec.component("router")
        cfg = self.cfg
        reg = self._registry("router")
        router_tracer = self._tracer("router")
        host_score_fn = None
        seq = False
        if self.scorer is not None:
            from ccfd_tpu_torch.serving.history import SeqScorer

            # a history-aware scorer goes in as the OBJECT, so the router
            # detects score_with_ids and feeds it the decoded records
            seq = isinstance(self.scorer, SeqScorer)
            score_fn = self.scorer if seq else self.scorer.score
            if getattr(self.scorer, "has_host_forward", False):
                # the ladder's host tier: a numpy forward, counted per row
                host_score_fn = self.scorer.host_score
            if self.fault_plan is not None:
                inj = self.fault_plan.injector("scorer", reg)
                if inj is not None:
                    score_fn = inj.wrap(score_fn) if seq else inj.wrap_fn(score_fn)
        else:  # remote scorer over the Seldon REST contract
            from ccfd_tpu_torch.serving.client import SeldonClient

            score_fn = SeldonClient(
                cfg, faults=(self.fault_plan.injector("scorer", reg)
                             if self.fault_plan else None),
                tracer=router_tracer).score
        breaker = None
        if self.lifecycle is not None and not seq:
            # the lifecycle's serving lane: the shadow tap inside (pure
            # champion pairs), the canary gate outside (the challenger arm's
            # override), under a ParallelRouter's coalescing batcher; an
            # injected scorer fault stays inside the wrap. One scorer-edge
            # breaker is shared by the ladder and the canary guardrail (a
            # breaker leaving CLOSED mid-canary rolls back)
            score_fn = self.lifecycle.wrap_score(score_fn)
            if bool(c.opt("degrade", True)):
                from ccfd_tpu_torch.router.router import default_scorer_breaker

                breaker = default_scorer_breaker(reg)
                self.lifecycle.breaker = breaker
        engine = self.engine
        if engine is None and cfg.kie_server_url.startswith("http"):
            from ccfd_tpu_torch.process.client import EngineRestClient

            engine = EngineRestClient(cfg.kie_server_url,
                                      timeout_s=cfg.seldon_timeout_ms / 1000.0,
                                      retries=cfg.client_retries, tracer=router_tracer)
        if self.fault_plan is not None and engine is not None:
            inj = self.fault_plan.injector("engine", reg)
            if inj is not None:
                engine = inj.wrap(engine, methods=("start_process", "start_process_batch",
                                                   "signal"))
        workers = int(c.opt("workers", cfg.router_workers))
        overload = None
        if cfg.overload_enabled:
            from ccfd_tpu_torch.runtime.overload import OverloadControl

            n_eff = workers if workers > 0 else max(
                1, len(self.broker.end_offsets(cfg.kafka_topic)))
            on_card = self.scorer is not None and self.scorer.device.type == "cuda"
            overload = OverloadControl.from_config(cfg, reg, max_batch=4096, workers=n_eff,
                                                   on_card=on_card)
            mi = c.opt("max_inflight")
            if overload is not None and mi is not None:
                # an explicit CR cap stays a hard ceiling on the adaptive
                # limit (and on its floor)
                b = overload.budget
                b.max_limit = min(b.max_limit, int(mi))
                b.min_limit = min(b.min_limit, int(mi))
                b.limit = min(b.limit, int(mi))
        self._overload = overload
        # fleet mode: the audit seam is wrapped with the ledger tap (per-tx
        # dispositions onto the shared bus, stamped with the poll epoch) and
        # offsets move to commit-after-route: a member SIGKILLed mid-batch
        # leaves the batch uncommitted for a survivor to redeliver, and its
        # own late commit is fenced by the bus
        audit_sink = self.audit
        commit_after_route = False
        fleet_spec = self.spec.component("fleet")
        if fleet_spec.enabled and self.broker is not None:
            from ccfd_tpu_torch.fleet.ledger import FleetLedgerTap

            member_name = str(fleet_spec.opt("member", cfg.fleet_member)
                              or f"member-{os.getpid()}")
            self.fleet_ledger = FleetLedgerTap(
                self.broker, member_name,
                topic=str(fleet_spec.opt("ledger_topic", cfg.fleet_ledger_topic)),
                inner=self.audit, registry=self._registry("fleet"))
            audit_sink = self.fleet_ledger
            commit_after_route = True
        # the replay plane: its verdict tap wraps the (possibly fleet-wrapped)
        # audit seam (live decisions pass through to the provenance log,
        # replay-marked ones divert to the parity join) and answers
        # capture_rows for it
        replay_spec = self.spec.component("replay")
        if ((replay_spec.enabled or cfg.replay_enabled)
                and self.audit is not None and self.broker is not None):
            from ccfd_tpu_torch.replay.service import ReplayVerdictTap

            self.replay_tap = ReplayVerdictTap(inner=audit_sink,
                                               registry=self._registry("replay"))
            audit_sink = self.replay_tap
        decision_fn = None
        rules = None
        sc_spec = self.spec.component("scorer")
        fused = bool(sc_spec.opt("fused_decision", cfg.fused_decision))
        staged = self._staged_decision() if fused else None
        if staged is not None:
            # the reference's warning; under strict up() raised it before
            # anything started
            logging.getLogger(__name__).warning(staged)
        elif fused:
            strict = bool(sc_spec.opt("fused_decision_strict", cfg.fused_decision_strict))
            from ccfd_tpu_torch.router.rules import RuleSet, default_rules
            from ccfd_tpu_torch.serving.fused import FusedDecisionScorer

            # one RuleSet instance for the plane and the router
            rules = (RuleSet.from_file(cfg.rules_file) if cfg.rules_file
                     else default_rules(cfg.fraud_threshold))
            fds = FusedDecisionScorer(self.scorer, rules, registry=reg,
                                      profiler=self.profiler, strict=strict)
            if fds.enabled:
                fds.warmup()
                if self.device_telemetry is not None:
                    self.device_telemetry.register_executable_source(
                        "fused_decision", fds.executable_grid)
                self.scorer.add_prepublish_hook(fds.prepublish)
                decision_fn = fds
                self.fused_decision = fds
            else:  # a mesh scorer or unvectorizable rules: the warning said why
                rules = None
        common = dict(
            rules=rules, decision_fn=decision_fn, host_score_fn=host_score_fn,
            breaker=breaker, degrade=bool(c.opt("degrade", True)),
            max_inflight=(int(c.opt("max_inflight"))
                          if c.opt("max_inflight") is not None else None),
            tracer=router_tracer, overload=overload, profiler=self.profiler,
            audit=audit_sink, commit_after_route=commit_after_route)
        if workers == 1:
            router = Router(cfg, self.broker, score_fn, engine, reg, **common)
        else:
            from ccfd_tpu_torch.router.parallel import ParallelRouter

            router = ParallelRouter(cfg, self.broker, score_fn, engine, reg, workers=workers,
                                    coalesce=bool(c.opt("coalesce", cfg.router_coalesce)),
                                    **common)
        self.router = router
        if self.fleet_ledger is not None:
            # entries stamp the epoch their batch was polled under, which
            # the router hands the audit seam with the batch; a
            # ParallelRouter has no single batch stream, so its entries stay
            # epoch=None, which the conservation check treats conservatively
            self.fleet_ledger.epoch_fn = lambda: getattr(router, "batch_epoch", None)
        if self.replay_tap is not None:
            self._up_replay(replay_spec, overload)
        if self.storage_gate is not None:
            # the storage pin binds whether or not anything arms it
            router.set_heal_gate(self.storage_gate)
        if self.partitioner is not None and self.scorer is not None:
            # the publish path: every swap_params (retrain, lifecycle
            # promote or rollback, heal respawn) pauses this router pool at
            # a batch boundary for the flip
            self.partitioner.set_barrier(router, registry=self._registry("mesh"))
            self.scorer.set_swap_gate(self.partitioner.gate)
        self.supervisor.add_thread_service(
            "router", lambda: router.run(poll_timeout_s=0.02), router.stop,
            policy=RestartPolicy.ALWAYS, reset=router.reset)

    def _up_crash_recovery(self) -> None:
        """Aligned checkpoints + the engine as a supervised service: an
        engine failure restores the last cut and re-drives the bus through
        the live router; the platform and the KIE REST server re-point via
        on_swap inside the barrier."""
        from ccfd_tpu_torch.runtime.recovery import CheckpointCoordinator, attach_engine_service

        c = self.spec.component("engine")

        def on_swap(engine) -> None:
            self.engine = engine
            if self.engine_server is not None:
                self.engine_server.engine = engine
            if self.investigator is not None:
                self.investigator.engine = engine

        self.recovery = CheckpointCoordinator(
            self.router, self.broker, self._engine_factory,
            interval_s=float(c.opt("checkpoint_interval_s", 5.0)), on_swap=on_swap,
            path=c.opt("checkpoint_file", "") or None)
        from ccfd_tpu_torch.serving.history import SeqScorer

        if isinstance(self.scorer, SeqScorer):
            # per-customer histories are pipeline state: they reset to the
            # cut before a rewind replays records, or the replay would
            # append every transaction a second time
            self.recovery.register_state("history", self.scorer.store.snapshot,
                                         self.scorer.store.restore)
        # full-process recovery: the services have not started, so a
        # persisted cut restores here and the gap re-drives after start
        self.recovery.restore_from_disk()
        attach_engine_service(self.supervisor, self.recovery)
        self.recovery.start()

    def _up_investigator(self) -> None:
        from ccfd_tpu_torch.process.investigator import InvestigatorService
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        c = self.spec.component("investigator")
        svc = InvestigatorService(
            self.engine, self._registry("investigator"),
            rate_per_s=float(c.opt("rate_per_s", 50.0)),
            trust_threshold=float(c.opt("trust_threshold", 0.9)),
            base_fraud_rate=float(c.opt("base_fraud_rate", 0.05)),
            seed=int(c.opt("seed", 0)))
        self.investigator = svc
        self.supervisor.add_thread_service("investigator", svc.run, svc.stop,
                                           policy=RestartPolicy.ALWAYS, reset=svc.reset)

    def _up_retrain(self) -> None:
        from ccfd_tpu_torch.parallel.online import OnlineTrainer
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        c = self.spec.component("retrain")
        # the governed rollout when the lifecycle is up; retrain.direct_swap
        # keeps the unvalidated hot swap
        lifecycle = None if bool(c.opt("direct_swap", False)) else self.lifecycle
        trainer = OnlineTrainer(self.cfg, self.broker, self.scorer, self.scorer.params,
                                registry=self._registry("retrain"), seed=int(c.opt("seed", 0)),
                                lifecycle=lifecycle, partitioner=self.partitioner)
        if lifecycle is not None:
            # a reject or rollback re-bases the trainer onto the champion, so
            # the next candidate descends from its recorded parent
            lifecycle.trainer_rebase = trainer.rebase
        interval = float(c.opt("interval_s", 0.5))
        self.supervisor.add_thread_service(
            "retrain", lambda: trainer.run(interval_s=interval), trainer.stop,
            policy=RestartPolicy.ALWAYS, reset=trainer.reset)

    def _up_lifecycle(self) -> None:
        """The governed rollout over the local scorer: the version store
        and candidate checkpoints (under ``state_dir``, else in memory with
        the checkpoints in a temporary dir), the shadow tap and the
        evaluator on the bus, the guardrails from the CR over the
        CCFD_LIFECYCLE_* knobs, the controller and the shadow worker as
        supervised services. The audit records join the champion's lineage
        (one sample a batch). A SeqScorer is called by the router as an
        object, so there is no score lane to wrap: the scorer offers each
        assembled chunk to the tap and serves the canary gate's challenger
        slice on the same contexts itself."""
        from ccfd_tpu_torch.lifecycle.controller import Guardrails, LifecycleController
        from ccfd_tpu_torch.lifecycle.evaluator import ShadowEvaluator
        from ccfd_tpu_torch.lifecycle.shadow import ShadowTap
        from ccfd_tpu_torch.lifecycle.versions import VersionStore
        from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        c = self.spec.component("lifecycle")
        cfg = self.cfg
        registry = self._registry("lifecycle")
        state_dir = c.opt("state_dir", cfg.lifecycle_dir) or ""
        store = VersionStore(os.path.join(state_dir, "versions.json") if state_dir else None)
        if state_dir:
            ckpt_dir = os.path.join(state_dir, "checkpoints")
        else:
            # an in-memory lineage still needs its rollback checkpoints
            import tempfile

            ckpt_dir = tempfile.mkdtemp(prefix="ccfd_lifecycle_")
        checkpoints = CheckpointManager(ckpt_dir, keep=int(c.opt("keep_checkpoints", 8)))
        shadow = ShadowTap(self.scorer, self.broker, cfg.shadow_topic, registry,
                           max_queued_batches=int(c.opt("shadow_queue_batches", 64)))
        evaluator = ShadowEvaluator(cfg, self.broker, self.scorer, registry,
                                    k_frac=float(c.opt("precision_k_frac", 0.05)))
        guardrails = Guardrails(
            min_labels=int(c.opt("min_labels", cfg.lifecycle_min_labels)),
            min_shadow_rows=int(c.opt("min_shadow_rows", cfg.lifecycle_min_shadow_rows)),
            auc_margin=float(c.opt("auc_margin", cfg.lifecycle_auc_margin)),
            max_alert_rate_delta=float(c.opt("max_alert_rate_delta",
                                             cfg.lifecycle_max_alert_delta)),
            max_score_psi=float(c.opt("max_score_psi", cfg.lifecycle_max_psi)),
            canary_weight=float(c.opt("canary_weight", cfg.lifecycle_canary_weight)),
            canary_min_labels=int(c.opt("canary_min_labels", cfg.lifecycle_canary_min_labels)),
            min_submit_interval_s=float(c.opt("min_submit_interval_s",
                                              cfg.lifecycle_min_submit_interval_s)))
        self.lifecycle = LifecycleController(
            cfg, self.scorer, store=store, checkpoints=checkpoints, shadow=shadow,
            evaluator=evaluator, guardrails=guardrails, registry=registry,
            # no verifiable champion checkpoint at a restore pins serving to
            # the rules tier through the router's heal-gate seam
            storage_pin=(self.storage_gate.pin if self.storage_gate is not None else None),
            storage_unpin=(self.storage_gate.unpin if self.storage_gate is not None else None))
        from ccfd_tpu_torch.serving.history import SeqScorer

        if isinstance(self.scorer, SeqScorer):
            self.scorer.shadow_tap = shadow
            self.scorer.canary_gate = self.lifecycle.gate
            if len(self.scorer.len_buckets) > 1:
                # tapped champion scores come from short-L rungs while the
                # challenger re-scores the full-L contexts: the PSI/alert
                # evidence absorbs rung noise on cold rows (conservative)
                logging.getLogger(__name__).warning(
                    "lifecycle shadow evaluation with seq len_buckets=%s armed: "
                    "champion scores ride short-L rungs while the challenger "
                    "scores full-L contexts; distribution gates will include "
                    "ladder-rung noise (conservative)", self.scorer.len_buckets)
        if self.audit is not None:
            def lineage_sample(store=store):
                v = store.champion()
                return (v.version, v.checkpoint_hash) if v is not None else (None, None)

            self.audit.lineage_fn = lineage_sample
        interval = float(c.opt("interval_s", 0.25))
        lc = self.lifecycle
        self.supervisor.add_thread_service(
            "lifecycle", lambda: lc.run(interval_s=interval), lc.stop,
            policy=RestartPolicy.ALWAYS, reset=lc.reset)
        self.supervisor.add_thread_service(
            "lifecycle-shadow", lambda: shadow.run(interval_s=0.05), shadow.stop,
            policy=RestartPolicy.ALWAYS, reset=shadow.reset)

    def _up_replay(self, c: ComponentSpec, overload: Any) -> None:
        """The replay plane's worker: re-produces recorded windows through
        this router under bulk admission (the bulk ceiling on ``overload``)
        and joins their verdicts from the tap; supervised, so a crashed
        worker restarts and resumes from its durable cursor."""
        from ccfd_tpu_torch.replay.service import ReplayService
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        cfg = self.cfg

        def lineage():
            fn = getattr(self.audit, "lineage_fn", None)
            return fn() if fn is not None else (None, None)

        rep = ReplayService(cfg, self.broker, self.audit, tap=self.replay_tap,
                            registry=self._registry("replay"),
                            state_dir=(str(c.opt("dir", cfg.replay_dir)) or None),
                            overload=overload, lineage_fn=lineage)
        rep.batch = max(1, int(c.opt("batch", cfg.replay_batch)))
        rep.timeout_s = float(c.opt("timeout_s", cfg.replay_timeout_s))
        rep.retries = max(0, int(c.opt("retries", cfg.replay_retries)))
        rep.bulk_ceiling = min(1.0, max(0.0, float(c.opt("bulk_ceiling",
                                                         cfg.replay_bulk_ceiling))))
        rep.set_pacing(float(c.opt("pacing_rows_s", cfg.replay_pacing_rows_s)))
        self.replay = rep
        self.supervisor.add_thread_service("replay", rep.run, rep.stop,
                                           policy=RestartPolicy.ALWAYS, reset=rep.reset)

    def _up_analytics(self) -> None:
        """The drift monitor on the transaction topic; its reference is the
        dataset summarized on the card, built on the monitor's own thread
        (bring-up is not held) and persisted to ``reference_file``."""
        from ccfd_tpu_torch.analytics.engine import AnalyticsEngine, DriftMonitor
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        c = self.spec.component("analytics")
        registry = self._registry("analytics")
        engine = AnalyticsEngine(device=None if self.mesh is not None else self.device,
                                 nbins=int(c.opt("nbins", 32)), registry=registry,
                                 mesh=self.mesh)

        def build_reference():
            from ccfd_tpu_torch.data.ccfd import load_dataset

            ds = load_dataset()
            return engine.summarize(ds.X, ds.y)

        monitor = DriftMonitor(self.cfg, self.broker, None, engine=engine, registry=registry,
                               window=int(c.opt("window", 4096)),
                               reference_builder=build_reference,
                               reference_path=c.opt("reference_file", "") or None)
        self.analytics = monitor
        interval = float(c.opt("interval_s", 0.25))
        self.supervisor.add_thread_service(
            "analytics", lambda: monitor.run(interval_s=interval), monitor.stop,
            policy=RestartPolicy.ALWAYS, reset=monitor.reset)

    def _up_producer(self) -> None:
        from ccfd_tpu_torch.producer.producer import Producer
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        c = self.spec.component("producer")
        producer = Producer(
            self.cfg, self.broker, registry=self._registry("producer"),
            store_faults=(self.fault_plan.injector("store", self._registry("producer"))
                          if self.fault_plan else None),
            tracer=self._tracer("producer"))
        limit = c.opt("transactions")
        rate = c.opt("rate")
        wire = c.opt("wire_format", "dict")
        done = self._producer_done

        def run() -> None:
            try:
                producer.run(limit=int(limit) if limit is not None else None,
                             rate_per_s=float(rate) if rate else None, wire_format=wire)
            finally:
                done.set()

        # one-shot job semantics, like the reference's producer pod
        self.supervisor.add_thread_service("producer", run, policy=RestartPolicy.NEVER)
        self.supervisor.start_service("producer")

    def _wire_memory_probes(self) -> None:
        """Per-component live-object counts for the memory surface; probes
        resolve through ``self`` so crash-recovery swaps are followed."""
        ex = self.exporter
        if self.engine is not None:
            ex.add_probe("engine", lambda: sum((self.engine.object_counts() or {}).values()))
        if self.broker is not None and hasattr(self.broker, "health_snapshot"):
            def bus_retained() -> int:
                snap = self.broker.health_snapshot()
                return sum(e - b for t in snap["topics"]
                           for e, b in zip(snap["topics"][t], snap["begins"][t]))

            ex.add_probe("bus_retained_records", bus_retained)
        if self.trace_sink is not None:
            ex.add_probe("trace_sink", lambda: len(self.trace_sink.traces()))
        if getattr(self.router, "batcher", None) is not None:
            ex.add_probe("router_batcher_queue", lambda: self.router.batcher.qsize())
        if getattr(self.prediction_server, "batcher", None) is not None:
            ex.add_probe("serving_batcher_queue",
                         lambda: self.prediction_server.batcher.qsize())

    # -- status / teardown -------------------------------------------------
    def wait_producer(self, timeout_s: float = 60.0) -> bool:
        return self._producer_done.wait(timeout=timeout_s)

    def wait_routed(self, timeout_s: float) -> bool:
        """Wait until the router has consumed every record on the
        transaction topic and disposed of each (routed, shed or errored);
        False when ``timeout_s`` ran out first."""
        reg = self.registries.get("router")
        if reg is None or self.broker is None:
            return True
        deadline = time.monotonic() + timeout_s
        while True:
            produced = sum(self.broker.end_offsets(self.cfg.kafka_topic))
            incoming = reg.counter("transaction_incoming_total").value()
            done = sum(reg.counter(n).total() for n in (
                "transaction_outgoing_total", "router_shed_total",
                "router_score_errors_total", "router_process_start_errors_total"))
            if incoming >= produced and done >= incoming:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def status(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "services": self.supervisor.status() if self.supervisor else {},
            "endpoints": {},
        }
        if self.store_server:
            out["endpoints"]["store"] = self.store_server.endpoint
        if self.prediction_server:
            out["endpoints"]["scorer"] = f"http://{self.prediction_host}:{self.prediction_port}"
        if self.exporter:
            out["endpoints"]["metrics"] = self.exporter.endpoint
        if self.health_server:
            out["endpoints"]["health"] = self.health_server.endpoint
        if self.heal is not None:
            out["heal"] = self.heal.status()
        if self.mesh is not None:
            out["mesh"] = {"devices": int(self.mesh.size), "axes": dict(self.mesh.shape),
                           "platform": self.mesh.platform,
                           "param_partition": self._mesh_param_partition,
                           "seq_parallel": self._mesh_seq_parallel}
        if self.fleet is not None:
            gate = self.fleet.parity_gate
            out["fleet"] = {"member": self.fleet.member, "heartbeat": self.fleet.endpoint,
                            "quarantined": gate.quarantined, "reason": gate.reason}
        if self.replay is not None:
            out["replay"] = {
                "bulk_ceiling": self.replay.bulk_ceiling,
                "pacing_rows_s": self.replay.pacing_rows_s,
                "batch": self.replay.batch,
                "last_report": self.replay.last_report,
            }
        return out

    def _health_verdict(self) -> dict[str, Any]:
        """The exporter's /healthz verdict: every health-bearing plane that
        is up contributes a source with a cause string (the supervisor, the
        storage pin, the device heal supervisor, the fleet's parity gate,
        the scorer edge's breaker)."""
        sources: dict[str, dict[str, Any]] = {}

        def add(name: str, healthy: bool, cause: str) -> None:
            sources[name] = {"healthy": bool(healthy), "cause": cause}

        if self.supervisor is not None:
            bad = []
            for name, st in self.supervisor.status().items():
                if st.get("ready"):
                    continue
                err = st.get("last_error") or ""
                bad.append(f"{name}={st.get('state')}" + (f" ({err})" if err else ""))
            add("supervisor", not bad, "; ".join(bad) if bad else "all services ready")
        if self.heal is not None:
            hst = self.heal.status()
            state = str(hst.get("state", ""))
            reasons = hst.get("reasons") or []
            add("device", state != "quarantined",
                f"state={state}" + (f" ({'; '.join(str(r) for r in reasons)})"
                                    if reasons and state != "healthy" else ""))
        if self.storage_gate is not None:
            add("storage", not self.storage_gate.pinned,
                (f"pinned to rules tier: {self.storage_gate.reason}"
                 if self.storage_gate.pinned else "verified"))
        if self.fleet is not None:
            gate = self.fleet.parity_gate
            add("fleet", not gate.quarantined,
                "parity quarantined" if gate.quarantined else "parity clean")
        breaker = getattr(self.router, "_breaker", None)
        if breaker is not None:
            add("scorer_edge", breaker.state != "open", f"breaker={breaker.state}")
        causes = [f"{n}: {s['cause']}" for n, s in sources.items() if not s["healthy"]]
        return {"healthy": not causes, "generated_unix": time.time(),
                "sources": sources, "causes": causes}

    def _save_engine_state(self) -> None:
        if self._engine_state_file:
            try:
                self.engine.save(self._engine_state_file)
            except Exception:  # noqa: BLE001 - persistence must not kill the host
                logging.getLogger(__name__).exception(
                    "engine state save to %s failed; process state will NOT survive a "
                    "restart", self._engine_state_file)
        if self._usertask_state_file and self.usertask_model is not None:
            try:
                self.usertask_model.save(self._usertask_state_file)
            except Exception:  # noqa: BLE001
                logging.getLogger(__name__).exception(
                    "user-task model save to %s failed", self._usertask_state_file)

    def down(self) -> None:
        # chaos first: injecting failures into services being torn down
        # would race the orderly shutdown
        if self.chaos is not None:
            self.chaos.stop()
        from ccfd_tpu_torch.runtime import faults

        if self.device_fault_plan is not None:
            # installed PROCESS-wide: a torn-down platform must not leave
            # standing device faults for the next one in the process
            faults.install_device_faults(None)
            self.device_fault_plan = None
        if self.storage_fault_plan is not None:
            faults.install_storage_faults(None)
            self.storage_fault_plan = None
        from ccfd_tpu_torch.runtime import durability

        durability.set_recorder(None)
        if self.recovery is not None:
            self.recovery.stop()
        if self.supervisor:
            self.supervisor.stop()
        if self.audit is not None:
            # the supervised flusher's shutdown already lands the tail; this
            # covers a platform torn down before the supervisor ran
            try:
                self.audit.flush()
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass
        if self.lifecycle is not None:
            try:
                self.lifecycle.close()  # releases the evaluator's consumers
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass
        if self.fleet is not None:
            try:
                self.fleet.close()  # the heartbeat server and peer clients
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass
        if self._broker_is_client and self.broker is not None:
            try:
                self.broker.close()
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass
        # a ParallelRouter owns coalescing-batcher threads the supervisor
        # does not know about
        if getattr(self.router, "batcher", None) is not None:
            try:
                self.router.batcher.stop()
            except Exception:  # noqa: BLE001
                pass
        if self.engine is not None:
            if self._engine_state_file or self._usertask_state_file:
                self._save_engine_state()
            # silence the engine's timers: a torn-down platform's reply
            # timeouts must not fire into its closed bus (or score on its
            # scorer) later in the process, which the reference's down()
            # leaves to the process's exit
            self.engine.shutdown()
        for srv in (self.prediction_server, self.engine_server, self.exporter,
                    self.health_server, self.store_server):
            if srv is not None:
                try:
                    srv.stop()
                except Exception:  # noqa: BLE001
                    pass
        self._up = False
