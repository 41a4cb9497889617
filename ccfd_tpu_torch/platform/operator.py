"""Platform operator: CR-shaped spec -> running pipeline, in run-book order.

The port of ccfd_tpu/platform/operator.py. ``PlatformSpec`` parses the
reference's CR (``deploy/platform_cr.yaml``: one block per component, each
with ``enabled`` and free-form options, the same components on by default)
and ``Platform`` brings the components up in the reference's run-book
order, every long-lived service under the ``Supervisor`` (restart on
crash), with health probes and one Prometheus exporter:

   0  the edge fault plan (CCFD_FAULTS), the durability block (the
      ``StoragePinGate`` the router's heal-gate seam binds), overload
      control, tracing (and the trace-correlated JSON logs), the stage
      profiler and the device telemetry plane
   1  store (the S3-shaped object store, seeded with the dataset)
   2  bus (in process, durable with ``log_dir``; or a client of ``url``:
      ``http://`` for a ``bus`` role, ``kafka://`` for a cluster)
   3  scorer (``train_steps`` of ``fit_mlp`` on the card first; the REST
      front with ``rest``)
   4  engine (``state_file``, ``rest``), 5 notify, 6 router (the decision
      plane with ``scorer.fused_decision``), 6b crash recovery
      (``engine.crash_recovery``: the ``CheckpointCoordinator``)
   7  retrain (the ``OnlineTrainer``, publishing by ``swap_params``),
      7c the SLO engine
   8  monitoring (the exporter: /prometheus, /profile, /healthz,
      /debug/device, /debug/profile) and health (/healthz, /readyz)
   9  the supervisor starts, readiness is awaited, then the producer.

The scorer serves on the card (``device=None``) unless the caller names
the CPU, as every entry point of the port. The components and options the
port does not have are refused by name, all at once, before anything
starts (``refused``): the reference builds them only here, and the port
never skips one with a warning, clamps it or moves it to the CPU where the
reference would.
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
# with the ROADMAP item that ports each
REFUSED_COMPONENTS: Mapping[str, str] = {
    "lifecycle": "A12 (the model lifecycle: shadow, canary, gated promotion)",
    "analytics": "A14 (batch analytics and the drift monitor)",
    "investigator": "A11 (the investigator simulation)",
    "incident": "A14 (the incident flight recorder)",
    "heal": "A7 (the device heal supervisor)",
    "audit": "A9 (the decision provenance plane)",
    "capacity": "A14 (the capacity observatory)",
    "fleet": "A10 (the multi-host fleet)",
    "replay": "A9 (bulk replay and backtest)",
    "chaos": "A6 (the chaos monkey and its device and storage fault storms)",
}
# scorer models the operator serves (every other is refused or unknown)
SCORER_MODELS = ("mlp", "mlp_q8", "logreg", "modelfull", "gbt", "gbt_mxu")


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
        port does not have, each named with the ROADMAP item that ports
        it; [] when the platform can come up."""
        out = [f"{name} ({item})" for name, item in REFUSED_COMPONENTS.items()
               if self.component(name).enabled]
        if self.component("engine").enabled and self.component("engine").opt(
                "usertask_model", False):
            out.append("engine.usertask_model (A11 (the user-task model))")
        model = self.component("scorer").opt("model", self.cfg.model_name)
        if self.component("scorer").enabled and model in ("seq", "seq_q8"):
            out.append(f"scorer.model: {model} (A15 (the seq family))")
        mesh = self.component("mesh")
        if mesh.enabled:
            n = int(mesh.opt("devices", self.cfg.mesh_devices))
            if n != 1:
                out.append(f"mesh.devices: {n} (A15 (multi-GPU serving); "
                           "1 is the single-device platform)")
        if self.cfg.graph_cr:
            out.append("CCFD_GRAPH_CR (the operator's scorer serves scorer.model; "
                       "`serve` serves a graph)")
        out.extend(self.cfg.unported())
        return out


def refuse(spec: PlatformSpec) -> None:
    """Raise ``NotImplementedError`` naming every refused part of ``spec``."""
    refused = spec.refused()
    if refused:
        raise NotImplementedError(
            "not ported yet; disable or unset each to bring the platform up: "
            + "; ".join(refused))


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
        self.trace_sink = None  # observability/trace.SpanSink when enabled
        self.profiler = None    # observability/profile.StageProfiler
        self.slo = None         # observability/slo.SLOEngine when enabled
        self.device_telemetry = None  # observability/device.DeviceTelemetry
        self.storage_gate = None  # runtime/durability.StoragePinGate
        self.fused_decision = None  # serving/fused.FusedDecisionScorer
        self._overload = None   # runtime/overload.OverloadControl (router)
        self.router = None
        self.recovery = None  # CheckpointCoordinator when crash_recovery on
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
        self.supervisor = Supervisor()

        # 0. network fault plan: the CCFD_FAULTS env (the chaos block, the
        # CR's other source, is refused); edges wire up below
        if cfg.faults_spec:
            from ccfd_tpu_torch.runtime.faults import FaultPlan

            self.fault_plan = FaultPlan.from_string(cfg.faults_spec)

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

        # 3. model serving (Seldon, README.md:271-301)
        if spec.component("scorer").enabled:
            self._up_scorer()

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

        # 7. online retrain: the OnlineTrainer's direct swap (the governed
        # rollout is the lifecycle's, refused above)
        if spec.component("retrain").enabled and self.scorer is not None:
            self._up_retrain()

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

        # 8. monitoring (README.md:487-537)
        if spec.component("monitoring").enabled:
            from ccfd_tpu_torch.metrics.exporter import MetricsExporter

            mon = spec.component("monitoring")
            self.exporter = MetricsExporter(
                self.registries, host=mon.opt("host", "127.0.0.1"),
                port=int(mon.opt("port", 0)), sink=self.trace_sink,
                collectors=self._collectors, profiler=self.profiler,
                telemetry=self.device_telemetry, health=self._health_verdict).start()
            self._wire_memory_probes()

        if spec.component("health").enabled:
            from ccfd_tpu_torch.runtime.health import HealthServer

            h = spec.component("health")
            self.health_server = HealthServer(
                self.supervisor, host=h.opt("host", "127.0.0.1"),
                port=int(h.opt("port", 0))).start()

        self.supervisor.start()
        if not self.supervisor.wait_ready(timeout_s=wait_ready_s):
            raise TimeoutError(f"platform not ready after {wait_ready_s}s: "
                               f"{self.supervisor.status()}")

        # 9. producer last (README.md:461-485): starts the traffic
        if spec.component("producer").enabled:
            self._up_producer()
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

    def _up_scorer(self) -> None:
        from ccfd_tpu_torch.serving.scorer import Scorer

        c = self.spec.component("scorer")
        cfg = self.cfg
        model = c.opt("model", cfg.model_name)
        if model not in SCORER_MODELS:
            raise ValueError(f"scorer.model {model!r}: the operator serves "
                             f"{', '.join(SCORER_MODELS)}")
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
            device=dev, q8_wire=cfg.q8_wire,
            dispatch_deadline_ms=cfg.scorer_dispatch_deadline_ms(dev.type == "cuda"),
            telemetry=self.device_telemetry)
        self.scorer.warmup()
        if self.device_telemetry is not None:
            self.device_telemetry.register_executable_source(
                "scorer", self.scorer.executable_grid)
        self._publish_launches(self._registry("seldon"))
        if c.opt("rest", False):
            from ccfd_tpu_torch.serving.server import PredictionServer

            self.prediction_server = PredictionServer(
                self.scorer, self.cfg, self._registry("seldon"), profiler=self.profiler)
            self.prediction_host = c.opt("host", "127.0.0.1")
            self.prediction_port = self.prediction_server.start(
                self.prediction_host, int(c.opt("port", 0)))

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
        pred = ScorerPredictionService(self.scorer.score) if self.scorer is not None else None

        def engine_factory():
            # crash recovery rebuilds with the same wiring; the shared
            # registry keeps counters cumulative across engine epochs
            return build_engine(self.cfg, self.broker, self._registry("kie"),
                                prediction_service=pred)

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
        if state_file:
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
        if self.scorer is not None:
            score_fn = self.scorer.score
            if self.scorer.has_host_forward:
                # the ladder's host tier: a numpy forward, counted per row
                host_score_fn = self.scorer.host_score
            if self.fault_plan is not None:
                inj = self.fault_plan.injector("scorer", reg)
                if inj is not None:
                    score_fn = inj.wrap_fn(score_fn)
        else:  # remote scorer over the Seldon REST contract
            from ccfd_tpu_torch.serving.client import SeldonClient

            score_fn = SeldonClient(
                cfg, faults=(self.fault_plan.injector("scorer", reg)
                             if self.fault_plan else None),
                tracer=router_tracer).score
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
        decision_fn = None
        rules = None
        sc_spec = self.spec.component("scorer")
        if bool(sc_spec.opt("fused_decision", cfg.fused_decision)):
            strict = bool(sc_spec.opt("fused_decision_strict", cfg.fused_decision_strict))
            if self.scorer is None:
                # the port never serves the staged path where the reference
                # would fall back to it with a warning
                raise RuntimeError("scorer.fused_decision needs an in-process row Scorer "
                                   "(a remote scorer has no fusable decision program)")
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
            else:  # unvectorizable rules: the warning said why; staged
                rules = None
        common = dict(
            rules=rules, decision_fn=decision_fn, host_score_fn=host_score_fn,
            degrade=bool(c.opt("degrade", True)),
            max_inflight=(int(c.opt("max_inflight"))
                          if c.opt("max_inflight") is not None else None),
            tracer=router_tracer, overload=overload, profiler=self.profiler)
        if workers == 1:
            router = Router(cfg, self.broker, score_fn, engine, reg, **common)
        else:
            from ccfd_tpu_torch.router.parallel import ParallelRouter

            router = ParallelRouter(cfg, self.broker, score_fn, engine, reg, workers=workers,
                                    coalesce=bool(c.opt("coalesce", cfg.router_coalesce)),
                                    **common)
        self.router = router
        if self.storage_gate is not None:
            # the storage pin binds whether or not anything arms it
            router.set_heal_gate(self.storage_gate)
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

        self.recovery = CheckpointCoordinator(
            self.router, self.broker, self._engine_factory,
            interval_s=float(c.opt("checkpoint_interval_s", 5.0)), on_swap=on_swap,
            path=c.opt("checkpoint_file", "") or None)
        # full-process recovery: the services have not started, so a
        # persisted cut restores here and the gap re-drives after start
        self.recovery.restore_from_disk()
        attach_engine_service(self.supervisor, self.recovery)
        self.recovery.start()

    def _up_retrain(self) -> None:
        from ccfd_tpu_torch.parallel.online import OnlineTrainer
        from ccfd_tpu_torch.runtime.supervisor import RestartPolicy

        c = self.spec.component("retrain")
        trainer = OnlineTrainer(self.cfg, self.broker, self.scorer, self.scorer.params,
                                registry=self._registry("retrain"), seed=int(c.opt("seed", 0)))
        interval = float(c.opt("interval_s", 0.5))
        self.supervisor.add_thread_service(
            "retrain", lambda: trainer.run(interval_s=interval), trainer.stop,
            policy=RestartPolicy.ALWAYS, reset=trainer.reset)

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
        return out

    def _health_verdict(self) -> dict[str, Any]:
        """The exporter's /healthz verdict: every health-bearing plane that
        is up contributes a source with a cause string (the supervisor, the
        storage pin, the scorer edge's breaker)."""
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
        if self.storage_gate is not None:
            add("storage", not self.storage_gate.pinned,
                (f"pinned to rules tier: {self.storage_gate.reason}"
                 if self.storage_gate.pinned else "verified"))
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

    def down(self) -> None:
        if self.recovery is not None:
            self.recovery.stop()
        if self.supervisor:
            self.supervisor.stop()
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
            if self._engine_state_file:
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
