"""Kubernetes/OpenShift manifests generated from a ``PlatformSpec``.

The port of ccfd_tpu/platform/k8s.py. The documents are the reference's in
every field but three: each container runs ``python -m ccfd_tpu_torch
<service>``, the image is ``ccfd-tpu-torch:latest``, and the scorer
Deployment's ``resources.limits`` asks for ``nvidia.com/gpu: 1`` where the
reference asks for ``google.com/tpu: 1``.

The reference is deployed from per-service manifests that pin each
service's env contract (reference deploy/router.yaml:1-121,
deploy/ccd-service.yaml:1-124, deploy/notification-service.yaml:1-99,
deploy/kafka/ProducerDeployment.yaml:1-109, deploy/model/modelfull.json).
This module emits the same topology for the port — one
Deployment + Service per platform component, env vars VERBATIM from the
reference contract (names cited per service below), Prometheus scrape
annotations on the pods that export metrics (reference README.md:292-301,
499-515), and kubelet probes against the services' real health endpoints.

Differences from the reference are deliberate and TPU-shaped:

- every container is this one image running ``python -m ccfd_tpu_torch
  <service>`` instead of five bespoke JVM/Python images;
- the scorer Deployment requests ``nvidia.com/gpu`` instead of a 10Mi CPU
  pod — the model hop is the part that moved to the card;
- Deployments (apps/v1) replace DeploymentConfigs — the reference's
  ImageStream/DC machinery is OpenShift-specific and adds nothing here.

Generation, not hand-editing, is the point: the manifests always match
the spec that ``ccfd_tpu_torch up`` runs in-process, so the single-host
demo and the cluster deployment cannot drift. ``python -m ccfd_tpu_torch
manifests -f ccfd_tpu_torch/assets/platform_cr.yaml --out DIR`` writes them
(nothing is written under ``deploy/``, which holds the reference's).
"""

from __future__ import annotations

import os
from typing import Any, Mapping

from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.platform.operator import PlatformSpec

IMAGE = "ccfd-tpu-torch:latest"  # one image, many commands (python -m ccfd_tpu_torch ...)


def _env(pairs: Mapping[str, Any]) -> list[dict[str, Any]]:
    out = []
    for k, v in pairs.items():
        if isinstance(v, dict):  # secret/ref-shaped values pass through
            out.append({"name": k, **v})
        else:
            out.append({"name": k, "value": str(v)})
    return out


def _deployment(
    name: str,
    *,
    command: list[str],
    env: Mapping[str, Any],
    port: int | None,
    replicas: int = 1,
    annotations: Mapping[str, str] | None = None,
    probe_path: str | None = None,
    resources: Mapping[str, Any] | None = None,
    data_volume: str | None = None,
) -> dict[str, Any]:
    container: dict[str, Any] = {
        "name": name,
        "image": IMAGE,
        "command": command,
        "env": _env(env),
    }
    if port is not None:
        container["ports"] = [{"containerPort": port, "protocol": "TCP"}]
    if probe_path is not None and port is not None:
        probe = {
            "httpGet": {"path": probe_path, "port": port},
            "initialDelaySeconds": 10,
            "periodSeconds": 10,
        }
        container["readinessProbe"] = probe
        container["livenessProbe"] = dict(probe, initialDelaySeconds=30)
    if resources:
        container["resources"] = dict(resources)
    pod_meta: dict[str, Any] = {"labels": {"app": name}}
    if annotations:
        pod_meta["annotations"] = dict(annotations)
    pod_spec: dict[str, Any] = {"restartPolicy": "Always", "containers": [container]}
    if data_volume is not None:
        # stateful singleton: its log/objects live on a PVC, and two pods
        # must NEVER serve the one state behind one Service — Recreate
        # tears the old pod down before the new one starts (a rolling
        # surge would split-brain the broker/store/engine)
        container["volumeMounts"] = [{"name": "data", "mountPath": "/data"}]
        pod_spec["volumes"] = [
            {"name": "data", "persistentVolumeClaim": {"claimName": data_volume}}
        ]
        strategy: dict[str, Any] = {"type": "Recreate"}
    else:
        # the reference rolls stateless updates 25%/25%
        # (reference deploy/router.yaml:11-18)
        strategy = {
            "type": "RollingUpdate",
            "rollingUpdate": {"maxUnavailable": "25%", "maxSurge": "25%"},
        }
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "labels": {"app": name}},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {"app": name}},
            "strategy": strategy,
            "template": {"metadata": pod_meta, "spec": pod_spec},
        },
    }


def _pvc(name: str, size: str = "10Gi") -> dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": {"name": name},
        "spec": {
            "accessModes": ["ReadWriteOnce"],
            "resources": {"requests": {"storage": size}},
        },
    }


def _service(name: str, port: int) -> dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "labels": {"app": name}},
        "spec": {
            "selector": {"app": name},
            "ports": [{"name": "http", "port": port, "targetPort": port}],
        },
    }


def _ingress(
    name: str, service: str, port: int, path: str = "/",
    class_name: str | None = None,
) -> dict[str, Any]:
    """External exposure for a Service — the portable analog of the
    reference's OpenShift Route (reference deploy/model/modelfull-route.yaml:
    1-12 exposes the Seldon model the same way: route -> service -> http
    port). networking.k8s.io/v1 Ingress so it applies on any conformant
    cluster; an OpenShift install can still `oc expose service <name>`.

    ``class_name`` (CR opt ``ingress_class``): clusters with no default
    IngressClass silently never reconcile class-less Ingresses — set it
    there (e.g. ``nginx``) or the object is accepted but never routed.
    """
    spec_extra: dict[str, Any] = (
        {"ingressClassName": class_name} if class_name else {}
    )
    return {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "Ingress",
        "metadata": {"name": name, "labels": {"app": service}},
        "spec": {
            **spec_extra,
            "rules": [
                {
                    "host": f"{name}.ccfd.local",
                    "http": {
                        "paths": [
                            {
                                "path": path,
                                "pathType": "Prefix",
                                "backend": {
                                    "service": {
                                        "name": service,
                                        "port": {"number": port},
                                    }
                                },
                            }
                        ]
                    },
                }
            ]
        },
    }


def _scrape(port: int, path: str) -> dict[str, str]:
    # reference wires Prometheus by pod annotation (README.md:292-301)
    return {
        "prometheus.io/scrape": "true",
        "prometheus.io/port": str(port),
        "prometheus.io/path": path,
    }


def build_manifests(
    spec: PlatformSpec, cfg: Config | None = None
) -> dict[str, list[dict[str, Any]]]:
    """One YAML document list per output file, keyed by file name."""
    cfg = cfg or Config()
    bus_url = "http://bus:9092"
    scorer_port = int(spec.component("scorer").opt("port", 8000))
    out: dict[str, list[dict[str, Any]]] = {}

    # --- bus (Strimzi Kafka cluster role; reference frauddetection_cr.yaml:73-77)
    parts = int(spec.component("bus").opt("partitions", 3))
    out["bus.yaml"] = [
        _pvc("bus-data"),
        _deployment(
            "bus",
            command=["python", "-m", "ccfd_tpu_torch", "bus",
                     "--host", "0.0.0.0", "--port", "9092",
                     "--partitions", str(parts), "--dir", "/data/bus"],
            env={},
            port=9092,
            probe_path="/healthz",
            data_volume="bus-data",
        ),
        _service("bus", 9092),
    ]

    # --- store (Ceph/Rook S3 role; reference README.md:136-269 + s3-secretceph.yaml)
    if spec.component("store").enabled:
        out["store.yaml"] = [
            {
                # reference deploy/ceph/s3-secretceph.yaml:1-8 (same secret
                # name + keys the producer template consumes)
                "apiVersion": "v1",
                "kind": "Secret",
                "metadata": {"name": "keysecret"},
                "type": "Opaque",
                "stringData": {"accesskey": "ccfd-access", "secretkey": "ccfd-secret"},
            },
            _pvc("store-data"),
            _deployment(
                "store",
                command=["python", "-m", "ccfd_tpu_torch", "store", "serve",
                         "--host", "0.0.0.0", "--port", "9000",
                         "--root", "/data/store"],
                data_volume="store-data",
                env={
                    "ACCESS_KEY_ID": {
                        "valueFrom": {"secretKeyRef": {"name": "keysecret", "key": "accesskey"}}
                    },
                    "SECRET_ACCESS_KEY": {
                        "valueFrom": {"secretKeyRef": {"name": "keysecret", "key": "secretkey"}}
                    },
                },
                port=9000,
            ),
            _service("store", 9000),
        ]

    # --- scorer (Seldon modelfull role; reference deploy/model/modelfull.json)
    sc = spec.component("scorer")
    out["scorer.yaml"] = [
        _deployment(
            "scorer",
            command=["python", "-m", "ccfd_tpu_torch", "serve",
                     "--host", "0.0.0.0", "--port", str(scorer_port), "--train"],
            env={
                "CCFD_MODEL": sc.opt("model", cfg.model_name),
                "CCFD_DTYPE": sc.opt("dtype", cfg.compute_dtype),
                "SELDON_TOKEN": cfg.seldon_token,
            },
            port=scorer_port,
            # reference annotates the model pod for scraping (README.md:292-301)
            annotations=_scrape(scorer_port, "/prometheus"),
            probe_path="/health/status",
            # the card is the whole point of this deployment; the
            # reference's 10Mi CPU pod (modelfull.json:27-31) becomes a GPU
            resources={"limits": {"nvidia.com/gpu": 1}},
        ),
        _service("scorer", scorer_port),
        # external exposure (reference modelfull-route.yaml exposes the
        # model service the same way)
        _ingress("scorer", "scorer", scorer_port,
                 class_name=sc.opt("ingress_class", "") or None),
    ]

    # --- engine (KIE server role; env contract deploy/ccd-service.yaml:54-66
    #     + optional knobs README.md:370-402)
    if spec.component("engine").enabled:
        out["engine.yaml"] = [
            _pvc("engine-data"),
            _deployment(
                "engine",
                command=["python", "-m", "ccfd_tpu_torch", "engine",
                         "--host", "0.0.0.0", "--port", "8090",
                         "--state-file", "/data/engine-state.json"],
                data_volume="engine-data",
                env={
                    "BROKER_URL": bus_url,
                    "CUSTOMER_NOTIFICATION_TOPIC": cfg.customer_notification_topic,
                    "SELDON_URL": f"http://scorer:{scorer_port}",
                    "SELDON_ENDPOINT": cfg.seldon_endpoint,
                    "SELDON_TOKEN": cfg.seldon_token,
                    "SELDON_TIMEOUT": cfg.seldon_timeout_ms,
                    "SELDON_POOL_SIZE": cfg.seldon_pool_size,
                    "CONFIDENCE_THRESHOLD": cfg.confidence_threshold,
                },
                port=8090,
                # reference scrapes KIE on :8090/rest/metrics (README.md:509-515)
                annotations=_scrape(8090, "/rest/metrics"),
                probe_path="/healthz",
            ),
            _service("engine", 8090),
            # KIE-shaped REST is operator-facing (process inspection,
            # signals) — exposed like the reference's service routes
            _ingress("engine", "engine", 8090,
                     class_name=spec.component("engine").opt("ingress_class", "")
                     or None),
        ]

    # --- router (ccd-fuse role; env contract deploy/router.yaml:54-70)
    if spec.component("router").enabled:
        out["router.yaml"] = [
            _deployment(
                "router",
                command=["python", "-m", "ccfd_tpu_torch", "router"],
                env={
                    "BROKER_URL": bus_url,
                    "CUSTOMER_NOTIFICATION_TOPIC": cfg.customer_notification_topic,
                    "CUSTOMER_RESPONSE_TOPIC": cfg.customer_response_topic,
                    "KAFKA_TOPIC": cfg.kafka_topic,
                    "KIE_SERVER_URL": "http://engine:8090",
                    "SELDON_ENDPOINT": cfg.seldon_endpoint,
                    "SELDON_URL": f"http://scorer:{scorer_port}",
                    "SELDON_TOKEN": cfg.seldon_token,
                    "FRAUD_THRESHOLD": cfg.fraud_threshold,
                },
                port=8091,
                # reference scrapes the router on :8091/prometheus (README.md:503-507)
                annotations=_scrape(8091, "/prometheus"),
            ),
            _service("router", 8091),
        ]

    # --- notify (env contract deploy/notification-service.yaml:47-52)
    if spec.component("notify").enabled:
        out["notify.yaml"] = [
            _deployment(
                "notify",
                command=["python", "-m", "ccfd_tpu_torch", "notify"],
                env={"BROKER_URL": bus_url},
                port=8080,
            ),
            _service("notify", 8080),
        ]

    # --- producer (env contract deploy/kafka/ProducerDeployment.yaml:77-97;
    #     lowercase names are the reference's own)
    if spec.component("producer").enabled:
        out["producer.yaml"] = [
            _deployment(
                "producer",
                command=["python", "-m", "ccfd_tpu_torch", "producer"],
                env={
                    "ACCESS_KEY_ID": {
                        "valueFrom": {"secretKeyRef": {"name": "keysecret", "key": "accesskey"}}
                    },
                    "SECRET_ACCESS_KEY": {
                        "valueFrom": {"secretKeyRef": {"name": "keysecret", "key": "secretkey"}}
                    },
                    "topic": cfg.kafka_topic,
                    "s3endpoint": "http://store:9000",
                    "s3bucket": cfg.s3_bucket,
                    "filename": cfg.filename,
                    "bootstrap": bus_url,
                },
                port=None,
            ),
        ]

    # --- monitoring: the Prometheus scrape config that consumes the pod
    # annotations above (the reference delegates this to ODH's monitoring
    # role, frauddetection_cr.yaml:79-81; here it is an explicit ConfigMap
    # any standard Prometheus deployment mounts as prometheus.yml)
    if spec.component("monitoring").enabled:
        prom_cfg = {
            "global": {"scrape_interval": "10s"},
            "scrape_configs": [
                {
                    # annotation-driven discovery: every pod above that sets
                    # prometheus.io/scrape=true is picked up on its declared
                    # port/path (reference wires scraping the same way,
                    # README.md:292-301)
                    "job_name": "ccfd-pods",
                    "kubernetes_sd_configs": [{"role": "pod"}],
                    "relabel_configs": [
                        {
                            "source_labels": ["__meta_kubernetes_pod_annotation_prometheus_io_scrape"],
                            "action": "keep",
                            "regex": "true",
                        },
                        {
                            "source_labels": ["__meta_kubernetes_pod_annotation_prometheus_io_path"],
                            "action": "replace",
                            "target_label": "__metrics_path__",
                            "regex": "(.+)",
                        },
                        {
                            "source_labels": [
                                "__address__",
                                "__meta_kubernetes_pod_annotation_prometheus_io_port",
                            ],
                            "action": "replace",
                            "regex": r"([^:]+)(?::\d+)?;(\d+)",
                            "replacement": "$1:$2",
                            "target_label": "__address__",
                        },
                    ],
                }
            ],
        }
        import yaml as _yaml

        out["monitoring.yaml"] = [
            {
                "apiVersion": "v1",
                "kind": "ConfigMap",
                "metadata": {"name": "prometheus-config"},
                "data": {"prometheus.yml": _yaml.safe_dump(prom_cfg, sort_keys=False)},
            },
        ]

    return out


def render_yaml(docs: list[dict[str, Any]]) -> str:
    import yaml

    return "\n---\n".join(
        yaml.safe_dump(d, sort_keys=False, default_flow_style=False) for d in docs
    )


def write_manifests(
    spec: PlatformSpec, out_dir: str, cfg: Config | None = None
) -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fname, docs in build_manifests(spec, cfg).items():
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            f.write(
                "# GENERATED by `python -m ccfd_tpu_torch manifests` from the platform CR.\n"
                "# Edit the CR (or ccfd_tpu_torch/platform/k8s.py), not this file.\n"
            )
            f.write(render_yaml(docs))
            f.write("\n")
        written.append(path)
    return written
