"""ModelVersion lineage + transition audit trail, persisted across restarts.

The port's copy of ccfd_tpu/lifecycle/versions.py; the lineage file is
byte-compatible, so either package's ``VersionStore`` reads the other's.

Every retrain candidate becomes a :class:`ModelVersion`: a monotonically
increasing id, its parent (the champion it was trained from), the label
watermark (how many labels the trainer had consumed when it produced the
candidate — the provenance question "which feedback shaped this model"),
a checkpoint ref (the step the params were saved under via
:class:`ccfd_tpu_torch.parallel.checkpoint.CheckpointManager`), and the eval
metrics recorded at each gate.

The store is the compliance surface the LLMOps-for-fraud/AML line of work
argues for (PAPERS.md): every stage transition appends an audit event
(who/when/why), and the whole lineage persists as one JSON file
(tmp+rename, crash-safe) so a restarted controller resumes with the same
champion, the same next-version counter, and the full history. ``path=None``
keeps everything in memory (tests, ephemeral runs).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Iterable

from ccfd_tpu_torch.runtime import durability

# stage vocabulary — the state machine the controller walks plus the
# terminal stamps the audit trail distinguishes
STAGES = (
    "TRAIN",        # created, not yet scoring anything
    "SHADOW",       # scoring live batches off the critical path
    "CANARY",       # serving a hash-split slice of live traffic
    "CHAMPION",     # the serving model
    "REJECTED",     # failed a SHADOW gate; never served
    "ROLLED_BACK",  # breached a CANARY guardrail; slice withdrawn
    "SUPERSEDED",   # a newer candidate replaced it before a verdict
    "RETIRED",      # a former champion after a promotion
)


@dataclasses.dataclass
class ModelVersion:
    version: int
    parent: int | None
    stage: str = "TRAIN"
    label_watermark: int = 0
    checkpoint_step: int | None = None
    # sha256 over the checkpoint's bytes (params.params_fingerprint, the
    # reference's parallel/partition.params_fingerprint byte for byte):
    # the same champion audits as the same hash in either package
    checkpoint_hash: str | None = None
    created_at: float = 0.0
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ModelVersion":
        return ModelVersion(
            version=int(d["version"]),
            parent=(None if d.get("parent") is None else int(d["parent"])),
            stage=str(d.get("stage", "TRAIN")),
            label_watermark=int(d.get("label_watermark", 0)),
            checkpoint_step=(None if d.get("checkpoint_step") is None
                             else int(d["checkpoint_step"])),
            checkpoint_hash=(None if d.get("checkpoint_hash") is None
                             else str(d["checkpoint_hash"])),
            created_at=float(d.get("created_at", 0.0)),
            metrics=dict(d.get("metrics", {})),
        )


class VersionStore:
    """Thread-safe lineage + audit persistence (one JSON file).

    The audit list is bounded (``max_audit_events``, oldest trimmed with a
    one-time truncation marker) so a long-lived deployment retraining
    every few minutes cannot grow the rewrite-on-every-transition JSON
    without limit; deployments needing the unbounded stream mirror events
    to the bus audit topic instead of this file."""

    def __init__(self, path: str | None = None,
                 max_audit_events: int = 8192,
                 max_versions: int = 512,
                 recover: bool = True):
        self.path = path
        self.max_audit_events = int(max_audit_events)
        # terminal-version bound (same rationale as the audit cap: the
        # whole file rewrites on every transition): oldest REJECTED/
        # SUPERSEDED/ROLLED_BACK/RETIRED versions age out past the cap;
        # the champion and any in-flight candidate are never evicted
        self.max_versions = int(max_versions)
        self._mu = threading.Lock()
        self._versions: dict[int, ModelVersion] = {}
        self._audit: list[dict[str, Any]] = []
        self._next = 1
        if path and recover:
            # recover=False is the read-only inspection surface: it must
            # never mutate the live directory (no sweep, no quarantine) —
            # a live writer's in-flight unique tmp is not debris
            durability.sweep_tmp(os.path.dirname(os.path.abspath(path)))
        if path and (os.path.exists(path) or durability.has_generations(path)):
            try:
                self._load(recover=recover)
            except (OSError, ValueError, KeyError, TypeError,
                    durability.CorruptArtifactError) as e:
                if not recover:
                    # read-only consumers (the inspection CLI) must
                    # REPORT corruption, never quarantine the live file
                    raise
                # NOTHING verifies — not the live file (quarantined to
                # *.corrupt by the durability layer) nor any retained
                # generation: the last resort is a fresh lineage rather
                # than a bricked bring-up (the loss is logged; the
                # champion re-bootstraps from the scorer's live params)
                import logging

                logging.getLogger(__name__).error(
                    "lifecycle lineage %s unreadable (%r) with no "
                    "verifiable generation; starting a FRESH lineage",
                    path, e)
                self._versions, self._audit, self._next = {}, [], 1

    # -- persistence -------------------------------------------------------
    def _load(self, recover: bool = True) -> None:
        # verified read: a torn/bit-flipped lineage quarantines and falls
        # back to the last-good retained generation (runtime/durability.py).
        # A LEGACY (unframed) file carries no checksum, so its corruption
        # only surfaces at the JSON parse — quarantine it then and retry,
        # which reads straight from the generations.
        import json

        data = None
        for attempt in (0, 1):
            payload = durability.read_artifact(
                self.path, artifact="lineage", fallback=True,
                quarantine=recover)
            try:
                data = json.loads(payload)
                break
            except ValueError:
                if not recover or attempt:
                    raise
                durability.note("corrupt", artifact="lineage")
                # ccfd-lint: disable=durability-seam -- quarantine rename (the sanctioned exception): counted via note() the line above
                os.replace(self.path, f"{self.path}.corrupt")
        self._versions = {
            int(v["version"]): ModelVersion.from_dict(v)
            for v in data.get("versions", [])
        }
        self._audit = list(data.get("audit", []))
        # the counter must survive restarts even past deleted checkpoints:
        # persisted explicitly AND floored by the observed ids
        self._next = max(
            int(data.get("next_version", 1)),
            max(self._versions, default=0) + 1,
        )

    def _save_locked(self) -> None:
        if not self.path:
            return
        # checksummed + fsynced + atomic, with generation retention: the
        # constructor's verified read falls back to the newest retained
        # generation when the live file is torn or bit-flipped. A failed
        # write (full disk, injected fault) keeps the last-good state —
        # lineage lives in memory and lands on the next transition.
        durability.write_json_artifact(
            self.path,
            {
                "next_version": self._next,
                "versions": [
                    v.to_dict() for _, v in sorted(self._versions.items())
                ],
                "audit": self._audit,
            },
            artifact="lineage",
            indent=1,
        )

    # -- lineage -----------------------------------------------------------
    def create(
        self,
        parent: int | None,
        label_watermark: int = 0,
        checkpoint_step: int | None = None,
        stage: str = "TRAIN",
    ) -> ModelVersion:
        with self._mu:
            v = ModelVersion(
                version=self._next,
                parent=parent,
                stage=stage,
                label_watermark=int(label_watermark),
                checkpoint_step=checkpoint_step,
                created_at=time.time(),
            )
            self._next += 1
            self._versions[v.version] = v
            self._append_event_locked(
                v.version, "created",
                {"parent": parent, "label_watermark": v.label_watermark},
            )
            self._trim_versions_locked()
            self._save_locked()
            return v

    _TERMINAL = ("REJECTED", "SUPERSEDED", "ROLLED_BACK", "RETIRED")

    def _trim_versions_locked(self) -> None:
        excess = len(self._versions) - self.max_versions
        if excess <= 0:
            return
        terminal = sorted(
            (v for v in self._versions.values() if v.stage in self._TERMINAL),
            key=lambda v: v.version,
        )[:excess]
        if not terminal:
            return  # only live versions: never evict those
        for v in terminal:
            del self._versions[v.version]
        self._append_event_locked(
            None, "versions_trimmed",
            {"evicted": [v.version for v in terminal],
             "note": "oldest terminal versions aged out by the "
                     "max_versions bound"},
        )

    def set_stage(
        self,
        version: int,
        stage: str,
        reason: str = "",
        metrics: dict[str, Any] | None = None,
    ) -> ModelVersion:
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}; known: {STAGES}")
        with self._mu:
            v = self._versions[int(version)]
            prev = v.stage
            v.stage = stage
            if metrics:
                v.metrics.update(metrics)
            self._append_event_locked(
                v.version, "stage",
                {"from": prev, "to": stage, "reason": reason,
                 **({"metrics": metrics} if metrics else {})},
            )
            self._save_locked()
            return v

    def record_event(self, version: int | None, event: str,
                     detail: dict[str, Any] | None = None) -> None:
        with self._mu:
            self._append_event_locked(version, event, detail or {})
            self._save_locked()

    def set_checkpoint(self, version: int, checkpoint_step: int,
                       checkpoint_hash: str | None = None) -> None:
        with self._mu:
            v = self._versions[int(version)]
            v.checkpoint_step = int(checkpoint_step)
            if checkpoint_hash is not None:
                v.checkpoint_hash = str(checkpoint_hash)
            self._save_locked()

    def _append_event_locked(self, version: int | None, event: str,
                             detail: dict[str, Any]) -> None:
        self._audit.append(
            {"ts": time.time(), "version": version, "event": event,
             "detail": detail}
        )
        if len(self._audit) > self.max_audit_events:
            trimmed = len(self._audit) - self.max_audit_events
            self._audit = self._audit[trimmed:]
            if self._audit[0].get("event") != "audit_trimmed":
                self._audit.insert(0, {
                    "ts": time.time(), "version": None,
                    "event": "audit_trimmed",
                    "detail": {"note": "older events dropped by the "
                                       "max_audit_events bound"},
                })

    # -- queries -----------------------------------------------------------
    def get(self, version: int) -> ModelVersion:
        with self._mu:
            return self._versions[int(version)]

    def versions(self) -> list[ModelVersion]:
        with self._mu:
            return [v for _, v in sorted(self._versions.items())]

    def champion(self) -> ModelVersion | None:
        with self._mu:
            champs = [v for v in self._versions.values()
                      if v.stage == "CHAMPION"]
            # at most one champion by construction; latest wins defensively
            return max(champs, key=lambda v: v.version, default=None)

    def in_stage(self, *stages: str) -> list[ModelVersion]:
        with self._mu:
            return sorted(
                (v for v in self._versions.values() if v.stage in stages),
                key=lambda v: v.version,
            )

    def audit_trail(self, version: int | None = None) -> list[dict[str, Any]]:
        with self._mu:
            if version is None:
                return list(self._audit)
            return [e for e in self._audit if e["version"] == version]

    def lineage(self, version: int) -> Iterable[ModelVersion]:
        """The version and its ancestors, newest first."""
        cur: int | None = int(version)
        while cur is not None:
            with self._mu:
                v = self._versions.get(cur)
            if v is None:
                return
            yield v
            cur = v.parent
