"""Lifecycle controller: guardrailed SHADOW -> CANARY -> PROMOTE | ROLLBACK.

The port's copy of ccfd_tpu/lifecycle/controller.py. Host copies of the
params are numpy trees taken off the scorer's tensors (``_host_copy``);
the lineage hash is ``params.params_fingerprint``, the reference's byte
for byte. The champion serves only through ``Scorer.swap_params`` into
the scorer's kernel (B1 for ``mlp``); the challenger scores on the
model's numpy host forward, off the card's critical path, as in the
reference.

The governed replacement for the trainer's blind ``swap_params``:

- ``submit_candidate(params, label_watermark)`` (called by
  :class:`~ccfd_tpu_torch.parallel.online.OnlineTrainer`) checkpoints the
  candidate (:class:`~ccfd_tpu_torch.parallel.checkpoint.CheckpointManager`),
  records its lineage, installs it in the scorer's double-buffered
  challenger slot and arms the shadow tap. A candidate submitted while one
  is already in flight supersedes it (newest feedback wins; the audit trail
  records the supersession).
- **SHADOW gate**: once ``min_labels`` labels and ``min_shadow_rows``
  shadow pairs accumulate, the candidate is judged — challenger AUC within
  ``auc_margin`` of the champion's, alert-rate delta under
  ``max_alert_rate_delta``, score-distribution PSI under ``max_score_psi``.
  Any breach REJECTS the candidate (champion untouched).
- **CANARY**: the survivor serves a deterministic ``canary_weight`` slice
  of live traffic through the :class:`CanaryGate`, which drives the
  :mod:`ccfd_tpu_torch.serving.graph` ``hash_split`` ROUTER's per-row
  traffic-split (the same hash, the same weights semantics — stable across
  processes and jit re-traces, test-asserted). Guardrails stay armed the
  whole phase, and a scorer-edge circuit breaker leaving CLOSED is itself
  a breach: any of them auto-rolls back to the champion checkpoint and
  records the audit event.
- **PROMOTE**: after ``canary_min_labels`` further labels with guardrails
  green, the challenger's params swap into the serving scorer, the old
  champion retires, and the lineage/audit trail records the promotion.

Everything is observable: ``ccfd_lifecycle_stage`` (0 idle / 1 shadow /
2 canary), ``ccfd_lifecycle_promotions_total`` /
``ccfd_lifecycle_rollbacks_total`` / ``ccfd_lifecycle_rejections_total``,
champion/candidate version gauges, and per-arm canary row counters.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable

import numpy as np
import torch

from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.lifecycle.evaluator import EvalSnapshot, ShadowEvaluator
from ccfd_tpu_torch.lifecycle.shadow import ShadowTap
from ccfd_tpu_torch.lifecycle.versions import VersionStore
from ccfd_tpu_torch.params import tree_map

log = logging.getLogger(__name__)

# ccfd_lifecycle_stage gauge values
STAGE_IDLE, STAGE_SHADOW, STAGE_CANARY = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Guardrails:
    """The gates a candidate must clear; every ceiling also stays armed
    through CANARY (a breach there triggers auto-rollback)."""

    min_labels: int = 128          # labels joined before a SHADOW verdict
    min_shadow_rows: int = 1024    # shadow pairs before PSI/alert gates bind
    auc_margin: float = 0.01       # challenger AUC >= champion AUC - margin
    max_alert_rate_delta: float = 0.10  # extra alert fraction allowed
    max_score_psi: float = 0.25    # drift ceiling (PSI > 0.25 = action)
    canary_weight: float = 0.10    # traffic fraction served by the canary
    canary_min_labels: int = 64    # labels DURING canary before promotion
    # submission coalescing: a trainer that retrains on every label batch
    # can submit faster than a verdict window fills, superseding every
    # candidate before judgment — a livelock where nothing ever promotes.
    # Submissions inside this interval of the last ACCEPTED one are
    # coalesced (counted, no version created); the in-flight candidate
    # keeps its evidence and the trainer's next submission carries the
    # newer labels anyway. 0 = accept every submission (tests/drills).
    min_submit_interval_s: float = 30.0


class CanaryGate:
    """Per-row deterministic traffic split between champion and challenger.

    Drives the serving-graph ``hash_split`` ROUTER's weights: arm
    assignment uses :func:`ccfd_tpu_torch.serving.graph.hash_split_arms_numpy`,
    the host mirror of the compiled router component, so a row lands on
    the same arm here, in a compiled canary graph, in another process, and
    across jit re-traces. Champion rows keep the device-scored result;
    challenger rows re-score on the challenger slot's host forward (the
    canary slice is small by construction, so the extra host work is
    bounded by ``canary_weight``)."""

    def __init__(self, scorer: Any, registry: Any = None):
        self.scorer = scorer
        self._active = False  # hot-path gate: plain attr read
        self._weights: tuple[float, float] = (1.0, 0.0)
        self._c_rows = self._c_errors = None
        if registry is not None:
            self._c_rows = registry.counter(
                "ccfd_lifecycle_canary_rows_total",
                "rows served during canary, by arm",
            )
            self._c_errors = registry.counter(
                "ccfd_lifecycle_canary_errors_total",
                "challenger canary-score failures (rows fell back to the "
                "champion score)",
            )

    def activate(self, weight: float) -> None:
        w = min(max(float(weight), 0.0), 1.0)
        self._weights = (1.0 - w, w)
        self._active = True

    def deactivate(self) -> None:
        self._active = False
        self._weights = (1.0, 0.0)

    @property
    def active(self) -> bool:
        return self._active

    @property
    def weights(self) -> tuple[float, float]:
        return self._weights

    def apply(self, x: np.ndarray, proba: np.ndarray,
              rescore: Callable[[np.ndarray], np.ndarray] | None = None,
              ) -> np.ndarray:
        """Override one batch's challenger arm. ``x`` (B, F) drives the
        deterministic hash split; ``rescore(mask) -> (n_chall,) scores``
        lets context-aware scorers (the SeqScorer's history-conditioned
        lane) re-score the challenger arm against the SAME assembled
        contexts — default is the challenger slot's cold forward on the
        masked feature rows (the row lane)."""
        if not self._active:
            return proba
        from ccfd_tpu_torch.serving.graph import hash_split_arms_numpy

        arms = hash_split_arms_numpy(x, self._weights)
        mask = arms == 1
        n_chall = int(mask.sum())
        if n_chall:
            try:
                if rescore is not None:
                    chall = rescore(mask)
                else:
                    chall = self.scorer.challenger_score(
                        np.asarray(x, np.float32)[mask])
            except Exception:  # noqa: BLE001 - challenger gone mid-swap:
                # champion scores stand; the controller sees the error
                # counter and the breaker sees nothing (host-side only)
                if self._c_errors is not None:
                    self._c_errors.inc(n_chall)
                return proba
            proba = np.array(proba, np.float32, copy=True)
            proba[mask] = chall
        if self._c_rows is not None:
            self._c_rows.inc(len(x) - n_chall,
                             labels={"arm": "champion"})
            if n_chall:
                self._c_rows.inc(n_chall, labels={"arm": "challenger"})
        return proba

    def wrap(self, score_fn: Callable[[np.ndarray], np.ndarray]) -> Callable:
        def gated(x: np.ndarray) -> np.ndarray:
            proba = score_fn(x)
            if not self._active:
                return proba
            return self.apply(x, proba)

        gated.__wrapped__ = score_fn
        return gated


class LifecycleController:
    """Owns the candidate state machine; supervisor-shaped daemon."""

    def __init__(
        self,
        cfg: Config,
        scorer: Any,
        store: VersionStore,
        checkpoints: Any,
        shadow: ShadowTap,
        evaluator: ShadowEvaluator,
        gate: CanaryGate | None = None,
        guardrails: Guardrails | None = None,
        registry: Any = None,
        breaker: Any = None,
        storage_pin: Callable[[str], None] | None = None,
        storage_unpin: Callable[[], None] | None = None,
    ):
        self.cfg = cfg
        self.scorer = scorer
        self.store = store
        self.checkpoints = checkpoints
        self.shadow = shadow
        self.evaluator = evaluator
        self.gate = gate if gate is not None else CanaryGate(scorer, registry)
        self.guardrails = guardrails or Guardrails()
        self.breaker = breaker  # scorer-edge CircuitBreaker (may be None)
        # storage-integrity pin (runtime/durability.StoragePinGate): when
        # the champion's checkpoint — and every verifiable fallback step —
        # is corrupt, serving must pin to the RULES tier through the
        # heal-gate seam rather than publish an unverified tree; cleared
        # the moment a verified tree is published again
        self._storage_pin = storage_pin
        self._storage_unpin = storage_unpin
        self.storage_pinned = False
        # rebase hook (wired by the operator to OnlineTrainer.rebase): on
        # REJECT/ROLLBACK the trainer's training state re-bases onto the
        # champion, so later candidates genuinely DESCEND from the
        # champion the lineage records as their parent — without it the
        # trainer keeps training on rejected weights and the audit
        # trail's provenance claim is false
        self.trainer_rebase: Callable[[Any], None] | None = None
        self._mu = threading.RLock()
        self._stop = threading.Event()

        self._candidate: int | None = None
        self._candidate_params: Any = None
        self._stage = STAGE_IDLE

        r = registry
        self._g_stage = self._g_champion = self._g_candidate = None
        self._c_promoted = self._c_rolled_back = None
        self._c_rejected = self._c_candidates = None
        self._c_coalesced = None
        self._last_accept_mono: float | None = None
        if r is not None:
            self._g_stage = r.gauge(
                "ccfd_lifecycle_stage",
                "candidate stage: 0 idle, 1 shadow, 2 canary",
            )
            self._g_stage.set(STAGE_IDLE)
            self._g_champion = r.gauge(
                "ccfd_lifecycle_champion_version", "serving model version"
            )
            self._g_candidate = r.gauge(
                "ccfd_lifecycle_candidate_version",
                "candidate version in flight (-1 = none)",
            )
            self._g_candidate.set(-1)
            self._c_candidates = r.counter(
                "ccfd_lifecycle_candidates_total",
                "retrain candidates submitted to the lifecycle",
            )
            self._c_promoted = r.counter(
                "ccfd_lifecycle_promotions_total",
                "candidates promoted to champion through the full gate",
            )
            self._c_rolled_back = r.counter(
                "ccfd_lifecycle_rollbacks_total",
                "canary auto-rollbacks to the champion checkpoint",
            )
            self._c_rejected = r.counter(
                "ccfd_lifecycle_rejections_total",
                "candidates rejected at the SHADOW gate",
            )
            self._c_coalesced = r.counter(
                "ccfd_lifecycle_submissions_coalesced_total",
                "trainer submissions coalesced into the in-flight "
                "candidate (min_submit_interval_s pacing)",
            )

        # champion bootstrap: resume the persisted lineage, or version the
        # scorer's current params as the genesis champion
        champ = store.champion()
        if champ is None:
            v = store.create(parent=None, stage="TRAIN")
            self._champion_params = self._host_copy(scorer.params)
            # pin BEFORE save: save() runs GC, and the champion's
            # checkpoint must survive any number of later candidates
            checkpoints.pinned = {v.version}
            checkpoints.save(v.version, self._champion_params)
            store.set_checkpoint(
                v.version, v.version,
                checkpoint_hash=self._fingerprint(self._champion_params))
            store.set_stage(v.version, "CHAMPION", reason="bootstrap")
            self.champion = v.version
        else:
            self.champion = champ.version
            if champ.checkpoint_step is not None:
                checkpoints.pinned = {champ.checkpoint_step}
            self._champion_params = self._restore_params(champ)
            # re-assert the persisted champion INTO SERVING: the scorer
            # was just built from its boot params, and the lineage says
            # champ.version serves — without this swap the audit trail
            # and the live model disagree after every restart
            self.scorer.swap_params(self._champion_params)
            restored_hash = self._fingerprint(self._champion_params)
            if (champ.checkpoint_hash is not None and restored_hash
                    and restored_hash != champ.checkpoint_hash):
                # the restored bytes are not the recorded champion: the
                # checkpoint was GC'd/corrupted and the fallback (live
                # scorer params) took over — serve, but say so loudly,
                # and RE-STAMP the lineage record so the next restart of
                # the now-stable tree doesn't re-raise the same alarm
                # (the audit event below preserves the divergence)
                log.error(
                    "lifecycle restart: champion v%d checkpoint hash "
                    "mismatch (recorded %s, restored %s) — serving the "
                    "restored tree, lineage re-stamped",
                    champ.version, champ.checkpoint_hash[:12],
                    restored_hash[:12])
                if champ.checkpoint_step is not None:
                    store.set_checkpoint(champ.version,
                                         champ.checkpoint_step,
                                         checkpoint_hash=restored_hash)
            store.record_event(self.champion, "restart_restore",
                               {"checkpoint": champ.checkpoint_step,
                                "checkpoint_hash": restored_hash})
            # interrupted candidates did not survive the restart
            # (challenger slot and gate state are process-local). Stage
            # vocabulary stays truthful: only a candidate that actually
            # SERVED a canary slice is stamped ROLLED_BACK; shadow-only
            # ones were simply displaced (no serving ever changed)
            for v in store.in_stage("CANARY"):
                store.set_stage(v.version, "ROLLED_BACK",
                                reason="controller restart mid-canary")
            for v in store.in_stage("SHADOW", "TRAIN"):
                store.set_stage(v.version, "SUPERSEDED",
                                reason="controller restart")
        if self._g_champion is not None:
            self._g_champion.set(self.champion)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _host_copy(params: Any) -> Any:
        """A fresh host numpy copy of a param tree (tensors copied off
        their device, each leaf keeping its dtype), so checkpoints, hashes
        and the challenger slot never alias the trainer's or the scorer's
        tensors."""
        return tree_map(lambda a: (a.detach().cpu().numpy().copy()
                                   if isinstance(a, torch.Tensor) else np.array(a)), params)

    @staticmethod
    def _fingerprint(params: Any) -> str | None:
        """The checkpoint hash (sha256 over the tree's bytes,
        params.params_fingerprint, the reference's byte for byte)."""
        from ccfd_tpu_torch.params import params_fingerprint

        try:
            return params_fingerprint(params)
        except Exception:  # noqa: BLE001 - provenance, not control flow
            log.exception("lifecycle: params fingerprint failed")
            return None

    def _restore_params(self, version) -> Any:
        """Champion params from its checkpoint, with integrity fallback: a
        corrupt recorded checkpoint is quarantined by the
        CheckpointManager and the restore walks to the NEWEST VERIFIABLE
        step — the pinned set (the champion's own) first, then the
        remaining steps newest-first, which reaches the parent champion's
        retained checkpoint. When a checkpoint was recorded but NOTHING
        verifies, serving pins to the rules tier (storage_pin) instead of
        publishing an unverified tree; the caller's existing hash-mismatch
        alarm fires and re-stamps the lineage on any fallback serve."""
        from ccfd_tpu_torch.runtime.durability import CorruptArtifactError

        like = self._host_copy(self.scorer.params)
        step = version.checkpoint_step
        if step is None:
            return like  # genesis bootstrap: nothing recorded yet
        order: list[int] = [step]
        order += sorted(self.checkpoints.pinned, reverse=True)
        seen: set[int] = set()
        saw_corrupt = False
        for s in order:
            if s in seen:
                continue
            seen.add(s)
            try:
                restored = self.checkpoints.restore(like, step=s)
            except CorruptArtifactError:
                saw_corrupt = True
                log.error("champion v%d checkpoint step %d corrupt "
                          "(quarantined); trying the next verifiable step",
                          version.version, s)
                continue
            except (FileNotFoundError, OSError, ValueError):
                continue
            if restored is not None:
                self._note_storage_restore(version, s, step)
                return self._host_copy(restored[0])
        # the recorded step (and every pin) failed: newest verifiable step
        # of the whole retained history, the parent champion included
        s = self.checkpoints.newest_verified_step()
        if s is not None and s not in seen:
            try:
                restored = self.checkpoints.restore(like, step=s)
                if restored is not None:
                    self._note_storage_restore(version, s, step)
                    return self._host_copy(restored[0])
            except (CorruptArtifactError, FileNotFoundError, OSError,
                    ValueError):
                pass
        if not saw_corrupt and self.checkpoints.latest_step() is None:
            # nothing on disk at all — every step MISSING (GC'd root,
            # wiped volume), none corrupt: the scorer's live tree is a
            # healthy verified init, not quarantined evidence. Serve it
            # with the historical warning; the pin is for the
            # corruption-detected case only (saw_corrupt also covers a
            # lone corrupt genesis step the walk just quarantined out of
            # the listing).
            log.warning("champion v%d checkpoint %s missing (no steps on "
                        "disk); using the scorer's live params",
                        version.version, step)
            self._clear_storage_pin()
            return like
        log.error(
            "champion v%d: no checkpoint generation verifies (recorded "
            "step %s); pinning serving to the RULES tier rather than "
            "publishing an unverified tree", version.version, step)
        self._pin_storage(
            f"no verifiable checkpoint for champion v{version.version}")
        return like

    def _note_storage_restore(self, version, served_step: int,
                              recorded_step: int) -> None:
        """A verified tree is about to serve: clear any storage pin, and
        audit a fallback serve (the hash re-stamp alarm in the restart
        path fires on top of this when the bytes differ)."""
        self._clear_storage_pin()
        if served_step != recorded_step:
            self.store.record_event(
                version.version, "storage_fallback_restore",
                {"recorded_step": recorded_step, "served_step": served_step,
                 "note": "recorded checkpoint unverifiable; newest "
                         "verifiable generation served"})

    def _pin_storage(self, reason: str) -> None:
        self.storage_pinned = True
        if self._storage_pin is not None:
            try:
                self._storage_pin(reason)
            except Exception:  # noqa: BLE001 - the pin is protective
                log.exception("storage pin hook failed")
        self.store.record_event(None, "storage_pin", {"reason": reason})

    def _clear_storage_pin(self) -> None:
        if not self.storage_pinned:
            return
        self.storage_pinned = False
        if self._storage_unpin is not None:
            try:
                self._storage_unpin()
            except Exception:  # noqa: BLE001
                log.exception("storage unpin hook failed")
        self.store.record_event(None, "storage_unpin",
                                {"reason": "verified params published"})

    def wrap_score(self, score_fn: Callable) -> Callable:
        """Compose the serving lane: shadow tap inside (sees pure champion
        scores), canary gate outside (overrides the challenger arm). This
        is what the operator hands the router / coalescing batcher."""
        return self.gate.wrap(self.shadow.wrap(score_fn))

    # -- trainer entry point ----------------------------------------------
    def submit_candidate(self, params: Any, label_watermark: int = 0) -> int:
        """Register a retrain candidate and start its SHADOW phase.
        Thread-safe: called from the trainer thread while step() runs on
        the controller's. Returns the new version id."""
        import time as _time

        with self._mu:
            # pacing FIRST (before any param copy — the coalesce branch
            # must cost nothing): a trainer retraining on every label
            # batch must not supersede the in-flight candidate before its
            # verdict window can fill (livelock: nothing would ever
            # promote). Coalesced submissions keep the in-flight
            # candidate and its evidence.
            now = _time.monotonic()
            if (self._candidate is not None
                    and self._last_accept_mono is not None
                    and (now - self._last_accept_mono)
                    < self.guardrails.min_submit_interval_s):
                if self._c_coalesced is not None:
                    self._c_coalesced.inc()
                return self._candidate
            self._last_accept_mono = now
            staged = self._host_copy(params)  # trainer donates its state
            if self._candidate is not None:
                old = self._candidate
                self._clear_candidate_serving()
                self.store.set_stage(
                    old, "SUPERSEDED",
                    reason="newer candidate submitted before a verdict")
            v = self.store.create(
                parent=self.champion, label_watermark=label_watermark)
            self.checkpoints.save(v.version, staged)
            self.store.set_checkpoint(
                v.version, v.version,
                checkpoint_hash=self._fingerprint(staged))
            self._candidate = v.version
            self._candidate_params = staged
            self.scorer.install_challenger(v.version, staged)
            self.evaluator.begin(v.version)
            self.shadow.arm(v.version)
            self._set_stage(STAGE_SHADOW)
            self.store.set_stage(v.version, "SHADOW")
            if self._c_candidates is not None:
                self._c_candidates.inc()
            if self._g_candidate is not None:
                self._g_candidate.set(v.version)
            return v.version

    # -- state machine -----------------------------------------------------
    def _set_stage(self, stage: int) -> None:
        self._stage = stage
        if self._g_stage is not None:
            self._g_stage.set(stage)

    @property
    def stage(self) -> int:
        return self._stage

    @property
    def candidate(self) -> int | None:
        return self._candidate

    def _clear_candidate_serving(self) -> None:
        """Withdraw the candidate from every serving surface (under _mu)."""
        self.gate.deactivate()
        self.shadow.disarm()
        self.scorer.clear_challenger()
        self.evaluator.end()
        self._candidate = None
        self._candidate_params = None
        self._set_stage(STAGE_IDLE)
        if self._g_candidate is not None:
            self._g_candidate.set(-1)

    def _shadow_breaches(self, s: EvalSnapshot) -> list[str]:
        g = self.guardrails
        breaches = []
        if (np.isfinite(s.auc_champion) and np.isfinite(s.auc_challenger)
                and s.auc_challenger < s.auc_champion - g.auc_margin):
            breaches.append(
                f"auc {s.auc_challenger:.4f} < champion "
                f"{s.auc_champion:.4f} - margin {g.auc_margin}")
        if (np.isfinite(s.alert_rate_delta)
                and abs(s.alert_rate_delta) > g.max_alert_rate_delta):
            breaches.append(
                f"alert_rate_delta {s.alert_rate_delta:+.4f} exceeds "
                f"{g.max_alert_rate_delta}")
        if np.isfinite(s.score_psi) and s.score_psi > g.max_score_psi:
            breaches.append(
                f"score_psi {s.score_psi:.4f} exceeds {g.max_score_psi}")
        return breaches

    def step(self) -> bool:
        """One control cycle: fold new evidence, judge the gates. Returns
        whether a transition happened (so the run loop can idle). The poll
        runs under _mu too: the trainer thread's submit_candidate resets
        the same evaluator accumulators (begin/end), and an unserialized
        poll could split its paired extends across the reset."""
        with self._mu:
            self.evaluator.poll()
            if self._candidate is None:
                return False
            if self._stage == STAGE_SHADOW:
                return self._step_shadow()
            if self._stage == STAGE_CANARY:
                return self._step_canary()
            return False

    def _step_shadow(self) -> bool:
        g = self.guardrails
        # cheap counters gate the expensive snapshot: a candidate parked
        # below its thresholds must not pay full-history rank sorts (under
        # _mu, blocking the trainer's submits) every 250 ms tick
        if (self.evaluator.n_labels < g.min_labels
                or self.evaluator.n_shadow_rows < g.min_shadow_rows):
            return False
        snap = self.evaluator.snapshot()
        breaches = self._shadow_breaches(snap)
        if breaches:
            self._reject(snap, breaches)
            return True
        self._enter_canary(snap)
        return True

    def _step_canary(self) -> bool:
        g = self.guardrails
        if self.breaker is not None and self.breaker.state != "closed":
            self._rollback(
                self.evaluator.snapshot(),
                [f"scorer-edge breaker {self.breaker.state}"])
            return True
        # judge the CANARY WINDOW (evidence since _enter_canary's mark),
        # not the running total: a regression that only shows up under
        # canary serving must not be diluted by the green shadow history.
        # Distribution gates bind once the window has a meaningful sample;
        # the AUC gate binds at the promotion decision's label count (a
        # handful of window labels would be noise, not evidence).
        w = self.evaluator.snapshot_window()
        breaches: list[str] = []
        if w.n_shadow_rows >= max(1, self.guardrails.min_shadow_rows // 4):
            if (np.isfinite(w.alert_rate_delta)
                    and abs(w.alert_rate_delta) > g.max_alert_rate_delta):
                breaches.append(
                    f"canary alert_rate_delta {w.alert_rate_delta:+.4f} "
                    f"exceeds {g.max_alert_rate_delta}")
            if np.isfinite(w.score_psi) and w.score_psi > g.max_score_psi:
                breaches.append(
                    f"canary score_psi {w.score_psi:.4f} exceeds "
                    f"{g.max_score_psi}")
        ready = w.n_labels >= g.canary_min_labels
        if ready and (np.isfinite(w.auc_champion)
                      and np.isfinite(w.auc_challenger)
                      and w.auc_challenger < w.auc_champion - g.auc_margin):
            breaches.append(
                f"canary auc {w.auc_challenger:.4f} < champion "
                f"{w.auc_champion:.4f} - margin {g.auc_margin}")
        if breaches:
            self._rollback(w, breaches)
            return True
        if ready:
            # the full-history snapshot is the promote record's metrics;
            # computed only here, at the decision, not per tick
            self._promote(self.evaluator.snapshot())
            return True
        return False

    def _rebase_trainer(self) -> None:
        """Point the trainer back at the champion's weights so the next
        candidate descends from the lineage's recorded parent, not from
        the just-discarded candidate."""
        if self.trainer_rebase is None:
            return
        try:
            self.trainer_rebase(self._champion_params)
        except Exception:  # noqa: BLE001 - a dead trainer must not block
            log.exception("lifecycle: trainer rebase after discard failed")

    def _reject(self, snap: EvalSnapshot, breaches: list[str]) -> None:
        v = self._candidate
        log.warning("lifecycle: candidate v%d REJECTED in shadow: %s",
                    v, "; ".join(breaches))
        self._clear_candidate_serving()
        self.store.set_stage(v, "REJECTED", reason="; ".join(breaches),
                             metrics=snap.to_dict())
        if self._c_rejected is not None:
            self._c_rejected.inc()
        self._rebase_trainer()

    def _enter_canary(self, snap: EvalSnapshot) -> None:
        g = self.guardrails
        v = self._candidate
        # canary guardrails judge the evidence window that starts HERE
        self.evaluator.mark()
        self.gate.activate(g.canary_weight)
        self._set_stage(STAGE_CANARY)
        self.store.set_stage(
            v, "CANARY",
            reason=f"shadow gates passed; weight={g.canary_weight}",
            metrics=snap.to_dict())
        log.info("lifecycle: candidate v%d entered canary at weight %.2f",
                 v, g.canary_weight)

    def _promote(self, snap: EvalSnapshot) -> None:
        v = self._candidate
        params = self._candidate_params
        old_champion = self.champion
        self.gate.deactivate()
        self.scorer.swap_params(params)
        # the promoted tree was checkpointed (verified) at submit: a
        # storage pin from an earlier unverifiable restart clears here
        self._clear_storage_pin()
        self.shadow.disarm()
        self.scorer.clear_challenger()
        self.evaluator.end()
        self.champion = v
        self._champion_params = params
        # the new champion's checkpoint is now the rollback/restart
        # anchor: re-point the GC pin at it (the retired one may age out)
        self.checkpoints.pinned = {v}
        self._candidate = None
        self._candidate_params = None
        self._set_stage(STAGE_IDLE)
        self.store.set_stage(old_champion, "RETIRED",
                             reason=f"superseded by v{v}")
        self.store.set_stage(v, "CHAMPION",
                             reason=f"canary gates passed over "
                                    f"{snap.n_labels} labels",
                             metrics=snap.to_dict())
        if self._c_promoted is not None:
            self._c_promoted.inc()
        if self._g_champion is not None:
            self._g_champion.set(v)
        if self._g_candidate is not None:
            self._g_candidate.set(-1)
        log.info("lifecycle: candidate v%d PROMOTED (champion was v%d)",
                 v, old_champion)

    def _rollback(self, snap: EvalSnapshot, breaches: list[str]) -> None:
        v = self._candidate
        log.warning("lifecycle: candidate v%d ROLLED BACK from canary: %s",
                    v, "; ".join(breaches))
        self._clear_candidate_serving()
        # restore the champion checkpoint into serving: the canary slice
        # disappears with the gate, and the champion params re-assert so a
        # raced promote/partial swap can never leave mixed weights live
        champion = self.store.get(self.champion)
        params = self._restore_params(champion)
        self.scorer.swap_params(params)
        self._champion_params = params
        self.store.set_stage(v, "ROLLED_BACK", reason="; ".join(breaches),
                             metrics=snap.to_dict())
        self.store.record_event(
            self.champion, "rollback_restore",
            {"from_candidate": v, "checkpoint": champion.checkpoint_step,
             "checkpoint_hash": self._fingerprint(params)})
        if self._c_rolled_back is not None:
            self._c_rolled_back.inc()
        self._rebase_trainer()

    def restore_champion(self) -> None:
        """Re-assert the champion's CHECKPOINT as the serving params —
        the device heal ladder's respawn rung (runtime/heal.py): a
        quarantined scorer respawns from the durable champion checkpoint,
        not from whatever tree the wedge left on device. Serialized under
        the controller lock so a respawn racing a concurrent
        rollback/promotion cannot interleave half of each swap: whichever
        runs second re-asserts a complete, consistent champion tree (the
        heal-vs-recovery invariant: serving params == champion
        checkpoint)."""
        with self._mu:
            champion = self.store.get(self.champion)
            params = self._restore_params(champion)
            self.scorer.swap_params(params)
            self._champion_params = params
            self.store.record_event(
                self.champion, "heal_respawn_restore",
                {"checkpoint": champion.checkpoint_step,
                 "checkpoint_hash": self._fingerprint(params)})

    def resolve_for_shutdown(self) -> None:
        """Deterministic quiesce: an in-flight candidate is withdrawn so
        the pool is left serving exactly one version (soak/drill
        teardown). Only a candidate actually SERVING a canary slice takes
        the rollback path (champion checkpoint re-asserted, rollback
        counter) — a shadow-only candidate never changed serving, so it
        is stamped SUPERSEDED without touching the champion or the
        canary-rollback alerting metric."""
        with self._mu:
            if self._candidate is None:
                return
            snap = self.evaluator.snapshot()
            if self._stage == STAGE_CANARY:
                self._rollback(snap, ["shutdown with candidate mid-canary"])
                return
            v = self._candidate
            self._clear_candidate_serving()
            self.store.set_stage(
                v, "SUPERSEDED",
                reason="shutdown with candidate in shadow",
                metrics=snap.to_dict())

    def serving_consistent(self) -> bool:
        """True when serving state matches the state machine: challenger
        slot and canary gate exist exactly when a candidate is in flight,
        and the lineage has exactly one champion."""
        with self._mu:
            champ = self.store.champion()
            if champ is None or champ.version != self.champion:
                return False
            has_challenger = self.scorer.challenger_version is not None
            if self._candidate is None:
                return not has_challenger and not self.gate.active
            if self._stage == STAGE_SHADOW:
                return has_challenger and not self.gate.active
            return has_challenger and self.gate.active

    # -- supervisor-shaped daemon surface ----------------------------------
    def reset(self) -> None:
        self._stop.clear()

    def run(self, interval_s: float = 0.25) -> None:
        while not self._stop.is_set():
            if not self.step():
                self._stop.wait(interval_s)

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.stop()
        self.evaluator.close()
