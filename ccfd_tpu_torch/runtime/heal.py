"""Device self-healing: failure taxonomy, heal ladder, warm re-promotion.

The port of ccfd_tpu/runtime/heal.py on ``torch.cuda``. Every resilience
layer below treats the card as infrastructure that either works or is
someone else's problem: the breakers harden the RPC edges around it, the
dispatch watchdog bounds single dispatches into it, the telemetry plane
measures it. :class:`DeviceSupervisor` OWNS it as a fallible component —
detects that it wedged, ran out of memory or fell into a rebuild storm,
takes it out of rotation, heals it and returns traffic safely — with a
health state machine per device::

    HEALTHY ──strike──▶ SUSPECT ──strikes──▶ QUARANTINED
       ▲                   │ (signals clear)        │ heal ladder:
       │                   ▼                        │  1. canary retry
       └──────────────  HEALTHY                     │  2. reinit
       ▲                                            │  3. scorer respawn
       │      N canaries + score parity             ▼ (jittered backoff)
       └───────────────  PROBATION  ◀───── canary passes

driven by three signal families, all drillable on the CPU through the
device-fault plan (``runtime/faults.py``):

- **canary dispatch** — ``scorer.score_pipelined(probe, depth=1)`` at the
  smallest bucket through the real serving path (on a CUDA scorer it
  launches the served kernel, B1, B2 or B3; never a plain version), under
  ``compile_stage("heal.canary")``, bounded by
  ``OverloadControl.bounded_dispatch`` or an own ``DeviceDispatcher``: a
  hung canary is abandoned and counted, never stalls the supervisor, and a
  canary that cannot launch is a failed canary;
- **device telemetry** — allocator ``bytes_in_use`` against
  ``bytes_limit`` for memory pressure, builds billed to serving labels per
  second for a rebuild storm (``compile_counts()``, the port's nvcc/g++
  builds where the reference counts XLA compiles), H2D staging-copy
  failures;
- **scorer-edge breaker** — an OPEN breaker means live traffic already
  found the card sick.

On QUARANTINE the supervisor is the router's ``heal_gate``: the ladder's
check sits ABOVE the breaker, so not even a half-open probe leaks traffic
to the sick card, and the counted host tier serves (rules-only stays the
last resort below it). It walks the heal ladder with jittered exponential
backoff:

- ``canary_retry``: the canary alone;
- ``reinit``: the counterpart of the reference's ``jax.clear_caches()``:
  ``torch.cuda.synchronize`` (a pending asynchronous error surfaces here
  as a raised, failed rung), ``torch.cuda.empty_cache()`` and the
  scorer's ``drop_device_state()``. It builds nothing: builds happen only
  under the ``heal.warm`` or ``scorer.warmup`` labels;
- ``respawn``: ``swap_params`` of the scorer's own params into fresh
  device buffers.

Re-promotion is **warm**: ``scorer.warmup()`` under ``heal.warm`` launches
every bucket, then N consecutive canaries plus a host-vs-device parity
check (``Scorer.host_score`` within ``parity_tol``) must pass, with
hysteresis so a flapping card backs off harder each round. Every
transition exports ``ccfd_device_health{device,state}``.

A **sticky CUDA error** (``cudaErrorIllegalAddress`` and its kind) poisons
the process's context and cannot be cleared inside the process: every rung
then keeps failing, the card stays quarantined and the counted host tier
serves until the process restarts. The supervisor does not pretend to heal
it. With the incident plane on, the operator passes the flight recorder
(``recorder=``, observability/incident.py): each quarantine and each
re-promotion dumps a bundle, as the reference's.
The state machine, signals, rungs and backoff draws are the reference's,
tick for tick under the same seed and clock.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Callable

import numpy as np

from ccfd_tpu_torch.runtime.breaker import backoff_s

log = logging.getLogger(__name__)

# state machine values, "bigger is sicker" except PROBATION (recovering)
HEALTHY, SUSPECT, QUARANTINED, PROBATION = 0, 1, 2, 3
STATE_NAMES = {HEALTHY: "healthy", SUSPECT: "suspect",
               QUARANTINED: "quarantined", PROBATION: "probation"}

# heal-ladder rungs, walked in order (the last repeats until it works)
RUNGS = ("canary_retry", "reinit", "respawn")

# build-stage labels that legitimately build OUTSIDE the serving hot path:
# warmups and the heal ladder's own steps (the reference's set; the row
# scorer's warmup bills ``scorer.warmup``, as the reference's does).
# Everything else counting a build while serving is a storm signal, and
# after a re-promotion flip it would mean the re-promotion was cold.
NON_SERVING_COMPILE_STAGES = frozenset({
    "total", "heal.warm", "heal.canary", "scorer.warmup",
    "seq.warmup", "seq.swap", "fused.warm",
})


def mesh_domain_label(mesh: Any) -> str:
    """``mesh:<platform>x<n>`` (platform ``cuda`` or ``cpu``): the health
    domain of a mesh-sharded scorer.

    **The mesh is ONE health domain.** Every sharded dispatch spans every
    shard of the mesh, so there is no per-shard traffic to steer away from
    a sick one: a canary failure on any shard fails the whole dispatch. The
    supervisor therefore quarantines the MESH TIER (the router's ladder
    serves from the host tier for the whole heal cycle) and re-promotes the
    mesh as a unit after the warm gate."""
    try:
        return f"mesh:{mesh.platform}x{int(mesh.size)}"
    except Exception:  # noqa: BLE001 - a label, never a failure
        return "mesh:unknown"


def default_device_label(device: Any = None) -> str:
    """``cuda:<index>`` of the scorer's card (the gauge label), ``cpu:0``
    for a scorer on the CPU; with no device, the current CUDA device, or
    ``cpu:0`` without CUDA."""
    import torch

    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            idx = dev.index if dev.index is not None else torch.cuda.current_device()
            return f"cuda:{idx}"
        return f"{dev.type}:{dev.index or 0}"
    try:
        if torch.cuda.is_available():
            return f"cuda:{torch.cuda.current_device()}"
    except Exception:  # noqa: BLE001 - no backend is itself a device state
        pass
    return "cpu:0"


class DeviceSupervisor:
    """Per-device health state machine + heal ladder; see the module
    docstring. Runs as a supervised service (``run``/``stop``/``reset``)
    under the operator's ``heal:`` component; ``tick()`` is the test and
    drill surface.

    The supervisor IS the router's ``heal_gate``: ``device_allowed()``
    answers False from the moment of quarantine until the warm
    re-promotion flip, which pins the degradation ladder to its host tier
    (rules-only as the last resort) for the whole heal cycle.
    """

    def __init__(
        self,
        scorer: Any,
        registry: Any = None,
        breaker: Any = None,
        telemetry: Any = None,
        profiler: Any = None,
        recorder: Any = None,
        overload: Any = None,
        device: str | None = None,
        canary_rows: int = 16,
        canary_deadline_ms: float = 250.0,
        suspect_strikes: int = 2,
        probation_canaries: int = 3,
        parity_tol: float = 0.05,
        oom_ratio: float = 0.92,
        compile_storm_per_s: float = 2.0,
        backoff_base_s: float = 0.5,
        backoff_cap_s: float = 30.0,
        flap_window_s: float = 60.0,
        reinit_fn: Callable[[], None] | None = None,
        respawn_fn: Callable[[], None] | None = None,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.scorer = scorer
        self.breaker = breaker
        self.telemetry = telemetry
        self.profiler = profiler
        self.recorder = recorder
        self.overload = overload
        # a mesh-sharded scorer is ONE health domain (mesh_domain_label):
        # quarantine, heal and re-promotion act on the mesh tier, never on
        # one shard
        scorer_mesh = getattr(scorer, "mesh", None)
        self.domain = "mesh" if scorer_mesh is not None else "device"
        if device is None:
            device = (mesh_domain_label(scorer_mesh) if scorer_mesh is not None
                      else default_device_label(getattr(scorer, "device", None)))
        self.device = device
        self.canary_deadline_s = max(1e-3, float(canary_deadline_ms) / 1e3)
        self.suspect_strikes = max(1, int(suspect_strikes))
        self.probation_canaries = max(1, int(probation_canaries))
        self.parity_tol = float(parity_tol)
        self.oom_ratio = float(oom_ratio)
        self.compile_storm_per_s = float(compile_storm_per_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.flap_window_s = float(flap_window_s)
        self._reinit_fn = reinit_fn
        self._respawn_fn = respawn_fn
        self._rng = random.Random(seed)
        self._clock = clock
        self._mu = threading.Lock()
        self._stop = threading.Event()

        # canary probe: real (seeded) rows, NOT zeros: the parity check
        # compares device and host probabilities, and an all-zeros batch
        # collapses to one output value that cannot catch a scrambled graph
        nf = int(getattr(scorer, "num_features", 30))
        rng = np.random.default_rng(seed)
        self._probe_x = rng.standard_normal(
            (max(1, int(canary_rows)), nf)).astype(np.float32)

        self._state = HEALTHY
        self._strikes = 0
        self._last_reasons: list[str] = []
        self._rung_idx = 0
        self._heal_attempt = 0       # backoff exponent within a quarantine
        self._next_heal_at = 0.0
        self._probation_passes = 0
        self._flap_streak = 0        # re-quarantines inside flap_window_s
        self._last_promote_at: float | None = None
        self._prev_compile: dict[str, int] = {}
        self._prev_compile_at: float | None = None
        # baseline the diffed signals from their LIVE values: the
        # supervisor comes up after serving (operator step 7e), and history
        # that predates it must not read as first-tick strikes
        self._prev_put_failures = (telemetry.h2d_failures()
                                   if telemetry is not None else 0)
        self._prev_breaker_opens = (breaker.opens
                                    if breaker is not None else 0)
        # lifetime counters for drills and tests
        self.quarantines = 0
        self.repromotions = 0
        self.canary_failures = 0

        self._g_health = self._c_transitions = None
        self._c_attempts = self._c_canary = None
        if registry is not None:
            self._g_health = registry.gauge(
                "ccfd_device_health",
                "device health state one-hot: 1 on the current state's "
                "series, 0 elsewhere (healthy/suspect/quarantined/"
                "probation per device)",
            )
            self._c_transitions = registry.counter(
                "ccfd_heal_transitions_total",
                "device health state transitions by target state",
            )
            self._c_attempts = registry.counter(
                "ccfd_heal_attempts_total",
                "heal-ladder attempts by rung (canary_retry -> reinit -> "
                "respawn, jittered backoff between attempts)",
            )
            self._c_canary = registry.counter(
                "ccfd_heal_canary_total",
                "canary dispatch outcomes (pass / fail)",
            )
            self._export_state()

        self._own_dispatcher = None
        if overload is None:
            from ccfd_tpu_torch.serving.dispatch import DeviceDispatcher

            self._own_dispatcher = DeviceDispatcher(
                max_threads=2, name="ccfd-heal-canary")

    # -- state surface ------------------------------------------------------
    @property
    def state(self) -> str:
        return STATE_NAMES[self._state]

    def device_allowed(self) -> bool:
        """The router ladder's gate: may live traffic touch the card?
        False from quarantine entry until the warm re-promotion flip;
        PROBATION still answers False (canaries + parity must pass before
        serving returns; that asymmetry is the hysteresis)."""
        return self._state in (HEALTHY, SUSPECT)

    def _export_state(self) -> None:
        if self._g_health is None:
            return
        for s, name in STATE_NAMES.items():
            self._g_health.set(
                1.0 if s == self._state else 0.0,
                labels={"device": self.device, "state": name})

    def _set_state(self, state: int) -> None:
        if state == self._state:
            return
        log.info("device %s: %s -> %s", self.device,
                 STATE_NAMES[self._state], STATE_NAMES[state])
        self._state = state
        self._export_state()
        if self._c_transitions is not None:
            self._c_transitions.inc(labels={"to": STATE_NAMES[state]})

    # -- canary -------------------------------------------------------------
    def _device_dispatch(self) -> np.ndarray:
        """One small dispatch through the real serving path at the smallest
        warmed bucket, so the canary measures the card, not a build. Any
        build it DOES pay bills to ``heal.canary``: the label is set here,
        on whichever sacrificial thread runs the dispatch, because the
        build-stage contextvar does not cross the watchdog's thread
        boundary."""
        from ccfd_tpu_torch.observability.profile import compile_stage

        scorer = self.scorer
        with compile_stage("heal.canary"):
            pipelined = getattr(scorer, "score_pipelined", None)
            if callable(pipelined):
                # the row Scorer: score_pipelined is the pure device path
                return np.asarray(pipelined(self._probe_x, depth=1))
            return np.asarray(scorer.score(self._probe_x))

    def _run_canary(self, parity: bool = False) -> tuple[bool, str]:
        """(passed, reason). Bounded by the dispatch watchdog; with
        ``parity`` the device output must also agree with the host forward
        within ``parity_tol`` (the re-promotion gate's proof that the
        healed card computes the same model, not just answers)."""
        try:
            if self.overload is not None:
                out = self.overload.bounded_dispatch(
                    self._device_dispatch, deadline_s=self.canary_deadline_s)
            else:
                out = self._own_dispatcher.call(
                    self._device_dispatch, self.canary_deadline_s)
        except Exception as e:  # noqa: BLE001 - every failure mode counts
            self.canary_failures += 1
            if self._c_canary is not None:
                self._c_canary.inc(labels={"outcome": "fail"})
            return False, f"canary: {type(e).__name__}: {e}"
        out = np.asarray(out)
        if out.shape != (len(self._probe_x),) or not np.isfinite(out).all():
            self.canary_failures += 1
            if self._c_canary is not None:
                self._c_canary.inc(labels={"outcome": "fail"})
            return False, "canary: invalid response shape/values"
        if parity and getattr(self.scorer, "has_host_forward", False):
            host = np.asarray(self.scorer.host_score(self._probe_x))
            delta = float(np.max(np.abs(out - host)))
            if delta > self.parity_tol:
                self.canary_failures += 1
                if self._c_canary is not None:
                    self._c_canary.inc(labels={"outcome": "fail"})
                return False, f"parity: max |device-host| {delta:.4f}"
        if self._c_canary is not None:
            self._c_canary.inc(labels={"outcome": "pass"})
        return True, ""

    # -- telemetry signals --------------------------------------------------
    def _collect_signals(self) -> list[str]:
        """Quarantine evidence from the telemetry, profiler and breaker
        planes; each entry is one strike-worthy reason."""
        reasons: list[str] = []
        tele = self.telemetry
        if tele is not None:
            try:
                for dev, kinds in tele.device_memory().items():
                    used, limit = kinds.get("bytes_in_use"), kinds.get(
                        "bytes_limit")
                    if used and limit and used / limit >= self.oom_ratio:
                        reasons.append(
                            f"device_oom: {dev} {used}/{limit} "
                            f">= {self.oom_ratio:.2f}")
                        break
            except Exception:  # noqa: BLE001 - telemetry must not crash heal
                pass
            failures = tele.h2d_failures()
            if failures > self._prev_put_failures:
                reasons.append(
                    f"put_fail: {failures - self._prev_put_failures} "
                    "staging failures since last tick")
            self._prev_put_failures = failures
        prof = self.profiler
        if prof is not None:
            now = self._clock()
            counts = prof.compile_counts()
            if self._prev_compile_at is not None:
                dt = max(1e-6, now - self._prev_compile_at)
                serving = sum(
                    counts.get(s, 0) - self._prev_compile.get(s, 0)
                    for s in counts
                    if s not in NON_SERVING_COMPILE_STAGES)
                if serving / dt >= self.compile_storm_per_s:
                    reasons.append(
                        f"compile_storm: {serving} serving-stage compiles "
                        f"in {dt:.1f}s")
            self._prev_compile = counts
            self._prev_compile_at = now
        br = self.breaker
        if br is not None:
            opens = br.opens
            if br.state == "open" or opens > self._prev_breaker_opens:
                reasons.append("breaker: scorer edge open/tripped")
            self._prev_breaker_opens = opens
        return reasons

    # -- transitions --------------------------------------------------------
    def _quarantine(self, reasons: list[str]) -> None:
        self.quarantines += 1
        self._last_reasons = reasons[:8]
        now = self._clock()
        if self._state in (QUARANTINED, PROBATION):
            # re-quarantined MID-heal (the warm step or a probation canary
            # failed): a failed ladder attempt, so escalate the rung and
            # deepen the backoff; resetting here would loop a
            # canary-pass/warm-fail card at rung 0 forever, never reaching
            # the reinit/respawn rungs that could fix it (no promotion
            # happened, so the flap streak stays put)
            self._rung_idx += 1
            self._heal_attempt += 1
        else:
            # flap hysteresis: a card re-quarantined shortly after a
            # re-promotion earns a harder backoff each round, so a flapping
            # card cannot thrash serving at the ladder's base rate
            if (self._last_promote_at is not None
                    and now - self._last_promote_at <= self.flap_window_s):
                self._flap_streak += 1
            else:
                self._flap_streak = 0
            self._rung_idx = 0
            self._heal_attempt = self._flap_streak
        self._next_heal_at = now + backoff_s(
            self._heal_attempt, self.backoff_base_s, self.backoff_cap_s,
            self._rng)
        self._set_state(QUARANTINED)
        log.warning("device %s QUARANTINED: %s", self.device, reasons)
        if self.recorder is not None:
            try:
                self.recorder.incident({
                    "type": "device_quarantine",
                    "device": self.device,
                    "signals": self._last_reasons,
                })
            except Exception:  # noqa: BLE001 - evidence, not control flow
                pass

    def _heal_step(self) -> None:
        """One heal-ladder attempt, backoff-gated. Escalates one rung per
        failure; the last rung (respawn) repeats until it works."""
        now = self._clock()
        if now < self._next_heal_at:
            return
        rung = RUNGS[min(self._rung_idx, len(RUNGS) - 1)]
        if self._c_attempts is not None:
            self._c_attempts.inc(labels={"rung": rung})
        try:
            if rung == "reinit":
                self._reinit()
            elif rung == "respawn":
                self._respawn()
        except Exception as e:  # noqa: BLE001 - a failed rung is a failed
            log.warning("heal rung %s raised: %r", rung, e)  # attempt
            self._escalate(now)
            return
        ok, reason = self._run_canary()
        if ok:
            self._enter_probation()
            return
        log.info("heal rung %s: canary still failing (%s)", rung, reason)
        self._escalate(now)

    def _escalate(self, now: float) -> None:
        self._rung_idx += 1
        self._heal_attempt += 1
        self._next_heal_at = now + backoff_s(
            self._heal_attempt, self.backoff_base_s, self.backoff_cap_s,
            self._rng)

    def _reinit(self) -> None:
        """Rung 2: the counterpart of the reference's ``jax.clear_caches()``.
        On a CUDA scorer, ``torch.cuda.synchronize`` turns a pending
        asynchronous error into a raised (failed) rung and
        ``torch.cuda.empty_cache()`` returns the allocator's cached blocks;
        then the scorer drops the per-bucket state it keeps about the card
        (``drop_device_state``). Nothing is rebuilt here: the warm step
        launches every bucket before serving returns."""
        if self._reinit_fn is not None:
            self._reinit_fn()
            return
        import torch

        dev = getattr(self.scorer, "device", None)
        if dev is not None and torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        drop = getattr(self.scorer, "drop_device_state", None)
        if callable(drop):
            drop()

    def _respawn(self) -> None:
        """Rung 3: re-publish the scorer's own params through
        ``swap_params``: fresh device buffers for every leaf (a device-side
        state scrub; the lifecycle's champion restore, ROADMAP A12, is the
        operator's ``respawn_fn`` once ported)."""
        if self._respawn_fn is not None:
            self._respawn_fn()
            return
        from ccfd_tpu_torch.params import to_numpy

        self.scorer.swap_params(to_numpy(self.scorer.params))

    def _enter_probation(self) -> None:
        self._probation_passes = 0
        self._set_state(PROBATION)
        self._warm()

    def _warm(self) -> None:
        """Launch every bucket (``warmup``: the row bucket ladder, the seq
        (L, B) grid) under the ``heal.warm`` build-stage label. This is what
        makes the re-promotion WARM: any build bills here, and the drills
        assert zero serving-label builds after the flip."""
        from ccfd_tpu_torch.observability.profile import compile_stage

        try:
            with compile_stage("heal.warm"):
                self.scorer.warmup()
        except Exception as e:  # noqa: BLE001 - a failed warm is a failed
            log.warning("heal warm step failed: %r", e)  # probation
            self._quarantine([f"warm: {type(e).__name__}: {e}"])

    def _probation_step(self) -> None:
        ok, reason = self._run_canary(parity=True)
        if not ok:
            log.warning("probation canary failed (%s); re-quarantining",
                        reason)
            self._quarantine([f"probation: {reason}"])
            return
        self._probation_passes += 1
        if self._probation_passes < self.probation_canaries:
            return
        # the warm re-promotion flip: serving returns to the card
        self._last_promote_at = self._clock()
        self.repromotions += 1
        # re-baseline every diffed signal at the flip: the quarantine era
        # legitimately produced builds, put failures and breaker trips, and
        # diffing the first healthy tick against the PRE-quarantine
        # baseline would read that history as fresh evidence
        if self.profiler is not None:
            self._prev_compile = self.profiler.compile_counts()
            self._prev_compile_at = self._clock()
        if self.telemetry is not None:
            self._prev_put_failures = self.telemetry.h2d_failures()
        if self.breaker is not None:
            self._prev_breaker_opens = self.breaker.opens
        if self.breaker is not None:
            # the breaker's window is full of quarantine-era failures, and
            # from OPEN record_success() changes nothing: a residual
            # cooldown would keep refusing the healed card AND read as
            # fresh quarantine evidence next tick. The probation gate (N
            # canaries + parity) outranks a half-open probe, so close the
            # scorer edge outright.
            try:
                close = getattr(self.breaker, "force_close", None)
                if callable(close):
                    close()
                else:
                    self.breaker.record_success()
            except Exception:  # noqa: BLE001
                pass
        self._strikes = 0
        self._set_state(HEALTHY)
        log.info("device %s re-promoted (warm) after %d canaries",
                 self.device, self._probation_passes)
        if self.recorder is not None:
            try:
                self.recorder.incident({
                    "type": "device_repromote",
                    "device": self.device,
                    "canaries": self._probation_passes,
                })
            except Exception:  # noqa: BLE001
                pass

    # -- the supervised tick ------------------------------------------------
    def tick(self) -> str:
        """One supervision cycle; returns the (possibly new) state name."""
        with self._mu:
            state = self._state
            if state in (HEALTHY, SUSPECT):
                reasons = self._collect_signals()
                ok, reason = self._run_canary()
                if not ok:
                    reasons.append(reason)
                if reasons:
                    self._strikes += 1
                    self._last_reasons = reasons[:8]
                    if self._strikes >= self.suspect_strikes:
                        self._quarantine(reasons)
                    else:
                        self._set_state(SUSPECT)
                else:
                    self._strikes = 0
                    if state == SUSPECT:
                        self._set_state(HEALTHY)
            elif state == QUARANTINED:
                self._heal_step()
            elif state == PROBATION:
                self._probation_step()
            return STATE_NAMES[self._state]

    def status(self) -> dict[str, Any]:
        with self._mu:
            return {
                "device": self.device,
                "domain": self.domain,
                "state": STATE_NAMES[self._state],
                "strikes": self._strikes,
                "reasons": list(self._last_reasons),
                "rung": RUNGS[min(self._rung_idx, len(RUNGS) - 1)],
                "quarantines": self.quarantines,
                "repromotions": self.repromotions,
                "canary_failures": self.canary_failures,
                "flap_streak": self._flap_streak,
            }

    # -- supervised-service surface ----------------------------------------
    def reset(self) -> None:
        self._stop.clear()

    def stop(self) -> None:
        self._stop.set()

    def run(self, interval_s: float = 5.0) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - one bad tick must not kill
                log.exception("heal tick failed")  # the supervision loop
