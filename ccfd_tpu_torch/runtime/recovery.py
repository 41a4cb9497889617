"""Crash recovery for the stateful pipeline tier: engine snapshot +
bus-offset replay as one consistent cut.

The port's copy of ccfd_tpu/runtime/recovery.py, over the port's router
(``pause``/``resume``/``swap_engine``/``recycle_consumers``) and
``runtime/durability.py``'s checksummed JSON artifacts.

The reference's process engine (KIE server, reference deploy/
ccd-service.yaml:1-124) keeps persistent process state in a database and
relies on Kafka redelivery after a pod restart.  This module is that
capability for the in-process runtime: a ``CheckpointCoordinator``
periodically captures

  - the engine's snapshot (process/engine.py snapshot(): active instances,
    open tasks, id counters, timer remainders), and
  - the committed offsets of every consumer group whose records mutate
    engine state (the router's transaction group and its customer-response
    signal group),

taken *at a batch boundary* — the router's pause() barrier guarantees no
consumed-but-unrouted records exist when the cut is read (a Flink-style
aligned checkpoint with one source).  After an engine crash, ``restore()``
builds a fresh engine from the registered definitions, loads the last
snapshot, rewinds the groups to the cut (Broker.reset_offsets — live
consumers follow, they hold no position of their own), and swaps the new
engine into the router.

Semantics are at-least-once, like Kafka redelivery into a restarted KIE
pod before its DB transaction committed: work the dead engine did after
the last cut is rolled back and re-driven from the bus.  Process ids
restart from the snapshot's ``next_pid``, so starts the dead engine
emitted after the cut are void — the coordinator writes an
``engine_restored`` marker event (with that ``next_pid``) into the audit
topic, which is exactly the information an audit consumer needs to
reconcile: any ``process_started`` before the marker with
``pid >= next_pid`` was rolled back and will be re-driven (possibly
reusing the pid).  The smoke's platform phase injects an engine failure
mid-stream and checks that every transaction starts exactly once.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable

from ccfd_tpu_torch.process.engine import Engine


def _np_jsonable(obj: Any) -> Any:
    """json.dumps default for cut contents: numpy arrays/scalars (extra-
    state snapshots return them raw to keep the barrier short)."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")


class CheckpointCoordinator:
    """Aligned checkpoints + crash restore for one router/engine pair.

    ``engine_factory`` must return a fresh, fully ``register``-ed engine
    wired to the same audit sink (definitions are code, not data —
    process/engine.py restore()).
    """

    def __init__(
        self,
        router,                    # router.Router (pause/resume/swap_engine)
        broker,                    # bus.broker.Broker
        engine_factory: Callable[[], Engine],
        interval_s: float = 5.0,
        pause_timeout_s: float = 10.0,
        on_swap: Callable[[Engine], None] | None = None,
        path: str | None = None,
        retain: int | None = None,
    ):
        self.router = router
        self.broker = broker
        self.engine_factory = engine_factory
        self.interval_s = interval_s
        self.pause_timeout_s = pause_timeout_s
        # other holders of an engine reference (the KIE-shaped REST
        # server, the platform object) re-point here, inside the barrier
        self.on_swap = on_swap
        cfg = router.cfg
        # every (group, topic) whose consumption mutates engine state
        self._cut_groups = (
            ("router", cfg.kafka_topic),
            ("router-responses", cfg.customer_response_topic),
        )
        self._audit_topic = cfg.audit_topic
        # cut durability: with ``path`` set, every validated cut lands on
        # disk (tmp+rename), so a FULL-process crash recovers via
        # restore_from_disk() at the next bring-up — paired with a
        # durable bus (log_dir), that is the complete crash story:
        # engine state from the cut, the gap re-driven from the log
        self.path = path
        # generations of the cut retained on disk (runtime/durability.py):
        # a torn/bit-flipped newest cut falls back to the previous one —
        # a crash a few seconds earlier — instead of a cold start
        self.retain = retain
        if path:
            import os

            from ccfd_tpu_torch.runtime.durability import sweep_tmp

            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            sweep_tmp(os.path.dirname(os.path.abspath(path)))
        self._io_lock = threading.Lock()  # orders cut writes off _lock
        # additional PIPELINE STATE that must ride the cut: anything a
        # rewound record replay would otherwise double-apply — e.g. the
        # seq scorer's per-customer histories (the reference's
        # serving/history.py; the seq family is not ported yet).
        # name -> (snapshot_fn() -> JSONable, restore_fn(snap) -> None)
        self._extra_state: dict[str, tuple[Callable[[], Any],
                                           Callable[[Any], None]]] = {}
        self._last: dict[str, Any] | None = None  # {"snap","offsets","ts"}
        self._lock = threading.Lock()  # serializes checkpoint vs restore
        # Seed the retention pin NOW, at the groups' current committed
        # positions (<= any future cut): the FIRST checkpoint has no prior
        # pin, so in the window between its barrier release and its own
        # pin write (snapshot JSON-normalization + disk persistence) the
        # consuming groups race ahead and retention could trim
        # [first cut, live position) — exactly the records that cut's
        # restore would replay (ADVICE r5 medium). On a crash bring-up
        # the groups' replayed positions sit PAST the persisted cut the
        # upcoming restore_from_disk() will rewind to, so the seed folds
        # in the on-disk cut's offsets (element-wise min) — overwriting
        # the surviving durable pin with crash-time positions would
        # un-protect exactly the replay window the pin existed to keep.
        # Best-effort: transports that cannot report offsets at bring-up
        # just skip the seed.
        try:
            seed = {
                f"{g}\x00{t}": [int(o)
                                for o in broker.committed_offsets(g, t)]
                for g, t in self._cut_groups
            }
            for key, offs in self._peek_disk_cut_offsets().items():
                cur = seed.get(key)
                seed[key] = (list(offs) if cur is None
                             else [min(a, b) for a, b in zip(cur, offs)])
            self._pin_retention(seed)
        except Exception:  # noqa: BLE001 - seeding is protective only
            import logging

            logging.getLogger(__name__).exception(
                "retention pin seed at coordinator start failed")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.checkpoints = 0
        self.restores = 0
        self.skipped = 0
        self.last_restore_s = 0.0  # wall time of the last restore (the port's)
        self.unacked_restores = 0  # barrier timeout (e.g. wedged scorer):
        # restore proceeded anyway — safe, because the shut-down engine
        # refuses the late in-flight batch (Engine._check_alive) and
        # generation-guarded state (HistoryStore) drops late commits

    def register_state(self, name: str, snapshot_fn: Callable[[], Any],
                       restore_fn: Callable[[Any], None]) -> None:
        """Attach extra pipeline state to every cut. ``snapshot_fn`` runs
        under the barrier — keep it COPY-ONLY (return numpy arrays as-is;
        the coordinator converts to JSON outside the barrier); a
        ``restore_fn`` runs during restore after the engine swap, with
        ``None`` meaning reset-to-empty. State registered after
        checkpoints were already taken starts riding the NEXT cut."""
        self._extra_state[name] = (snapshot_fn, restore_fn)

    # -- checkpoint --------------------------------------------------------
    def checkpoint(self) -> dict[str, Any] | None:
        """One aligned checkpoint; None if the barrier wasn't acked (router
        mid-restart — state is then mutating unpredictably, skip rather
        than record a torn cut)."""
        import json

        with self._lock:
            acked = self.router.pause(self.pause_timeout_s)
            try:
                if not acked and self._router_loop_alive():
                    self.skipped += 1
                    return None
                # barrier holds (or no loop is running to mutate state).
                # validate=False: the JSON round-trip is ~70% of a large
                # snapshot and belongs OUTSIDE the barrier — the copy is
                # already detached, the pipeline should be flowing again
                cut = {
                    "snap": self.router.engine.snapshot(validate=False),
                    "offsets": {
                        f"{g}\x00{t}": self.broker.committed_offsets(g, t)
                        for g, t in self._cut_groups
                    },
                    "extra": {
                        name: snap_fn()
                        for name, (snap_fn, _) in self._extra_state.items()
                    },
                    "ts": time.time(),
                }
            finally:
                self.router.resume()
            # whole-cut JSON normalization OUTSIDE the barrier (snapshot
            # fns return raw numpy for speed under the pause; the
            # conversion cost lands here, where the pipeline is flowing)
            cut = json.loads(json.dumps(cut, default=_np_jsonable))
            self._last = cut
            self.checkpoints += 1
        # disk persistence OFF the coordinator lock: a crash restore must
        # not wait behind a large snapshot's serialize+write. _io_lock
        # alone orders writers; a slightly stale cut on disk is exactly
        # as recoverable as a crash a moment earlier.
        wrote = True
        if self.path:
            from ccfd_tpu_torch.runtime.durability import write_json_artifact

            with self._io_lock:
                # checksummed + fsynced + atomic with generation retention
                # (a failed write keeps the previous cut — exactly as
                # recoverable as a crash one interval earlier)
                wrote = write_json_artifact(self.path, {"version": 1, **cut},
                                            artifact="recovery_cut",
                                            retain=self.retain)
        # Pin retention only AFTER the cut is durable: until the atomic
        # replace lands, the newest cut a cold start can load is the
        # PREVIOUS one, and the previous pin is what keeps that cut's
        # replay records alive. Pinning first would let retention trim
        # [old cut, new cut) while disk still holds the old cut — a crash
        # in that window would restore a cut whose records are gone. The
        # same invariant on a FAILED durable write (full disk, injected
        # storage fault — write_json_artifact is best-effort): the newest
        # cut on disk is still the previous one, so the previous pin must
        # stand; advancing it would un-protect exactly the replay window
        # that cut needs.
        if wrote:
            self._pin_retention(cut["offsets"])
        return cut

    def _peek_disk_cut_offsets(self) -> dict[str, list[int]]:
        """The persisted cut's offsets map, for the constructor's pin
        seed — {} when there is no (usable) cut on disk. Deliberately
        tolerant: a corrupt file reads as no-cut here exactly as it does
        in restore_from_disk()."""
        from ccfd_tpu_torch.runtime.durability import read_json_artifact

        if not self.path:
            return {}
        try:
            # quarantine=False: the peek must not mutate disk state the
            # upcoming restore_from_disk() will judge for itself
            cut = read_json_artifact(self.path, artifact="recovery_cut",
                                     fallback=True, quarantine=False)
            offsets = cut["offsets"] if cut.get("version") == 1 else {}
            return {
                k: [int(o) for o in v]
                for k, v in offsets.items()
                if isinstance(v, list)
            }
        except Exception:  # noqa: BLE001 - a corrupt/missing file reads
            # as no-cut here exactly as it does in restore_from_disk()
            return {}

    def _pin_retention(self, cut_offsets: dict[str, list[int]]) -> None:
        """Publish the cut as a committed position under the broker's
        retention pin group: the broker's delete-before-committed-offset
        retention (bus/broker.py) then cannot delete any record a restore
        of THIS cut would replay. Per topic the pin is the element-wise
        min across the cut's groups — the earliest position any rewind
        could aim at. An in-process Broker without retention just records
        a harmless extra group. The pin IS sent over every transport with
        an offset-admin surface — RemoteBroker forwards it to the bus
        server, whose broker-side retention honors it exactly like the
        in-process case, and KafkaAdapter commits it as ordinary group
        offsets — but on REAL Kafka, size/time retention ignores consumer
        positions entirely, so the pin does NOT block broker-side
        deletion there: it only documents the cut for operators
        (``kafka-consumer-groups --describe``), and recovery over a real
        cluster relies on the cluster's retention window being wider than
        the checkpoint interval. Only a transport with no
        ``reset_offsets`` at all is skipped."""
        from ccfd_tpu_torch.bus.broker import RETENTION_PIN_GROUP

        if not callable(getattr(self.broker, "reset_offsets", None)):
            return
        pin: dict[str, list[int]] = {}
        for key, offs in cut_offsets.items():
            _, t = key.split("\x00", 1)
            cur = pin.get(t)
            pin[t] = (list(offs) if cur is None
                      else [min(a, b) for a, b in zip(cur, offs)])
        for t, offs in pin.items():
            try:
                self.broker.reset_offsets(RETENTION_PIN_GROUP, t, offs)
            except Exception:  # noqa: BLE001 - pinning is protective only;
                # a transport that rejects it must not fail the checkpoint
                import logging

                logging.getLogger(__name__).exception(
                    "retention pin failed for %r", t)

    def _router_loop_alive(self) -> bool:
        """Best effort: is some thread inside the router's run loop?  The
        stop flag is the only observable; a cleared stop flag with no ack
        means a live loop that didn't reach the barrier."""
        return not self.router._stop.is_set()

    def start(self) -> "CheckpointCoordinator":
        """Periodic checkpoints on a daemon thread."""
        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.checkpoint()
                except Exception:  # noqa: BLE001 - keep checkpointing
                    import logging

                    logging.getLogger(__name__).exception("checkpoint failed")
        self._thread = threading.Thread(
            target=loop, daemon=True, name="ccfd-checkpoint"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- restore -----------------------------------------------------------
    def restore(self, reason: str = "crash", boot: bool = False) -> Engine:
        """Rebuild the engine from the last cut and rewind the bus to it.

        Safe to call from the supervisor's reset hook while the router is
        still polling: the router is paused across the swap (its in-flight
        batch drains into the doomed engine first — those starts are void,
        their records re-deliver after the rewind).  With no checkpoint
        yet, recovery is from genesis: empty engine, offsets 0 — the full
        at-least-once replay of the durable log.

        ``boot=True`` (restore_from_disk at bring-up, before any service
        thread exists): there is no loop to ack the barrier — waiting the
        pause timeout would just stall bring-up — and recycling the
        consumers is unconditionally safe."""
        t_restore = time.perf_counter()
        with self._lock:
            acked = self.router.pause(0.0 if boot else self.pause_timeout_s)
            if not acked and not boot and self._router_loop_alive():
                # only a LIVE loop missing the barrier is notable; a
                # stopped router has nothing to ack
                self.unacked_restores += 1
            try:
                # silence the doomed engine FIRST: its scheduled timers
                # must not fire into dead state or emit post-marker audit
                # events through the shared sink (Engine.shutdown)
                old = self.router.engine
                if hasattr(old, "shutdown"):
                    old.shutdown()
                if self._last is not None:
                    offsets = self._last["offsets"]
                    next_pid = self._last["snap"]["next_pid"]
                    active_pids = [
                        i["pid"] for i in self._last["snap"]["instances"]
                        if i["status"] == "active"
                    ]
                else:
                    offsets = {
                        f"{g}\x00{t}": [0] * len(
                            self.broker.committed_offsets(g, t)
                        )
                        for g, t in self._cut_groups
                    }
                    next_pid = 1
                    active_pids = []
                if self._audit_topic:
                    # The marker goes in BEFORE the replacement engine is
                    # even built: Engine.restore() re-arms overdue timers
                    # with zero delay, so the new engine can emit its
                    # first events the instant restore() releases its
                    # lock — those must land after the epoch boundary.
                    # (The old engine is already silenced, so nothing
                    # else can write in between.)
                    # One marker PER PARTITION: audit events are keyed by
                    # pid (partition-sticky), so each partition's offset
                    # order is the ground truth — a consumer of any single
                    # partition must see the boundary in-stream
                    # (timestamps can collide within a batch flush and
                    # cannot order events across it).
                    # ``active_pids`` is the restored-active set: events
                    # the dead epoch emitted past the cut for THESE pids
                    # (e.g. a timer completion) are rolled back too — the
                    # restored instance is live again and may re-complete.
                    # An audit consumer needs exactly {next_pid,
                    # active_pids} to reconcile at-least-once redelivery.
                    marker = {
                        "event": "engine_restored",
                        "reason": reason,
                        "next_pid": next_pid,
                        "active_pids": active_pids,
                        "ts": time.time(),
                    }
                    n_parts = len(self.broker.end_offsets(self._audit_topic))
                    for p in range(n_parts):
                        self.broker.produce(self._audit_topic, marker,
                                            partition=p)
                engine = self.engine_factory()
                if self._last is not None:
                    engine.restore(self._last["snap"])
                # swap BEFORE the rewind: if the pause wasn't acked (router
                # wedged past the timeout, still looping), a post-rewind
                # poll would commit the rewound records forward and feed
                # them to the shut-down engine — permanently lost. Swapped
                # first, the worst case is a pre-rewind batch landing in
                # the NEW engine and then re-delivering after the rewind:
                # duplicates, which is what at-least-once already means.
                self.router.swap_engine(engine)
                if self.on_swap is not None:
                    self.on_swap(engine)
                # extra pipeline state resets to the cut too — replayed
                # records then re-apply onto exactly the state they
                # already applied to once (e.g. per-customer histories;
                # without this, replay double-appends). Absent entries
                # (state registered after the cut, or genesis) reset via
                # restore_fn(None) semantics only when recorded.
                extra = (self._last.get("extra", {})
                         if self._last is not None else {})
                for name, (_, restore_fn) in self._extra_state.items():
                    try:
                        # None = reset-to-empty (genesis restore, or state
                        # registered after the recorded cut): replay from
                        # the rewound offsets rebuilds it from scratch
                        restore_fn(extra.get(name))
                    except Exception:  # noqa: BLE001 - a state module's
                        # failure must not abort the engine restore
                        import logging

                        logging.getLogger(__name__).exception(
                            "extra state %r restore failed", name
                        )
                if boot or acked or not self._router_loop_alive():
                    # real Kafka refuses offset resets for a group with
                    # live members: the parked loop's consumers still
                    # heartbeat, so they are closed and recreated before
                    # the rewind (in-process: a cheap rebalance). Only
                    # safe when the loop is provably parked, dead, or not
                    # yet born — an unacked live loop could be mid-poll.
                    self.router.recycle_consumers()
                for key, offs in offsets.items():
                    g, t = key.split("\x00", 1)
                    self.broker.reset_offsets(g, t, offs)
            finally:
                self.router.resume()
            self.restores += 1
            self.last_restore_s = time.perf_counter() - t_restore
            return engine


    # -- full-process crash recovery ---------------------------------------
    def restore_from_disk(self, reason: str = "boot") -> Engine | None:
        """Recover from the on-disk cut at bring-up, BEFORE the router's
        loop starts: loads the last persisted checkpoint, restores it into
        a fresh engine, rewinds the bus groups to the cut, and swaps it in
        — the same restore path a live crash takes, minus a barrier to
        wait for. Returns the restored engine, or None when no usable cut
        exists (missing/corrupt file reads as a cold start, never a
        crash)."""
        from ccfd_tpu_torch.runtime.durability import read_json_artifact

        if not self.path:
            return None
        try:
            # verified read (runtime/durability.py): a torn/bit-flipped
            # newest cut is QUARANTINED and the last-good retained
            # generation restores instead — replay from a slightly older
            # cut beats both a crash and a cold start
            cut = read_json_artifact(self.path, artifact="recovery_cut",
                                     fallback=True)
            # valid JSON is not necessarily a valid cut: guard the shape,
            # not just the parse (null / [] / non-dict snap must all read
            # as cold starts)
            if not isinstance(cut, dict) or cut.get("version") != 1:
                raise ValueError(f"not a v1 cut: {type(cut).__name__}")
            last = {"snap": cut["snap"], "offsets": cut["offsets"],
                    "ts": cut.get("ts", 0.0)}
            if not isinstance(last["snap"], dict) or not isinstance(
                    last["offsets"], dict):
                raise ValueError("cut fields have wrong shapes")
        except FileNotFoundError:
            return None  # cold start, nothing ever written
        except Exception as e:  # noqa: BLE001 - includes CorruptArtifact
            import logging

            logging.getLogger(__name__).warning(
                "checkpoint file %s unusable (%s); cold start", self.path, e
            )
            return None
        self._last = last
        return self.restore(reason=reason, boot=True)


def attach_engine_service(
    supervisor, coordinator: CheckpointCoordinator, name: str = "engine"
):
    """Register the engine as a supervised, chaos-killable service.

    The engine itself is passive (the router calls into it), so the
    service body is a liveness loop; what makes the kill REAL is the reset
    hook: the supervisor runs ``coordinator.restore()`` before each
    respawn, so a ChaosMonkey kill discards the live engine's
    post-checkpoint state and re-drives it from the bus — the same
    recovery a KIE pod restart goes through.
    """
    stop = threading.Event()
    first = [True]

    def run() -> None:
        stop.wait()

    def reset() -> None:
        stop.clear()
        if first[0]:
            # initial spawn is a boot, not a crash: the live engine already
            # holds the truth and the offsets are wherever the operator put
            # them — restoring here would discard both
            first[0] = False
            return
        coordinator.restore(reason="supervisor-restart")

    supervisor.add_thread_service(name, run, stop.set, reset=reset)
    return supervisor
