"""FleetMember: one operator process's seat at the fleet table.

The port's copy of ccfd_tpu/fleet/member.py. Each member of the fleet is a
full ``platform.operator`` process sharing ONE networked bus (and, on one
card, the card: each member holds its own CUDA context); this module adds
the fleet-level planes on top of the member's local ones:

* **membership**: a heartbeat HTTP endpoint (``GET /fleet/health``) and
  a gossip loop dialing every peer each tick. A peer whose lease
  (``ttl_s``) expires is DEAD to the protocol (protocol.live_members);
  unreachable peers are re-dialed under jittered exponential backoff
  (runtime/breaker.backoff_s) so a respawned member rejoins without a
  thundering herd.
* **fleet admission**: the local AIMD budget's ceiling is rescaled to
  an equal share of the fleet-wide ceiling over LIVE members
  (protocol.admission_share -> AdaptiveInflightBudget.rescale_ceiling):
  N-1 survivors of a kill absorb the dead member's share, a rejoin
  hands it back.
* **champion parity**: members exchange the served params' fingerprint
  (params.params_fingerprint) over the heartbeat; a member whose
  fingerprint diverges from the fleet majority self-quarantines to the
  rules tier through the router's heal-gate seam (:class:`FleetParityGate`,
  AND-composed with the storage and heal gates by the operator).
* **aggregation**: the lexicographically-first live member is the
  elected aggregator (protocol.elect_aggregator): its gauges are the
  fleet-true series for the Fleet board, and it alone dumps the
  member-kill flight-recorder bundle (once per (member, incarnation))
  when a peer's lease expires.

Gauges: ``ccfd_fleet_members``, ``ccfd_fleet_epoch``,
``ccfd_fleet_partition_owner{partition}``, ``ccfd_fleet_parity``,
``ccfd_fleet_quarantined``, ``ccfd_fleet_aggregator``,
``ccfd_fleet_admission_ceiling``; counters
``fleet_member_kill_bundles_total`` and ``fleet_gossip_errors_total``.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Iterable

from ccfd_tpu_torch.fleet.protocol import (
    admission_share,
    check_fingerprint_parity,
    elect_aggregator,
    live_members,
)
from ccfd_tpu_torch.runtime.breaker import backoff_s
from ccfd_tpu_torch.utils.httpserver import FrameworkHTTPServer

log = logging.getLogger(__name__)

HEALTH_PATH = "/fleet/health"


class FleetParityGate:
    """Heal-gate-shaped quarantine switch for a stale-champion member.

    While quarantined BOTH tiers are refused — the host tier would
    forward the same stale params the device would, so the only honest
    fallback is rules-only (the same posture as the storage pin). The
    gossip loop flips it from parity evidence; the router consults it
    through the operator's ComposedHealGate chain.
    """

    def __init__(self, registry: Any = None):
        self._mu = threading.Lock()
        self._quarantined = False
        self.reason: str | None = None
        self._g = None
        if registry is not None:
            self._g = registry.gauge(
                "ccfd_fleet_quarantined",
                "1 while this member self-quarantined to the rules tier "
                "(champion fingerprint diverged from the fleet majority)",
            )
            self._g.set(0)

    @property
    def quarantined(self) -> bool:
        with self._mu:
            return self._quarantined

    def quarantine(self, reason: str) -> None:
        with self._mu:
            was = self._quarantined
            self._quarantined = True
            self.reason = reason
            if self._g is not None:
                self._g.set(1)
        if not was:
            log.error("fleet parity quarantine: %s", reason)

    def release(self) -> None:
        with self._mu:
            was = self._quarantined
            self._quarantined = False
            self.reason = None
            if self._g is not None:
                self._g.set(0)
        if was:
            log.warning("fleet parity quarantine released")

    # the router's heal-gate surface
    def device_allowed(self) -> bool:
        return not self.quarantined

    def host_allowed(self) -> bool:
        return not self.quarantined


class FleetMember:
    """Gossip + heartbeat + fleet actuators; see the module docstring.

    ``consumers_fn`` resolves the router's tx consumers (one for a
    single Router, one per worker under a ParallelRouter) so ownership
    and epoch track crash-recycled consumers instead of a stale
    snapshot. ``counters_fn`` returns the member's accounting counters
    (the operator wires it to the router registry totals).
    """

    def __init__(
        self,
        member: str,
        registry: Any,
        peers: Iterable[str] = (),
        heartbeat_host: str = "127.0.0.1",
        heartbeat_port: int = 0,
        ttl_s: float = 3.0,
        overload: Any = None,
        recorder: Any = None,
        fingerprint_fn: Callable[[], str | None] | None = None,
        consumers_fn: Callable[[], list] | None = None,
        counters_fn: Callable[[], dict[str, int]] | None = None,
        global_max_inflight: int | None = None,
        gossip_timeout_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.member = str(member)
        self.registry = registry
        self.peers = [p.rstrip("/") for p in peers]
        self.heartbeat_host = heartbeat_host
        self.heartbeat_port = int(heartbeat_port)
        self.ttl_s = float(ttl_s)
        self.overload = overload
        self.recorder = recorder
        self.fingerprint_fn = fingerprint_fn
        self.consumers_fn = consumers_fn
        self.counters_fn = counters_fn
        self._gossip_timeout_s = float(gossip_timeout_s)
        self._clock = clock
        # incarnation distinguishes a respawned member from its corpse:
        # the aggregator's member-kill bundle fires once per incarnation
        self.incarnation = f"{os.getpid()}-{int(clock() * 1000) & 0xFFFFFF}"
        self.parity_gate = FleetParityGate(registry)
        if overload is not None:
            budget = overload.budget
            self._global_ceiling = int(global_max_inflight
                                       or budget.max_limit)
        else:
            self._global_ceiling = int(global_max_inflight or 0)
        self._mu = threading.Lock()
        self._last_seen: dict[str, float] = {}
        self._fingerprints: dict[str, str | None] = {}
        self._incarnations: dict[str, str] = {}
        self._peer_health: dict[str, dict] = {}
        self._peer_clients: dict[str, Any] = {}
        self._peer_attempts: dict[str, int] = {}
        self._peer_next_dial: dict[str, float] = {}
        self._reported_kills: set[tuple[str, str]] = set()
        self._prev_live: set[str] = set()
        self._prev_owned: set[int] = set()
        self._rng = random.Random(hash(self.member) & 0xFFFF)
        self._stop = threading.Event()
        self._httpd: FrameworkHTTPServer | None = None
        r = registry
        self._g_members = r.gauge(
            "ccfd_fleet_members", "live fleet members (lease not expired)")
        self._g_epoch = r.gauge(
            "ccfd_fleet_epoch",
            "this member's view of the router group's bus epoch")
        self._g_owner = r.gauge(
            "ccfd_fleet_partition_owner",
            "1 for each tx partition this member currently owns "
            "(fleet-wide sum per partition must be exactly 1)")
        self._g_parity = r.gauge(
            "ccfd_fleet_parity",
            "1 while every live member with a known fingerprint serves "
            "the fleet-majority champion")
        self._g_aggregator = r.gauge(
            "ccfd_fleet_aggregator",
            "1 on the elected aggregator member (lexicographically first "
            "live member)")
        self._g_share = r.gauge(
            "ccfd_fleet_admission_ceiling",
            "this member's share of the fleet-wide admission ceiling")
        self._c_kills = r.counter(
            "fleet_member_kill_bundles_total",
            "member-kill incident bundles dumped by this member while "
            "elected aggregator")
        self._c_gossip_err = r.counter(
            "fleet_gossip_errors_total",
            "failed peer heartbeat dials (lease expiry is the detector; "
            "this counts the evidence)")

    # -- heartbeat server --------------------------------------------------
    def start_server(self) -> str:
        fleet = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.rstrip("/") != HEALTH_PATH:
                    self.send_error(404)
                    return
                body = json.dumps(fleet.health_snapshot()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self._httpd = FrameworkHTTPServer(
            (self.heartbeat_host, self.heartbeat_port), Handler)
        self.heartbeat_port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever,
                             name=f"fleet-heartbeat-{self.member}",
                             daemon=True)
        t.start()
        return self.endpoint

    @property
    def endpoint(self) -> str:
        return f"http://{self.heartbeat_host}:{self.heartbeat_port}"

    # -- state reads -------------------------------------------------------
    def _consumers(self) -> list:
        if self.consumers_fn is None:
            return []
        try:
            return list(self.consumers_fn() or [])
        except Exception:  # noqa: BLE001 - a crash-recycling router may
            # briefly have no consumers; counted as gossip evidence
            self._c_gossip_err.inc(labels={"peer": "local"})
            return []

    def owned_partitions(self) -> list[int]:
        owned: set[int] = set()
        for c in self._consumers():
            a = getattr(c, "assignment", None)
            if callable(a):
                a = a()
            for _t, p in (a or []):
                owned.add(int(p))
        return sorted(owned)

    def group_epoch_view(self) -> int:
        return max((int(getattr(c, "epoch", 0)) for c in self._consumers()),
                   default=0)

    def _fingerprint(self) -> str | None:
        if self.fingerprint_fn is None:
            return None
        try:
            return self.fingerprint_fn()
        except Exception:  # noqa: BLE001 - an unknown fingerprint reads
            # as "warming up", never as stale; counted as evidence
            self._c_gossip_err.inc(labels={"peer": "fingerprint"})
            return None

    def _counters(self) -> dict[str, int]:
        if self.counters_fn is None:
            return {}
        try:
            return dict(self.counters_fn())
        except Exception:  # noqa: BLE001 - accounting snapshot is
            # best-effort on a mid-recycle router; counted
            self._c_gossip_err.inc(labels={"peer": "counters"})
            return {}

    def health_snapshot(self) -> dict[str, Any]:
        with self._mu:
            live = live_members(self._last_seen, self._clock(), self.ttl_s)
        return {
            "member": self.member,
            "incarnation": self.incarnation,
            "pid": os.getpid(),
            "epoch": self.group_epoch_view(),
            "partitions": self.owned_partitions(),
            "fingerprint": self._fingerprint(),
            "counters": self._counters(),
            "quarantined": self.parity_gate.quarantined,
            "live": live,
            "aggregator": elect_aggregator(live) == self.member,
            "admission_ceiling": (
                int(self.overload.budget.max_limit)
                if self.overload is not None else None),
        }

    # -- gossip loop -------------------------------------------------------
    def _client(self, peer: str):
        cl = self._peer_clients.get(peer)
        if cl is None:
            from ccfd_tpu_torch.utils.httpclient import PooledHTTPClient

            cl = PooledHTTPClient(peer, default_port=80, pool_size=1,
                                  timeout_s=self._gossip_timeout_s,
                                  retries=0)
            self._peer_clients[peer] = cl
        return cl

    def _gossip_once(self, now: float) -> None:
        for peer in self.peers:
            if now < self._peer_next_dial.get(peer, 0.0):
                continue
            try:
                status, body = self._client(peer).request(
                    "GET", HEALTH_PATH)
            except ConnectionError:
                # dead/respawning peer: jittered exponential backoff on
                # the redial (runtime/breaker.backoff_s) — detection
                # itself rides the lease expiry, not this dial
                attempt = self._peer_attempts.get(peer, 0)
                self._peer_attempts[peer] = attempt + 1
                self._peer_next_dial[peer] = now + backoff_s(
                    attempt, base_s=0.2, cap_s=self.ttl_s, rng=self._rng)
                self._c_gossip_err.inc(labels={"peer": peer})
                continue
            self._peer_attempts[peer] = 0
            self._peer_next_dial[peer] = 0.0
            if status != 200 or not isinstance(body, dict):
                self._c_gossip_err.inc(labels={"peer": peer})
                continue
            name = str(body.get("member", peer))
            with self._mu:
                self._last_seen[name] = now
                self._fingerprints[name] = body.get("fingerprint")
                self._incarnations[name] = str(body.get("incarnation", ""))
                self._peer_health[name] = body

    def tick(self) -> dict[str, Any]:
        """One gossip round: dial peers, refresh the lease table, run the
        fleet actuators (admission rescale, parity quarantine, aggregator
        duty), publish the gauges. Returns the tick's fleet view (the
        drills assert on it)."""
        now = self._clock()
        self._gossip_once(now)
        with self._mu:
            self._last_seen[self.member] = now
            self._fingerprints[self.member] = self._fingerprint()
            self._incarnations.setdefault(self.member, self.incarnation)
            live = live_members(self._last_seen, now, self.ttl_s)
            fps = {m: self._fingerprints.get(m) for m in live}
            incarnations = dict(self._incarnations)
            prev_live = set(self._prev_live)
            self._prev_live = set(live)
        epoch = self.group_epoch_view()
        owned = set(self.owned_partitions())
        parity = check_fingerprint_parity(fps)
        aggregator = elect_aggregator(live)

        # actuator 1: fleet admission — equal share of the global ceiling
        share = None
        if self.overload is not None and self._global_ceiling > 0:
            share = admission_share(self._global_ceiling, len(live))
            self.overload.budget.rescale_ceiling(share)
            self._g_share.set(float(share))

        # actuator 2: champion parity — stale member self-quarantines
        if self.member in parity["stale"]:
            self.parity_gate.quarantine(
                f"champion fingerprint diverges from fleet majority "
                f"{str(parity['majority'])[:12]}")
        else:
            self.parity_gate.release()

        # actuator 3: aggregator duty — one bundle per killed incarnation
        dead = sorted(prev_live - set(live) - {self.member})
        if dead and aggregator == self.member and self.recorder is not None:
            for m in dead:
                key = (m, incarnations.get(m, ""))
                if key in self._reported_kills:
                    continue
                self._reported_kills.add(key)
                try:
                    self.recorder.incident({
                        "type": "fleet_member_kill",
                        "member": m,
                        "incarnation": key[1],
                        "survivors": live,
                        "epoch": epoch,
                    })
                    self._c_kills.inc()
                except Exception:  # noqa: BLE001 - evidence, never a
                    # crash; the kill stays visible via ccfd_fleet_members
                    self._c_gossip_err.inc(labels={"peer": "incident"})

        self._g_members.set(float(len(live)))
        self._g_epoch.set(float(epoch))
        self._g_parity.set(1.0 if parity["parity"] else 0.0)
        self._g_aggregator.set(1.0 if aggregator == self.member else 0.0)
        for p in owned:
            self._g_owner.set(1.0, labels={"partition": str(p)})
        for p in self._prev_owned - owned:
            self._g_owner.set(0.0, labels={"partition": str(p)})
        self._prev_owned = owned
        return {
            "live": live,
            "epoch": epoch,
            "partitions": sorted(owned),
            "parity": parity,
            "aggregator": aggregator,
            "admission_ceiling": share,
            "dead": dead,
        }

    # -- supervised-service surface ---------------------------------------
    def run(self, interval_s: float = 0.5) -> None:
        while not self._stop.wait(interval_s):
            self.tick()

    def stop(self) -> None:
        self._stop.set()

    def reset(self) -> None:
        self._stop.clear()

    def close(self) -> None:
        self.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for cl in self._peer_clients.values():
            try:
                cl.close()
            except Exception:  # noqa: BLE001 - teardown must not raise;
                # nothing to account, the process is exiting
                log.debug("peer client close failed", exc_info=True)
        self._peer_clients.clear()
