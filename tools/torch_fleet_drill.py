#!/usr/bin/env python
"""Fleet kill drill on the port: hard-kill one member of a live fleet, prove survival.

The port's counterpart of tools/fleet_drill.py, over
``python -m ccfd_tpu_torch fleet member`` processes:

  1. one shared networked bus (the port's bus/server.py over real HTTP)
     and N member processes on ``--device`` (the card unless ``cpu``; on
     one card every member holds its own CUDA context and serves the
     default ``mlp`` through kernel B1), partitions split across members
     via the bus's ``router`` consumer group;
  2. traffic flows; one member is SIGKILLed MID-TRAFFIC (no atexit, no
     commit, no socket close), then the supervisor fences its idle
     consumers so the group rebalances under a bumped epoch;
  3. survivors re-adopt the dead member's partitions (disjointly: no
     partition double-owned, none orphaned), the victim respawns and the
     fleet rebalances again;
  4. the per-transaction conservation law is checked against the durable
     fleet ledger (fleet/ledger.py): every produced tx disposed, no ghost,
     no same-epoch double-route; cross-epoch redeliveries are counted
     at-least-once deliveries, not violations;
  5. champion fingerprint parity holds across survivors (nobody
     quarantined), per-member counter accounting balances, the elected
     aggregator dumped EXACTLY ONE member-kill incident bundle, and the
     survivor's exporter serves green ccfd_fleet_* gauges over HTTP;
  6. a fleet-scaling row is recorded: the whole drill window's tx/s, as
     the reference's, and with ``--scaling-burst N`` the tx/s of an N-row
     burst at every fleet size from N members down to 1 (one member
     killed and fenced between sizes).

Unlike the reference's, the drill waits for the members' membership
views: traffic starts once every member sees the whole fleet live, and the
victim respawns only once every survivor has seen its lease expire (a
death is seen only by a survivor that saw the member live, and a member
that restarts faster than its lease would rejoin unseen). Besides the reference's
``checks`` the result carries the kill-to-re-adoption and kill-to-lease-
expiry times, the redelivery count, each member's pid and a few
families of each member's scrape (its kernel launches, its scorer's
dispatches and its builds). ``run_drill`` takes an ``inspect`` callback
that sees the live fleet once after the drain (the smoke reads each
member's device memory there), and ``member_overrides`` for the members'
CR blocks. Exit 0 iff every check passes.

  python tools/torch_fleet_drill.py [--members 2] [--partitions 4]
      [--txs-before 300] [--txs-after 300] [--ttl-s 2] [--device cuda|cpu]
      [--scaling-burst 0] [--state-dir D]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable
from urllib.request import urlopen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the member-scrape families the result keeps (each member's kernel
# launches, its scorer's dispatches, any kernel build it ran, and its
# post-route commits the bus fenced or lost)
SCRAPE_FAMILIES = ("ccfd_kernel_launches", "ccfd_scorer_dispatches",
                   "ccfd_build_events_total", "router_fenced_commits_total",
                   "router_commit_errors_total")


def member_env(device: str) -> dict[str, str]:
    """The members' environment: the Python transport (members serve no
    REST), and on the CPU the small bucket ladder of a routing drill."""
    env = dict(os.environ)
    env["CCFD_NATIVE_FRONT"] = "0"
    if device == "cpu":
        env["CCFD_BATCH_SIZES"] = "16,128,1024"
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def _scrape(port: int) -> str:
    with urlopen(f"http://127.0.0.1:{port}/metrics", timeout=3.0) as r:
        return r.read().decode()


def _gauge(text: str, name: str) -> float | None:
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            try:
                return float(line.rsplit(" ", 1)[1])
            except ValueError:
                return None
    return None


def _families(text: str, names: tuple[str, ...]) -> dict[str, float]:
    """``{"name{labels}": value}`` for the samples of ``names``; a family
    registered with no sample yet (a counter never incremented) reads 0."""
    out: dict[str, float] = {}
    typed = []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            name = line.split()[2]
            if name.startswith(names):
                typed.append(name)
        elif line and not line.startswith("#") and line.startswith(names):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    for name in typed:
        if not any(k == name or k.startswith(name + "{") for k in out):
            out[name] = 0.0
    return out


def run_drill(
    members: int = 2,
    partitions: int = 4,
    txs_before: int = 300,
    txs_after: int = 300,
    ttl_s: float = 2.0,
    state_dir: str | None = None,
    drain_timeout_s: float = 90.0,
    ready_timeout_s: float = 120.0,
    device: str = "cuda",
    scaling_burst: int = 0,
    inspect: Callable[[Any, list[str]], Any] | None = None,
    member_overrides: dict | None = None,
) -> dict:
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.bus.client import RemoteBroker
    from ccfd_tpu_torch.bus.server import BrokerServer
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.fleet.ledger import LEDGER_TOPIC, flatten_ledger
    from ccfd_tpu_torch.fleet.protocol import (
        check_disjoint_ownership,
        check_fingerprint_parity,
        check_ledger_conservation,
        check_member_accounting,
    )
    from ccfd_tpu_torch.fleet.supervisor import FleetSupervisor, _free_port, build_member_cr

    cfg = Config.from_env()
    out: dict = {"ok": False, "checks": {}, "members": members,
                 "partitions": partitions, "device": device}
    checks = out["checks"]
    state_dir = state_dir or tempfile.mkdtemp(prefix="torch-fleet-drill-")
    out["state_dir"] = state_dir

    # the ONE shared component: a real networked bus over real HTTP
    srv = BrokerServer(Broker(default_partitions=partitions))
    bus_url = f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"
    out["bus_url"] = bus_url

    names = [f"m{i:02d}" for i in range(members)]
    hb = {n: _free_port() for n in names}
    mon = {n: _free_port() for n in names}
    eps = {n: f"http://127.0.0.1:{hb[n]}" for n in names}
    sup = FleetSupervisor(bus_url, state_dir, env=member_env(device), device=device)
    client = RemoteBroker(bus_url)
    led = None
    produced: list[str] = []
    seq = 0

    def produce(count: int) -> None:
        nonlocal seq
        vals, keys = [], []
        for _ in range(count):
            tx = f"tx-{seq:06d}"
            seq += 1
            produced.append(tx)
            vals.append({"id": tx, "Amount": 50.0 + (seq % 400)})
            keys.append(tx)
        client.produce_batch(cfg.kafka_topic, vals, keys=keys)

    def wait_disjoint(expect_members: int, timeout_s: float = 45.0) -> list:
        deadline = time.monotonic() + timeout_s
        violations = ["never checked"]
        while time.monotonic() < deadline:
            owners = sup.ownership()
            if len(owners) == expect_members:
                violations = check_disjoint_ownership(owners, partitions)
                if not violations:
                    return []
            time.sleep(0.1)
        return violations

    def wait_views(who: list[str], want: set[str]) -> bool:
        """Until each of ``who`` sees exactly ``want`` live (lease model)."""
        deadline = time.monotonic() + 6.0 * ttl_s
        while time.monotonic() < deadline:
            if all(set((sup.health(n) or {}).get("live") or ()) == want for n in who):
                return True
            time.sleep(0.05)
        return False

    def wait_quiescent(who: list[str], timeout_s: float) -> bool:
        """Until every member's counters balance (incoming = routed + shed +
        errors) and stay unchanged over two reads 0.5 s apart."""
        deadline = time.monotonic() + timeout_s
        last = None
        while time.monotonic() < deadline:
            now = {n: (sup.health(n) or {}).get("counters") for n in who}
            balanced = all(c and int(c.get("incoming", 0)) == sum(
                int(c.get(k, 0)) for k in ("routed", "shed", "errors")) for c in now.values())
            if balanced and now == last:
                return True
            last = now
            time.sleep(0.5)
        return False

    def disposed_total(live: list[str]) -> tuple[int, int]:
        inc = done = 0
        for n in live:
            h = sup.health(n)
            c = (h or {}).get("counters", {})
            inc += int(c.get("incoming", 0))
            done += sum(int(c.get(k, 0)) for k in ("routed", "shed", "errors"))
        return inc, done

    try:
        for n in names:
            sup.add_member(n, build_member_cr(
                n, bus_url, hb[n], [eps[o] for o in names if o != n], state_dir,
                ttl_s=ttl_s, gossip_interval_s=0.25, monitoring_port=mon[n],
                overrides=member_overrides, device=device))
            sup.spawn(n)
        t_ready = time.monotonic()
        sup.wait_ready(timeout_s=ready_timeout_s)
        out["ready_s"] = time.monotonic() - t_ready
        out["pids"] = {n: sup.members[n]["proc"].pid for n in names}
        checks["initial_ownership_disjoint"] = wait_disjoint(members) == []
        # every member's membership view holds the whole fleet before the
        # traffic: a death is seen only by a survivor that saw the member live
        wait_views(names, set(names))

        # phase 1: traffic across the whole fleet; the kill lands
        # MID-TRAFFIC (the victim demonstrably routing when it dies)
        t_bench = time.monotonic()
        produce(txs_before)
        victim = names[-1]
        deadline = time.monotonic() + 60.0
        victim_routing = False
        while time.monotonic() < deadline:
            h = sup.health(victim)
            if h is not None and int(h.get("counters", {}).get("routed", 0)) > 0:
                victim_routing = True
                break
            time.sleep(0.05)
        checks["victim_was_routing"] = victim_routing

        # phase 2: HARD kill + fence; survivors must re-adopt ALL
        # partitions disjointly while traffic keeps flowing
        t_kill = time.monotonic()
        sup.kill(victim, fence_idle_s=0.5, settle_s=1.0)
        produce(txs_after)
        survivors = [n for n in names if n != victim]
        checks["survivors_adopted_all_partitions"] = wait_disjoint(len(survivors)) == []
        out["kill_to_readoption_s"] = time.monotonic() - t_kill
        # the victim's lease expires in every survivor's view before it
        # respawns: a respawn inside the lease would rejoin as a live
        # member and the death (and its bundle) would never be seen
        wait_views(survivors, set(survivors))
        out["kill_to_lease_expiry_s"] = time.monotonic() - t_kill

        # phase 3: respawn: the fleet heals back to N members
        sup.respawn(victim, timeout_s=ready_timeout_s)
        out["pids"][victim + "_respawned"] = sup.members[victim]["proc"].pid
        checks["rebalanced_after_respawn"] = wait_disjoint(members) == []

        # phase 4: drain the ledger until every produced tx is disposed
        led = client.consumer("fleet-drill-ledger", (LEDGER_TOPIC,))
        entries: list[dict] = []
        disposed: set[str] = set()
        deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < deadline:
            recs = led.poll(max_records=2048, timeout_s=0.5)
            if recs:
                fresh = flatten_ledger(recs)
                entries.extend(fresh)
                disposed.update(str(e["tx"]) for e in fresh)
            if set(produced) <= disposed:
                break
        bench_wall_s = time.monotonic() - t_bench

        conservation = check_ledger_conservation(produced, entries)
        out["conservation"] = {k: (v if not isinstance(v, list) else v[:5])
                               for k, v in conservation.items()}
        out["redeliveries"] = conservation["cross_epoch_redeliveries"]
        checks["ledger_conserved"] = bool(conservation["conserved"])
        checks["ledger_covers_all_produced"] = (
            conservation["disposed"] == conservation["produced"])

        # phase 5: parity + accounting + gauges + incident evidence, once
        # the members are quiescent: a redelivered batch still routing
        # after the ledger covered every tx is in flight, not lost
        out["quiesced"] = wait_quiescent(names, drain_timeout_s)
        health = {n: sup.health(n) for n in names}
        live = {n: h for n, h in health.items() if h is not None}
        checks["all_members_answer_health"] = len(live) == members
        parity = check_fingerprint_parity(
            {h["member"]: h.get("fingerprint") for h in live.values()})
        out["parity"] = parity
        checks["champion_parity"] = bool(parity["parity"] and parity["majority"] is not None)
        checks["nobody_quarantined"] = not any(h.get("quarantined") for h in live.values())
        acct_violations = check_member_accounting(
            {h["member"]: h.get("counters", {}) for h in live.values()})
        out["accounting_violations"] = acct_violations
        checks["member_accounting_balances"] = not acct_violations

        # the survivor's exporter over real HTTP: parity green, the full
        # membership back, nobody quarantined. Polled: the survivor's
        # gossip redial to the respawned victim rides a jittered backoff,
        # so its membership view converges within ~ttl, not instantly
        gauges_green = False
        text = ""
        deadline = time.monotonic() + 6.0 * ttl_s
        while not gauges_green and time.monotonic() < deadline:
            try:
                text = _scrape(mon[survivors[0]])
                gauges_green = (_gauge(text, "ccfd_fleet_parity") == 1.0
                                and _gauge(text, "ccfd_fleet_members") == float(members)
                                and _gauge(text, "ccfd_fleet_quarantined") == 0.0)
            except OSError:
                pass
            if not gauges_green:
                time.sleep(0.2)
        checks["fleet_gauges_green"] = gauges_green
        out["fleet_gauges"] = _families(text, ("ccfd_fleet_",))

        bundles = sorted(glob.glob(os.path.join(
            state_dir, "incidents-*", "inc-*-fleet_member_kill.json")))
        out["kill_bundles"] = bundles
        checks["exactly_one_kill_bundle"] = len(bundles) == 1

        out["bus"] = {"group_epoch": client.group_epoch("router"),
                      "fenced_commits": getattr(srv.broker, "fenced_commits", None)}
        out["member_metrics"] = {}
        for n in names:
            try:
                out["member_metrics"][n] = _families(_scrape(mon[n]), SCRAPE_FAMILIES)
            except OSError:
                out["member_metrics"][n] = None
        if inspect is not None:
            out["inspect"] = inspect(sup, names)

        # the fleet-scaling row over the whole drill window, kill and
        # rebalance included (the reference drill's row)
        bench = {
            "mode": "fleet_scaling",
            "members": members,
            "partitions": partitions,
            "transactions": len(produced),
            "wall_s": bench_wall_s,
            "tx_s": len(produced) / max(bench_wall_s, 1e-9),
            "kill_and_rejoin_included": True,
        }
        out["bench"] = bench
        checks["bench_row_recorded"] = True

        # the scaling row: one burst at each fleet size, largest first; a
        # member is killed and fenced between sizes
        if scaling_burst > 0:
            rows = []
            alive = list(names)
            while alive:
                if not wait_disjoint(len(alive)) == []:
                    raise AssertionError(f"no disjoint ownership at {len(alive)} members")
                inc0, done0 = disposed_total(alive)
                t0 = time.monotonic()
                produce(scaling_burst)
                deadline = t0 + max(120.0, drain_timeout_s)
                while True:
                    inc, done = disposed_total(alive)
                    if inc - inc0 >= scaling_burst and done - done0 >= scaling_burst:
                        break
                    if time.monotonic() > deadline:
                        raise AssertionError(f"burst at {len(alive)} members not disposed: "
                                             f"{inc - inc0} in, {done - done0} done")
                    time.sleep(0.02)
                wall = time.monotonic() - t0
                rows.append({"members": len(alive), "transactions": scaling_burst,
                             "wall_s": wall, "tx_s": scaling_burst / wall})
                if len(alive) == 1:
                    break
                sup.kill(alive.pop(), fence_idle_s=0.5, settle_s=1.0)
            out["scaling"] = rows

        out["ok"] = all(checks.values())
    finally:
        if led is not None:
            led.close()
        client.close()
        sup.stop_all()
        srv.stop()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=2)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--txs-before", type=int, default=300)
    ap.add_argument("--txs-after", type=int, default=300)
    ap.add_argument("--ttl-s", type=float, default=2.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every member scores (default: the card)")
    ap.add_argument("--scaling-burst", type=int, default=0,
                    help="rows of the burst timed at each fleet size (0 = none)")
    ap.add_argument("--state-dir", default=None,
                    help="keep artifacts here (default: a fresh temp dir)")
    args = ap.parse_args()
    out = run_drill(members=args.members, partitions=args.partitions,
                    txs_before=args.txs_before, txs_after=args.txs_after,
                    ttl_s=args.ttl_s, state_dir=args.state_dir, device=args.device,
                    scaling_burst=args.scaling_burst)
    print(json.dumps(out, indent=2))
    print(f"FLEETDRILL verdict={'PASS' if out['ok'] else 'FAIL'}", file=sys.stderr)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
