"""Pure fleet-protocol functions: membership, ownership, parity, accounting.

The port's copy of ccfd_tpu/fleet/protocol.py, with its contracts. Plain,
deterministic Python: no sockets, no clocks read internally (callers pass
``now``), so the fleet's decision logic is tested without a process. The
fleet member (fleet/member.py), the supervisor (fleet/supervisor.py) and
the kill drill (tools/torch_fleet_drill.py) call these instead of
re-deriving the invariants inline.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

LOCAL_ROWS_DEFAULT = 512


# -- membership ------------------------------------------------------------
def live_members(last_seen: Mapping[str, float], now: float,
                 ttl_s: float) -> list[str]:
    """Members whose last heartbeat is within the lease window, sorted.

    The lease model: a heartbeat at time t grants a lease until
    ``t + ttl_s``; a member whose lease expired is DEAD to the protocol
    (its partitions are re-adopted, its admission share redistributed)
    even if the process still exists — exactly Kafka's session timeout,
    and the reason the bus-side epoch fence must exist: a deposed member
    may not know it is dead."""
    return sorted(m for m, t in last_seen.items() if now - t <= ttl_s)


def elect_aggregator(members: Iterable[str]) -> str | None:
    """Deterministic aggregator election: lexicographically first live
    member. Every member computes this locally from the same membership
    view — no ballot, no coordinator; a split view heals on the next
    gossip round (both claimants export, scrapes dedupe by member label).
    None when the fleet is empty."""
    members = sorted(members)
    return members[0] if members else None


# -- partition ownership ---------------------------------------------------
def plan_partition_assignment(members: Iterable[str],
                              n_partitions: int) -> dict[int, str]:
    """Deterministic round-robin plan: partition p -> sorted-member
    p % len(members). This is the PLANNED ownership used for gauges and
    drill assertions; the bus's consumer-group rebalance is the
    authoritative assignment (same round-robin shape, but over join
    order). Empty members -> empty plan (no owner, nothing served)."""
    ms = sorted(members)
    if not ms:
        return {}
    return {p: ms[p % len(ms)] for p in range(int(n_partitions))}


def check_disjoint_ownership(owners: Mapping[str, Iterable[int]],
                             n_partitions: int) -> list[str]:
    """Validate a claimed ownership map ``{member: [partition, ...]}``:
    every partition in [0, n) owned by EXACTLY one member. Returns a list
    of human-readable violations (empty == invariant holds). Double
    ownership is the double-route precursor; an orphan partition is the
    drop precursor — the two failure modes the fleet drill exists to
    rule out."""
    violations: list[str] = []
    seen: dict[int, str] = {}
    for member in sorted(owners):
        for p in owners[member]:
            p = int(p)
            if p < 0 or p >= n_partitions:
                violations.append(
                    f"{member} claims out-of-range partition {p} "
                    f"(n_partitions={n_partitions})")
                continue
            if p in seen:
                violations.append(
                    f"partition {p} owned by both {seen[p]} and {member}")
            else:
                seen[p] = member
    for p in range(int(n_partitions)):
        if p not in seen:
            violations.append(f"partition {p} has no owner")
    return violations


# -- champion parity -------------------------------------------------------
def check_fingerprint_parity(fingerprints: Mapping[str, str | None]
                             ) -> dict[str, Any]:
    """Fleet-wide champion parity from ``{member: fingerprint | None}``.

    The majority fingerprint is the fleet champion (ties break
    lexicographically — deterministic, so every member quarantines the
    SAME side of a 50/50 split); members serving anything else are
    ``stale`` and must self-quarantine to the rules tier (fleet/member.py
    FleetParityGate). ``None`` fingerprints are ``unknown`` — a member
    that has not published yet is NOT stale (quarantining members during
    warm-up would flap the whole fleet at every cold start)."""
    known = {m: fp for m, fp in fingerprints.items() if fp}
    if not known:
        return {"majority": None, "stale": [], "unknown":
                sorted(fingerprints), "parity": True}
    counts: dict[str, int] = {}
    for fp in known.values():
        counts[fp] = counts.get(fp, 0) + 1
    majority = sorted(counts, key=lambda fp: (-counts[fp], fp))[0]
    stale = sorted(m for m, fp in known.items() if fp != majority)
    unknown = sorted(m for m, fp in fingerprints.items() if not fp)
    return {
        "majority": majority,
        "stale": stale,
        "unknown": unknown,
        "parity": not stale,
    }


# -- fleet accounting ------------------------------------------------------
def check_member_accounting(counters: Mapping[str, Mapping[str, int]]
                            ) -> list[str]:
    """Per-member conservation: incoming == routed + shed + errors, and
    the same law over the fleet-aggregated sums. ``counters`` maps
    ``{member: {incoming, routed, shed, errors}}``. Returns violations
    (empty == conserved). This is the scraped-counter view — it can only
    be asserted for members that are still alive to scrape; the durable
    per-tx view under a hard kill is ``check_ledger_conservation``."""
    violations: list[str] = []
    totals = {"incoming": 0, "routed": 0, "shed": 0, "errors": 0}
    for member in sorted(counters):
        c = counters[member]
        inc = int(c.get("incoming", 0))
        out = (int(c.get("routed", 0)) + int(c.get("shed", 0))
               + int(c.get("errors", 0)))
        for k in totals:
            totals[k] += int(c.get(k, 0))
        if inc != out:
            violations.append(
                f"{member}: incoming {inc} != routed+shed+errors {out}")
    agg_out = totals["routed"] + totals["shed"] + totals["errors"]
    if totals["incoming"] != agg_out:
        violations.append(
            f"fleet: incoming {totals['incoming']} != "
            f"routed+shed+errors {agg_out}")
    return violations


def check_ledger_conservation(
    produced: Iterable[str],
    ledger: Iterable[Mapping[str, Any]],
) -> dict[str, Any]:
    """Durable per-transaction conservation over the fleet ledger.

    ``produced`` is every transaction id sent into the bus; ``ledger``
    is the FleetLedgerTap stream — one entry per terminal disposition,
    each carrying ``tx``, ``member`` and the bus group ``epoch`` it was
    routed under. The law, under at-least-once delivery with an epoch
    fence:

      * no drop:  every produced tx has >= 1 disposition;
      * no ghost: every ledger tx was actually produced;
      * no same-epoch double-route: within one epoch each partition has
        exactly one owner, so a tx disposed twice under ONE epoch means
        the fence failed. Cross-epoch duplicates are legitimate
        at-least-once redeliveries (a fenced batch re-reading from the
        committed offset) — counted, never violations.
    """
    produced_set = set(produced)
    seen: dict[str, set[tuple[Any, Any]]] = {}
    same_epoch_dupes: list[str] = []
    epoch_routes: dict[tuple[str, Any], int] = {}
    for e in ledger:
        tx = str(e["tx"])
        seen.setdefault(tx, set()).add((e.get("member"), e.get("epoch")))
        key = (tx, e.get("epoch"))
        epoch_routes[key] = epoch_routes.get(key, 0) + 1
        if epoch_routes[key] == 2:  # report once per offending (tx, epoch)
            same_epoch_dupes.append(
                f"tx {tx} disposed {'>'}1x under epoch {e.get('epoch')}")
    dropped = sorted(produced_set - set(seen))
    ghosts = sorted(set(seen) - produced_set)
    redelivered = sum(1 for routes in seen.values() if len(
        {ep for _, ep in routes}) > 1)
    return {
        "produced": len(produced_set),
        "disposed": len(seen),
        "dropped": dropped,
        "ghosts": ghosts,
        "same_epoch_dupes": same_epoch_dupes,
        "cross_epoch_redeliveries": redelivered,
        "conserved": not dropped and not ghosts and not same_epoch_dupes,
    }


# -- admission shares ------------------------------------------------------
def admission_share(global_ceiling: int, n_live: int) -> int:
    """Per-member admission ceiling under the fleet-wide bound: an equal
    split of the global ceiling over live members, floor 1. N-1 survivors
    of a member death RAISE their share (they absorb the dead member's
    partitions and its traffic); a rejoin lowers it back."""
    return max(1, int(global_ceiling) // max(1, int(n_live)))


# -- multihost drill invariants ----------------------------------------------
def check_multihost_reports(
    reports: list[Mapping[str, Any]],
    n_processes: int,
    local_devices: int,
    model_parallel: int,
    local_rows: int = LOCAL_ROWS_DEFAULT,
) -> dict[str, bool]:
    """The multihost drill's per-topology invariants as a pure function
    over the child-process reports (one per process: its counts, input
    fingerprint, losses, score mean and ring-vs-dense attention delta).
    Caller guarantees ``len(reports) == n_processes > 0``."""
    rs = sorted(reports, key=lambda r: r["process_id"])
    r0 = rs[0]
    return {
        "counts": all(
            r["process_count"] == n_processes
            and r["global_devices"] == n_processes * local_devices
            and r["local_devices"] == local_devices
            for r in rs
        ),
        # different inputs per process...
        "distinct_inputs": len(
            {r["input_fingerprint"] for r in rs}) == n_processes,
        # ...yet identical replicated losses: the cross-process
        # all-reduce really happened, every step
        "losses_agree": all(r["losses"] == r0["losses"] for r in rs),
        "losses_finite": all(
            l == l and abs(l) != float("inf")
            for r in rs for l in r["losses"]
        ),
        "score_means_agree": all(
            r["score_mean"] == r0["score_mean"] for r in rs
        ),
        "global_batch": r0["global_batch"] == local_rows * n_processes,
        # exact attention over a ring whose edges cross the process
        # boundary: parity vs dense computed in the same step
        "ring_crosses_processes": all(
            r["ring_positions"] == n_processes * local_devices
            // model_parallel for r in rs
        ),
        "ring_parity": all(
            r["ring_vs_dense_max_delta"] < 1e-4 for r in rs
        ),
        "ring_agree": len(
            {r["ring_vs_dense_max_delta"] for r in rs}) == 1,
    }
