"""The port's fleet protocol (ccfd_tpu_torch/fleet/protocol.py) against the
reference's (ccfd_tpu/fleet/protocol.py).

Every function of the protocol gets the same inputs in both packages and
must return equal outputs (exact: these are pure functions over ints,
strings and floats). The cases are the sixteen scenarios of
tests/test_fleet_protocol.py, each with the reference test's own
assertion held on the port's output, plus seeded random membership,
ownership, fingerprint, accounting and ledger inputs drawn with numpy.
"""

from __future__ import annotations

import numpy as np
import pytest

from ccfd_tpu.fleet import protocol as ref
from ccfd_tpu_torch.fleet import protocol as port


def _entry(tx, member="m00", epoch=1):
    return {"tx": tx, "member": member, "epoch": epoch}


def _report(pid, n_proc=2, local=4, fingerprint=None, losses=(0.7, 0.6),
            score_mean=0.5, ring_delta=1e-6, local_rows=64):
    return {
        "process_id": pid, "process_count": n_proc,
        "global_devices": n_proc * local, "local_devices": local,
        "input_fingerprint": fingerprint if fingerprint is not None else 100.0 + pid,
        "losses": list(losses), "score_mean": score_mean,
        "global_batch": local_rows * n_proc, "ring_positions": n_proc * local // 2,
        "ring_vs_dense_max_delta": ring_delta,
    }


def _mutated(field_update):
    reports = [_report(0), _report(1)]
    reports[1].update(field_update)
    return reports


MH = dict(n_processes=2, local_devices=4, model_parallel=2, local_rows=64)

# (id, function name, args, kwargs, check on the port's output)
SCENARIOS = [
    ("live_members_lease_window_boundary", "live_members",
     ({"m00": 10.0, "m01": 7.0, "m02": 6.9},), {"now": 10.0, "ttl_s": 3.0},
     lambda out: out == ["m00", "m01"]),
    ("live_members_after_expiry", "live_members",
     ({"m00": 10.0, "m01": 7.0, "m02": 6.9},), {"now": 13.0, "ttl_s": 3.0},
     lambda out: out == ["m00"]),
    ("elect_aggregator_deterministic_and_stable_under_death", "elect_aggregator",
     (["m01", "m02"],), {}, lambda out: out == "m01"),
    ("plan_partition_assignment_round_robin", "plan_partition_assignment",
     (["m01", "m00"], 4), {}, lambda out: out == {0: "m00", 1: "m01", 2: "m00", 3: "m01"}),
    ("disjoint_ownership_accepts_exact_cover", "check_disjoint_ownership",
     ({"m00": [0, 2], "m01": [1, 3]}, 4), {}, lambda out: out == []),
    ("disjoint_ownership_flags_double_route_precursor", "check_disjoint_ownership",
     ({"m00": [0, 1], "m01": [1]}, 2), {}, lambda out: any("owned by both" in v for v in out)),
    ("disjoint_ownership_flags_orphan_and_out_of_range", "check_disjoint_ownership",
     ({"m00": [0, 9]}, 3), {},
     lambda out: any("no owner" in v for v in out) and any("out-of-range" in v for v in out)),
    ("fingerprint_parity_majority_and_stale", "check_fingerprint_parity",
     ({"m00": "aaa", "m01": "aaa", "m02": "bbb"},), {},
     lambda out: out["majority"] == "aaa" and out["stale"] == ["m02"] and not out["parity"]),
    ("fingerprint_parity_tie_breaks_lexicographically", "check_fingerprint_parity",
     ({"m00": "bbb", "m01": "aaa"},), {},
     lambda out: out["majority"] == "aaa" and out["stale"] == ["m00"]),
    ("fingerprint_parity_unknown_is_not_stale", "check_fingerprint_parity",
     ({"m00": "aaa", "m01": None},), {},
     lambda out: out["stale"] == [] and out["unknown"] == ["m01"] and out["parity"]),
    ("member_accounting_conserves_and_aggregates", "check_member_accounting",
     ({"m00": {"incoming": 10, "routed": 8, "shed": 0, "errors": 0}},), {},
     lambda out: any("m00" in v for v in out) and any(v.startswith("fleet:") for v in out)),
    ("ledger_conservation_clean_run", "check_ledger_conservation",
     (["a", "b"], [_entry("a"), _entry("b", member="m01")]), {},
     lambda out: out["conserved"] and out["produced"] == out["disposed"] == 2),
    ("ledger_conservation_flags_drop_and_ghost", "check_ledger_conservation",
     (["a", "b"], [_entry("a"), _entry("c")]), {},
     lambda out: out["dropped"] == ["b"] and out["ghosts"] == ["c"] and not out["conserved"]),
    ("ledger_same_epoch_dupe_is_violation_cross_epoch_is_not", "check_ledger_conservation",
     (["a"], [_entry("a", epoch=1), _entry("a", member="m01", epoch=2)]), {},
     lambda out: out["conserved"] and out["cross_epoch_redeliveries"] == 1),
    ("admission_share_redistributes_on_membership_change", "admission_share",
     (120, 2), {}, lambda out: out == 60),
    ("multihost_reports_all_green", "check_multihost_reports",
     ([_report(0), _report(1)],), MH, lambda out: out == {k: True for k in out}),
] + [
    (f"multihost_reports_catch_{failing}", "check_multihost_reports",
     (_mutated(update),), MH, lambda out, failing=failing: out[failing] is False)
    for update, failing in (
        ({"input_fingerprint": 100.0}, "distinct_inputs"),
        ({"losses": [0.7, 0.61]}, "losses_agree"),
        ({"losses": [float("nan"), 0.6]}, "losses_finite"),
        ({"score_mean": 0.51}, "score_means_agree"),
        ({"ring_vs_dense_max_delta": 1e-2}, "ring_parity"),
        ({"local_devices": 2, "global_devices": 4}, "counts"),
    )
]


@pytest.mark.parametrize("fn,args,kwargs,check", [s[1:] for s in SCENARIOS],
                         ids=[s[0] for s in SCENARIOS])
def test_each_scenario_equals_the_reference(fn, args, kwargs, check):
    got, want = getattr(port, fn)(*args, **kwargs), getattr(ref, fn)(*args, **kwargs)
    assert got == want
    assert check(got)


@pytest.mark.parametrize("case", [
    ("elect_aggregator", ([],), None),
    ("plan_partition_assignment", ([], 4), {}),
    ("plan_partition_assignment", (["m00"], 3), {0: "m00", 1: "m00", 2: "m00"}),
    ("live_members", ({}, 0.0, 3.0), []),
    ("admission_share", (120, 3), 40),
    ("admission_share", (120, 4), 30),
    ("admission_share", (1, 8), 1),
    ("admission_share", (100, 0), 100),
], ids=lambda c: f"{c[0]}{c[1][1:] if len(c[1]) > 1 else ''}")
def test_the_edge_cases_equal_the_reference(case):
    fn, args, expect = case
    assert getattr(port, fn)(*args) == getattr(ref, fn)(*args) == expect


@pytest.mark.parametrize("seed", range(6))
def test_seeded_random_inputs_give_the_references_outputs(seed):
    """Random fleets from a seed: lease tables, ownership claims with
    doubles and orphans, fingerprint splits with unknowns, counters with
    imbalances and ledgers with drops, ghosts and redeliveries."""
    rng = np.random.default_rng(seed)
    names = [f"m{i:02d}" for i in range(int(rng.integers(1, 7)))]
    last_seen = {n: float(rng.uniform(0, 10)) for n in names}
    now, ttl = float(rng.uniform(5, 12)), float(rng.uniform(1, 4))
    n_part = int(rng.integers(1, 9))
    owners = {n: [int(p) for p in rng.choice(n_part + 1, size=int(rng.integers(0, 4)))]
              for n in names}
    fps = {n: (None if rng.random() < 0.2 else str(rng.choice(["aaa", "bbb", "ccc"])))
           for n in names}
    counters = {n: {k: int(v) for k, v in zip(("incoming", "routed", "shed", "errors"),
                                              rng.integers(0, 20, size=4))} for n in names}
    produced = [f"tx-{i}" for i in range(40)]
    ledger = [_entry(str(rng.choice(produced + ["ghost"])), str(rng.choice(names)),
                     int(rng.integers(0, 3))) for _ in range(60)]
    for fn, args in (
        ("live_members", (last_seen, now, ttl)),
        ("elect_aggregator", (names,)),
        ("plan_partition_assignment", (names, n_part)),
        ("check_disjoint_ownership", (owners, n_part)),
        ("check_fingerprint_parity", (fps,)),
        ("check_member_accounting", (counters,)),
        ("check_ledger_conservation", (produced, ledger)),
        ("admission_share", (int(rng.integers(1, 500)), len(names))),
    ):
        assert getattr(port, fn)(*args) == getattr(ref, fn)(*args), fn


def test_the_package_exports_the_references_names():
    import ccfd_tpu.fleet as ref_pkg
    import ccfd_tpu_torch.fleet as port_pkg

    names = ("check_disjoint_ownership", "check_fingerprint_parity", "elect_aggregator",
             "live_members", "plan_partition_assignment")
    for n in names:
        assert hasattr(ref_pkg, n) and getattr(port_pkg, n) is getattr(port, n)
