"""A whole run of the keyed stream cell (``benchmark/pending/``) on the CPU
(the harness's look for a card skipped) at a size the CPU runs in seconds:
the platform as ``up`` builds it on the cell's CR, its bus fed by the
benchmark's producer, its decisions read back and judged against the plain
reference. Sound, it reads ``correct: true``; with the timed path broken
underneath it reads ``correct: false``: the control (the reference one
precision step below) in the seq launches' place, an answer altered where
the scorer produces it, a quarter of the decisions never recorded, and every
decision routed by the rules tier. The cell has no training step and no
exchange between chips. Also: a mix kind with no driver raises and names the
file it looked for.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark.harness import runner, spec
from benchmark.reference import seq

BENCH = spec.with_pending(spec.load_benchmark())
CELLS = [w["name"] for w in BENCH["workloads"]
         if spec.resolve(BENCH, w["name"]).mix["kind"] == "keyed_stream"]
# a few hundred records over 512 customers, so some customers send several
SMALL = {"rate_per_s": 200.0, "warmup_s": 0.5, "customers": 512}
# the control's widest gap grows with the decisions compared
CONTROL_SIZE = {"rate_per_s": 400.0, "warmup_s": 0.5, "customers": 512}


@pytest.fixture(autouse=True)
def small_grid(monkeypatch):
    """The seq scorer's batch buckets cut to two, so its warm-up is short."""
    monkeypatch.setenv("CCFD_BATCH_SIZES", "16,128")


def _run(cell_name: str, trace: bool = False, size: dict = SMALL,
         seconds: float = 2.0) -> dict:
    cell = spec.resolve(BENCH, cell_name)
    cell.mix.update(size)
    return runner.run_cell(cell, 2 ** 31 + 17, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_stream_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 100 and res["failed"] == 0
    assert res["checks"]["failed_share"]["value"] == 0.0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_stream_run_reads_its_host_layers(cell):
    """On the CPU the device trace holds nothing; the counters still read."""
    res = _run(cell, trace=True)
    assert res["correct"], res["checks"]
    host = {"router.rows_per_dispatch.stream", "seq.assembly_ms_per_batch.stream"}
    assert host <= set(res["metrics"])
    assert res["metrics"]["router.rows_per_dispatch.stream"]["value"] >= 1.0
    assert res["breakdown"]["device_ops"] == [] and res["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_seq_launches_place_is_not_correct(cell):
    from benchmark import control

    c = spec.resolve(BENCH, cell)
    with control.in_place(c.config, c.mix["kind"]):
        res = _run(cell, size=CONTROL_SIZE, seconds=3.0)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert not res["correct"]
    assert res["checks"]["p_gap"]["value"] > res["checks"]["p_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(cell, monkeypatch):
    """The seq scorer hands back 1 - p on the first row of every batch."""
    from ccfd_tpu_torch.serving.history import SeqScorer

    orig = SeqScorer.score

    def score(self, x, ids=None):
        out = orig(self, x, ids)
        if len(out):
            out[0] = 1.0 - out[0]
        return out

    monkeypatch.setattr(SeqScorer, "score", score)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["p_gap"]["value"] > res["checks"]["p_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_quarter_of_the_decisions_left_out_is_not_correct(cell, monkeypatch):
    """Every fourth decision of each routed batch is never recorded."""
    from ccfd_tpu_torch.observability.audit import AuditLog

    orig = AuditLog.record_batch

    def record_batch(self, rows, **kw):
        return orig(self, [r for i, r in enumerate(rows) if i % 4 != 3], **kw)

    monkeypatch.setattr(AuditLog, "record_batch", record_batch)
    res = _run(cell)
    assert not res["correct"]
    share = res["checks"]["failed_share"]
    assert share["value"] > share["limit"] and res["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_decision_stamped_after_the_router_counted_it_is_waited_for(cell, monkeypatch):
    """The router counts a batch as routed before it stamps the batch's
    decision records: the batch holding the run's last record stamps them
    a second late, and the run still reads every answer."""
    from ccfd_tpu_torch.observability.audit import AuditLog

    last = int(round(SMALL["rate_per_s"] * (SMALL["warmup_s"] + 2.0))) - 1
    orig = AuditLog.record_batch

    def record_batch(self, rows, **kw):
        if any(r.get("tx") == last for r in rows):
            time.sleep(1.0)
        return orig(self, rows, **kw)

    monkeypatch.setattr(AuditLog, "record_batch", record_batch)
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["checks"]["failed_share"]["value"] == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_decisions_of_the_rules_tier_are_not_correct(cell, monkeypatch):
    """The heal supervisor keeps the card closed: the router's ladder routes
    every record by the rules tier."""
    from ccfd_tpu_torch.runtime.heal import DeviceSupervisor

    monkeypatch.setattr(DeviceSupervisor, "device_allowed", lambda self: False)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["failed_share"]["value"] == 1.0


def test_a_mix_kind_with_no_driver_names_the_file_it_looked_for():
    cell = spec.resolve(BENCH, CELLS[0])
    cell.mix["kind"] = "no_such_kind"
    with pytest.raises(FileNotFoundError, match=r"drivers/no_such_kind\.py"):
        runner.run_cell(cell, 1, 1.0, False, "cpu", time.perf_counter())


def test_the_reference_rebuilds_each_history_in_produce_order():
    """Customer 7's third record sees its first two before it, zero
    left-padded; another customer's records stay out."""
    rows = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    keys = np.array([7, 3, 7, 3, 7, 7])
    h = seq.histories(rows, keys, np.array([4, 1, 5]), length=4)
    assert h[0].tolist() == [[0, 0], rows[0].tolist(), rows[2].tolist(), rows[4].tolist()]
    assert h[1].tolist() == [[0, 0], [0, 0], [0, 0], rows[1].tolist()]
    assert h[2].tolist() == [rows[0].tolist(), rows[2].tolist(), rows[4].tolist(),
                             rows[5].tolist()]


def test_the_reference_holds_the_served_params_to_its_own_read():
    c = spec.resolve(BENCH, CELLS[0])
    ref = spec.reference(c.config["name"])
    with np.load(spec.ROOT / c.config["params"]) as z:
        served = {k: z[k] for k in z.files}
    ref.load(c.config, served=served)
    served["embed/b"] = served["embed/b"] + np.float32(1e-3)
    with pytest.raises(ValueError, match="other params"):
        ref.load(c.config, served=served)
