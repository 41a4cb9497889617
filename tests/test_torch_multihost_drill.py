"""The port's multi-process drill (tools/torch_multihost_drill.py): two gloo
processes x four logical CPU shards, each process feeding different rows.

The mirror of the reference's drill (tools/multihost_drill.py, whose checks
live in ``fleet/protocol.py::check_multihost_reports``): the train losses
bit-identical across the processes, the global score means equal, ring
attention over the process-spanning data axis within 1e-4 of dense
attention, and every report passing the port's
``ccfd_tpu_torch/fleet/protocol.py::check_multihost_reports``. The job has
a deadline of its own (120 s): a hung rank is killed and fails this test,
not the suite.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import torch_multihost_drill as drill  # noqa: E402

from ccfd_tpu.fleet.protocol import check_multihost_reports as ref_check  # noqa: E402
from ccfd_tpu_torch.fleet.protocol import check_multihost_reports  # noqa: E402

TIMEOUT_S = 120.0


def test_two_gloo_processes_train_one_model_and_ring_across_them():
    res = drill.run_topology(drill.N_PROCESSES, drill.LOCAL_DEVICES, drill.MODEL_PARALLEL,
                             timeout_s=TIMEOUT_S)
    assert res["errors"] == [], res["errors"]
    assert res["ok"], res["checks"]
    reports = res["reports"]
    assert len(reports) == 2
    a, b = sorted(reports, key=lambda r: r["process_id"])
    assert a["input_fingerprint"] != b["input_fingerprint"]  # different rows
    assert a["losses"] == b["losses"] and len(a["losses"]) == drill.STEPS
    assert a["score_mean"] == b["score_mean"]
    assert a["ring_positions"] == 4 and a["ring_vs_dense_max_delta"] < 1e-4
    assert a["mesh_shape"] == [4, 2] and a["global_batch"] == 2 * drill.LOCAL_ROWS
    # the port's checker and the reference's agree on the same reports
    for check in (check_multihost_reports, ref_check):
        checks = check(reports, 2, drill.LOCAL_DEVICES, drill.MODEL_PARALLEL,
                       local_rows=drill.LOCAL_ROWS)
        assert all(checks.values()), checks
