"""The port's device telemetry against the reference's
(observability/device.py).

The same seeded ``record_h2d`` / ``record_h2d_failure`` sequence gives equal
byte totals, failure counts, transfer digests and ``ccfd_h2d_seconds``
histograms on both sides (tolerance: none). On the CPU the port's Scorer
stages through ``timed_copy``: one copy a dispatch of the bf16 rows, two on
the int8 wire (q and scale, as the reference's two puts), each counted with
its exact byte size; a copy that raises counts as a failure. The executable
inventory names each warmed kernel × bucket; without CUDA the memory
section is empty (the card's memory is read on the card by the smoke).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.observability import device as ref_device
from ccfd_tpu_torch.metrics.prom import Registry as PortRegistry
from ccfd_tpu_torch.observability import device as port_device
from tests.torch_helpers import mlp_tree

BUCKETS = (16, 128, 1024)


def _feed(mod, reg_cls):
    reg = reg_cls()
    tel = mod.DeviceTelemetry(registry=reg)
    rng = np.random.default_rng(9)
    for _ in range(2000):
        r = rng.random()
        if r < 0.05:
            tel.record_h2d_failure()
        elif r < 0.15:
            tel.record_h2d(int(rng.integers(1, 1 << 20)))  # bytes only
        else:
            tel.record_h2d(int(rng.integers(1, 1 << 20)), float(rng.lognormal(-9, 1.5)))
    h = reg.get("ccfd_h2d_seconds")
    return {"bytes": tel.h2d_bytes(), "count": tel.h2d_count(),
            "failures": tel.h2d_failures(), "digest": tel.h2d_digest().to_dict(),
            "hist": (h.total_count(), round(h.sum(), 12), [h.count_le(b) for b in
                                                            ref_device.H2D_BUCKETS]),
            "counter": reg.get("ccfd_h2d_bytes_total").total(),
            "fail_counter": reg.get("ccfd_h2d_put_failures_total").total()}


def test_same_records_same_digest():
    assert _feed(port_device, PortRegistry) == _feed(ref_device, RefRegistry)


def _scorer(model: str, params, q8_wire: str = "int8"):
    from ccfd_tpu_torch.serving.scorer import Scorer

    tel = port_device.DeviceTelemetry(registry=PortRegistry())
    sc = Scorer(model_name=model, params=params, batch_sizes=BUCKETS, device="cpu",
                q8_wire=q8_wire, telemetry=tel)
    tel.register_executable_source("scorer", sc.executable_grid)
    sc.warmup()
    return sc, tel


@pytest.fixture(scope="module")
def tree():
    X = np.random.default_rng(0).normal(size=(256, 30)).astype(np.float32)
    return mlp_tree(X, hidden=64)


@pytest.mark.parametrize("model,wire,per_row,copies,kernel", [
    ("mlp", "int8", 30 * 2, 1, "fused_mlp_bf16"),             # bf16 rows
    ("mlp_q8", "int8", 30 + 4, 2, "fused_mlp_q8_preq"),       # int8 q + f32 scale
    ("mlp_q8", "f32", 30 * 4, 1, "fused_mlp_q8"),             # f32 rows
])
def test_scorer_copies_are_counted_exactly(tree, model, wire, per_row, copies, kernel):
    from ccfd_tpu_torch.ops import quant

    params = quant.quantize_mlp(tree) if model == "mlp_q8" else tree
    sc, tel = _scorer(model, params, wire)
    warm_bytes = sum(BUCKETS) * per_row
    assert tel.h2d_bytes() == warm_bytes and tel.h2d_count() == copies * len(BUCKETS)
    x = np.random.default_rng(1).normal(size=(300, 30)).astype(np.float32)
    sc.score(x)  # one 1,024-row bucket
    sc.score(x[:5])  # one 16-row bucket
    assert tel.h2d_bytes() == warm_bytes + (1024 + 16) * per_row
    assert tel.h2d_count() == copies * (len(BUCKETS) + 2)
    inv = tel.snapshot()
    assert inv["memory"] == {} or torch.cuda.is_available()
    grid = inv["executables"]["scorer"]
    assert grid["kernel"] == kernel and grid["warmed"] == list(BUCKETS)
    assert grid["dispatches"] == {"16": 1, "1024": 1}
    assert inv["h2d"]["bytes_total"] == tel.h2d_bytes()


def test_a_failed_copy_is_counted_and_raises():
    tel = port_device.DeviceTelemetry(registry=PortRegistry())

    class Broken:
        def numel(self):
            return 4

        def element_size(self):
            return 4

        def to(self, *a, **k):
            raise RuntimeError("copy failed")

    with pytest.raises(RuntimeError, match="copy failed"):
        port_device.timed_copy(tel, Broken(), torch.device("cpu"))
    assert tel.h2d_failures() == 1 and tel.h2d_bytes() == 0
    assert tel.registry.get("ccfd_h2d_put_failures_total").total() == 1
    # without a plane nothing is timed or counted
    t = torch.ones(3)
    out, tok = port_device.timed_copy(None, t, torch.device("cpu"))
    assert tok is None and out is t
    port_device.settle_copies(None, [tok])


def test_decision_plane_registers_its_grid(tree):
    from ccfd_tpu_torch.router.rules import default_rules
    from ccfd_tpu_torch.serving.fused import FusedDecisionScorer

    sc, tel = _scorer("mlp", tree)
    fds = FusedDecisionScorer(sc, default_rules(0.5))
    fds.warmup()
    tel.register_executable_source("fused_decision", fds.executable_grid)
    before = tel.h2d_count()
    fds.decide(np.zeros((20, 30), np.float32))
    grid = tel.executable_inventory()["fused_decision"]
    assert grid["kernel"] == "fused_mlp_bf16" and grid["warmed"] == list(BUCKETS)
    assert tel.h2d_count() == before + 1  # the plane's staging copy is timed too
