"""The port's analytics engine and drift monitor against the reference's.

``ccfd_tpu_torch/analytics/engine.py`` runs the reference's two jitted
passes as torch functions (here on the CPU; on the card in the smoke's
``rollout`` (c)). The same seeded rows go through both engines.
Tolerances: row and class counts, the histograms, the extrema and the bin
edges exact; means, standard deviations, correlations and the per-class
amount sums within 1e-5 of the magnitude summed (each is a float32 sum in
another order, and a centred moment cancels terms of that size); PSI
within 1e-6 (the same float64 numpy on equal histograms).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from ccfd_tpu.analytics.engine import AnalyticsEngine as RefEngine
from ccfd_tpu.analytics.engine import DriftMonitor as RefMonitor
from ccfd_tpu.analytics.engine import Report as RefReport
from ccfd_tpu.analytics.engine import psi as ref_psi
from ccfd_tpu_torch.analytics.engine import AnalyticsEngine, DriftMonitor, Report, psi
from ccfd_tpu_torch.bus.broker import Broker
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES, NUM_FEATURES, synthetic_dataset
from ccfd_tpu_torch.metrics.prom import Registry

TOL = 1e-5


def assert_report_matches(got, want, x: np.ndarray) -> None:
    """``got`` against ``want`` at the file's tolerances, the magnitudes
    taken from the rows ``x`` in float64."""
    x64 = np.asarray(x, np.float64)
    scale_mean = np.abs(x64).mean(0)
    scale_sq = (x64 * x64).mean(0)
    assert got.n == want.n
    for k in ("min", "max", "hist", "edges", "class_counts"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert np.all(np.abs(got.mean - want.mean) <= TOL * scale_mean)
    assert np.all(np.abs(got.std**2 - want.std**2) <= TOL * scale_sq)
    # corr = cov / (std std): the covariance's terms are E|x_f x_g| in size
    denom = np.maximum(np.outer(want.std, want.std), 1e-6)
    bound = TOL * np.sqrt(np.outer(scale_sq, scale_sq)) / denom
    assert np.all(np.abs(got.corr - want.corr) <= np.maximum(bound, TOL))
    amount = np.abs(x64[:, -1]).sum()
    assert np.all(np.abs(got.amount_sum_by_class - want.amount_sum_by_class) <= TOL * amount)


@pytest.mark.parametrize("n,fraud_rate,seed", [(4000, 0.05, 0), (1017, 0.05, 0),
                                              (20000, 0.002, 3)])
def test_summarize_matches_the_references_engine(n, fraud_rate, seed):
    ds = synthetic_dataset(n=n, fraud_rate=fraud_rate, seed=seed)
    got = AnalyticsEngine(device="cpu").summarize(ds.X, ds.y)
    want = RefEngine().summarize(ds.X, ds.y)
    assert_report_matches(got, want, ds.X)
    assert got.hist.sum() == n * NUM_FEATURES
    assert got.class_counts[1] == ds.y.sum()
    d, w = got.to_dict(), want.to_dict()
    assert d["rows"] == w["rows"] and d["class_counts"] == w["class_counts"]
    assert set(d["features"]) == set(FEATURE_NAMES)


def test_summarize_without_labels_counts_every_row_legit():
    ds = synthetic_dataset(n=777, seed=1)
    got = AnalyticsEngine(device="cpu").summarize(ds.X)
    want = RefEngine().summarize(ds.X)
    assert_report_matches(got, want, ds.X)
    assert got.class_counts.tolist() == [777.0, 0.0]


def test_psi_and_window_drift_match_the_references(dataset):
    rng = np.random.default_rng(0)
    p, q = rng.integers(0, 50, size=(2, 30, 32))
    np.testing.assert_allclose(psi(p, q), ref_psi(p, q), rtol=0, atol=1e-12)
    np.testing.assert_allclose(psi(p, p), 0.0, atol=1e-9)
    port, ref = AnalyticsEngine(device="cpu"), RefEngine()
    base = port.summarize(dataset.X, dataset.y)
    shifted = dataset.X[:1024].copy()
    shifted[:, FEATURE_NAMES.index("Amount")] *= 25.0
    for window in (dataset.X[2000:3024], shifted):
        np.testing.assert_array_equal(port.window_hist(base, window),
                                      ref.window_hist(base, window))
        got, want = port.drift(base, window), ref.drift(base, window)
        assert np.max(np.abs(got - want)) <= 1e-6
    stable = port.drift(base, dataset.X[rng.permutation(dataset.n)[:1024]])
    drifted = port.drift(base, shifted)
    assert stable.max() < 0.25 < drifted[FEATURE_NAMES.index("Amount")]


def test_the_engines_metrics_are_the_references(dataset):
    regs = {"port": Registry(), "ref": None}
    from ccfd_tpu.metrics.prom import Registry as RefRegistry

    regs["ref"] = RefRegistry()
    for eng in (AnalyticsEngine(device="cpu", registry=regs["port"]),
                RefEngine(registry=regs["ref"])):
        base = eng.summarize(dataset.X[:1000], dataset.y[:1000])
        eng.drift(base, dataset.X[1000:1500])
    for name in ("summarize", "drift"):
        assert (regs["port"].counter("analytics_jobs_completed_total").value(
            labels={"job": name}) == regs["ref"].counter(
            "analytics_jobs_completed_total").value(labels={"job": name}) == 1)
    assert (regs["port"].counter("analytics_rows_processed_total").value()
            == regs["ref"].counter("analytics_rows_processed_total").value() == 1500)
    assert regs["port"].gauge("analytics_workers").value() == 1


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_side_reads_the_others_persisted_reference(dataset, tmp_path, writer):
    path = str(tmp_path / "drift_reference.npz")
    eng = (RefEngine() if writer == "ref" else AnalyticsEngine(device="cpu"))
    saved = eng.summarize(dataset.X, dataset.y)
    saved.save(path)
    loaded = (Report if writer == "ref" else RefReport).load(path)
    for k in saved._fields:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, k)),
                                      np.asarray(getattr(saved, k)), err_msg=k)


def _tx(row) -> dict:
    return {n: float(v) for n, v in zip(FEATURE_NAMES, row)}


def test_the_drift_reference_persists_across_a_restart(dataset, tmp_path):
    """The first monitor builds the baseline and saves it; a restarted
    monitor loads it without the builder, bit for bit; a reference
    monitor loads the port's file as well."""
    cfg = Config.from_env({})
    broker = Broker()
    eng = AnalyticsEngine(device="cpu")
    ref_path = str(tmp_path / "drift_reference.npz")
    built = []

    def builder():
        built.append(1)
        return eng.summarize(dataset.X, dataset.y)

    mon = DriftMonitor(cfg, broker, None, engine=eng, window=128,
                       reference_builder=builder, reference_path=ref_path)
    try:
        assert not built  # bring-up stays non-blocking
        for row in dataset.X[:256]:
            broker.produce(cfg.kafka_topic, _tx(row))
        for _ in range(5):
            mon.step()
            if mon.windows_scored:
                break
        assert built == [1] and mon.windows_scored >= 1
    finally:
        mon.stop()
    assert os.path.exists(ref_path)

    def must_not_build():
        raise AssertionError("the restart rebuilt the persisted reference")

    mon2 = DriftMonitor(cfg, Broker(), None, engine=eng, window=128,
                        reference_builder=must_not_build, reference_path=ref_path)
    from ccfd_tpu.bus.broker import Broker as RefBroker
    from ccfd_tpu.config import Config as RefConfig

    mon3 = RefMonitor(RefConfig.from_env({}), RefBroker(), None, engine=RefEngine(),
                      window=128, reference_builder=must_not_build, reference_path=ref_path)
    try:
        for m in (mon2, mon3):
            np.testing.assert_array_equal(m.reference.hist, mon.reference.hist)
            np.testing.assert_array_equal(m.reference.min, mon.reference.min)
            assert m.reference.n == mon.reference.n
        for row in dataset.X[:256]:
            mon2._broker.produce(cfg.kafka_topic, _tx(row))
        for _ in range(5):
            mon2.step()
            if mon2.windows_scored:
                break
        assert mon2.windows_scored >= 1
    finally:
        mon2.stop()
        mon3.stop()
    with pytest.raises(ValueError):
        DriftMonitor(cfg, Broker(), None, engine=eng,
                     reference_path=str(tmp_path / "missing.npz"))


def test_the_drift_monitor_scores_windows_as_the_references(dataset):
    """The same mixed-wire stream (dicts and CSV lines, the Amount scaled
    25x) through both monitors: the same windows, the same PSI gauges."""
    from ccfd_tpu.bus.broker import Broker as RefBroker
    from ccfd_tpu.config import Config as RefConfig
    from ccfd_tpu.metrics.prom import Registry as RefRegistry

    shifted = dataset.X[:512].copy()
    shifted[:, FEATURE_NAMES.index("Amount")] *= 25.0
    out = {}
    for side in ("port", "ref"):
        if side == "port":
            cfg, broker, reg = Config.from_env({}), Broker(), Registry()
            eng = AnalyticsEngine(device="cpu", registry=reg)
            mon_cls = DriftMonitor
        else:
            cfg, broker, reg = RefConfig.from_env({}), RefBroker(), RefRegistry()
            eng = RefEngine(registry=reg)
            mon_cls = RefMonitor
        ref = eng.summarize(dataset.X, dataset.y)
        mon = mon_cls(cfg, broker, ref, engine=eng, registry=reg, window=256)
        try:
            for row in shifted[:400]:
                broker.produce(cfg.kafka_topic, _tx(row))
            for row in shifted[400:]:
                broker.produce(cfg.kafka_topic, ",".join(str(float(v)) for v in row).encode())
            seen = 0
            for _ in range(20):
                seen += mon.step()
                if mon.windows_scored >= 2:
                    break
            out[side] = (mon.windows_scored, seen,
                         [reg.gauge("analytics_drift_psi").value(labels={"feature": f})
                          for f in FEATURE_NAMES],
                         reg.gauge("analytics_drift_max_psi").value())
        finally:
            mon.stop()
    assert out["port"][:2] == out["ref"][:2] == (2, 512)
    np.testing.assert_allclose(out["port"][2], out["ref"][2], rtol=0, atol=1e-6)
    assert out["port"][2][FEATURE_NAMES.index("Amount")] > 0.25
    assert abs(out["port"][3] - out["ref"][3]) <= 1e-6


def test_the_analyze_command_prints_the_references_report(capsys, monkeypatch):
    import json

    from ccfd_tpu.cli import main as ref_main
    from ccfd_tpu_torch.cli import main

    monkeypatch.delenv("CCFD_CSV", raising=False)
    assert main(["analyze", "--device", "cpu", "--drift-split", "--top-corr", "4"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert ref_main(["analyze", "--drift-split", "--top-corr", "4"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["workers"] == 1
    assert (got["rows"], got["class_counts"]) == (want["rows"], want["class_counts"])
    assert [(c["a"], c["b"]) for c in got["top_correlations"]] == [
        (c["a"], c["b"]) for c in want["top_correlations"]]
    for a, b in zip(got["top_correlations"], want["top_correlations"]):
        assert abs(a["corr"] - b["corr"]) <= 1e-4
    assert got["drift_self_check"]["worst_feature"] == want["drift_self_check"]["worst_feature"]
    assert abs(got["drift_self_check"]["max_psi"] - want["drift_self_check"]["max_psi"]) <= 1e-6
    for f in FEATURE_NAMES:
        for k in ("min", "max"):
            assert got["features"][f][k] == want["features"][f][k]


def test_the_operator_runs_the_drift_monitor_on_its_reference_file(tmp_path):
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec

    ref_file = str(tmp_path / "drift.npz")
    cr = {"spec": {
        "store": {"enabled": False}, "bus": {"partitions": 2},
        "scorer": {"enabled": True, "model": "logreg", "train_steps": 0},
        "engine": {"enabled": True}, "notify": {"enabled": False},
        "router": {"enabled": True}, "retrain": {"enabled": False},
        "producer": {"enabled": True, "transactions": 600},
        "monitoring": {"enabled": False}, "health": {"enabled": False},
        "incident": {"enabled": False}, "capacity": {"enabled": False},
        "lifecycle": {"enabled": False}, "investigator": {"enabled": False},
        "analytics": {"enabled": True, "window": 256, "nbins": 16, "interval_s": 0.05,
                      "reference_file": ref_file},
    }}
    p = Platform(PlatformSpec.from_cr(cr, cfg=Config(batch_sizes=(16, 128, 1024))),
                 device="cpu").up()
    try:
        assert "analytics" in p.supervisor.status()
        p.wait_producer(30)
        import time

        deadline = time.monotonic() + 30
        while p.analytics.windows_scored < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert p.analytics.windows_scored >= 2
        assert p.analytics.reference.hist.shape == (NUM_FEATURES, 16)
        reg = p.registries["analytics"]
        assert reg.gauge("analytics_workers").value() == 1
        assert reg.counter("analytics_jobs_completed_total").value(
            labels={"job": "drift"}) == p.analytics.windows_scored
    finally:
        p.down()
    assert RefReport.load(ref_file).hist.shape == (NUM_FEATURES, 16)
