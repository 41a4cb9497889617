"""The seq family's governed rollout, port against reference.

``tests/test_seq_lifecycle.py``'s two scenarios, run on both stacks with
the same seeded histories, labels and candidates at
``compute_dtype="float32"``, L=8: the reference's ``SeqScorer`` with its
lifecycle (``ccfd_tpu/serving/history.py``, ``ccfd_tpu/lifecycle/``) and the
port's (``ccfd_tpu_torch/serving/history.py``: the challenger slot, the
shadow tap offer and the canary gate on the resolve path; the port's
lifecycle). The champion is the reference's ``seq.init`` with a normalizer
carried across; each candidate is the reference's quantization of it (a
faithful one that passes shadow, serves a canary with rows on both arms and
is promoted, re-binding the serving graph to the int8 forward; a broken one,
head scale zeroed, that is REJECTED with the champion untouched).

Held equal: the stage after every controller step, the verdict, the
version store's stages, the breach reasons in the audit trail, and the
canary rows on each arm. Tolerances: ``host_score`` (the champion's f32
cold-context score) and ``challenger_score`` for a float challenger within
1e-5 in p of the reference's; for the int8 challenger the seq_q8 bar of
ROADMAP C (2e-2: an ulp apart in a layer norm or a GELU moves a token's
``rint(h / s)`` to the next integer on about one history in ten, in either
package's own q8 against the other's). Also here: the seq family's
``loss_fn`` against the reference's ``jax.value_and_grad`` (loss 1e-6,
each gradient leaf 1e-5 of its largest magnitude), and the operator's seq
branch of the lifecycle, no longer refused.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from ccfd_tpu_torch.params import from_jax_model_params, to_numpy
from tests import torch_helpers

_keep_logging = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)

L = 8
GUARDS = dict(min_labels=24, min_shadow_rows=512, auc_margin=0.2, max_alert_rate_delta=0.5,
              max_score_psi=0.5, min_submit_interval_s=0.0)


def _ref_params(seed: int, ds):
    import jax

    from ccfd_tpu.models import seq as seq_mod

    p = seq_mod.set_normalizer(seq_mod.init(jax.random.PRNGKey(seed)), ds.X.mean(0), ds.X.std(0))
    return jax.tree.map(np.asarray, p)


def _ref_q8(params):
    import jax

    from ccfd_tpu.ops.seq_quant import quantize_seq

    return jax.tree.map(np.asarray, quantize_seq(params))


def _broken(q8):
    """The quantization-bug shape: collapsed head scales flatten every
    logit to its bias (a constant alert)."""
    broken = {k: v for k, v in q8.items()}
    broken["head"] = dict(broken["head"])
    broken["head"]["scale"] = np.zeros_like(np.asarray(broken["head"]["scale"]))
    broken["head"]["b"] = np.asarray([4.0], np.float32)
    return broken


def _stack(pkg: str, tmp_path, params, canary_min_labels: int):
    """One package's SeqScorer with its lifecycle, wired as each package's
    operator wires a seq scorer (tap and gate set on the scorer)."""
    if pkg == "ref":
        from ccfd_tpu.bus.broker import Broker
        from ccfd_tpu.config import Config
        from ccfd_tpu.lifecycle.controller import Guardrails, LifecycleController
        from ccfd_tpu.lifecycle.evaluator import ShadowEvaluator
        from ccfd_tpu.lifecycle.shadow import ShadowTap
        from ccfd_tpu.lifecycle.versions import VersionStore
        from ccfd_tpu.metrics.prom import Registry
        from ccfd_tpu.parallel.checkpoint import CheckpointManager
        from ccfd_tpu.serving.history import SeqScorer

        scorer = SeqScorer(params, length=L, batch_sizes=(256,), compute_dtype="float32",
                           max_customers=256)
    else:
        from ccfd_tpu_torch.bus.broker import Broker
        from ccfd_tpu_torch.config import Config
        from ccfd_tpu_torch.lifecycle.controller import Guardrails, LifecycleController
        from ccfd_tpu_torch.lifecycle.evaluator import ShadowEvaluator
        from ccfd_tpu_torch.lifecycle.shadow import ShadowTap
        from ccfd_tpu_torch.lifecycle.versions import VersionStore
        from ccfd_tpu_torch.metrics.prom import Registry
        from ccfd_tpu_torch.parallel.checkpoint import CheckpointManager
        from ccfd_tpu_torch.serving.history import SeqScorer

        scorer = SeqScorer(from_jax_model_params("seq", params), length=L, batch_sizes=(256,),
                           compute_dtype="float32", max_customers=256, device="cpu")
    cfg, broker, reg = Config(), Broker(), Registry()
    store = VersionStore(None)
    ckpt = CheckpointManager(str(tmp_path / pkg / "ckpt"), keep=8)
    shadow = ShadowTap(scorer, broker, cfg.shadow_topic, reg, max_rows_per_s=0)
    ev = ShadowEvaluator(cfg, broker, scorer, reg)
    ctl = LifecycleController(cfg, scorer, store=store, checkpoints=ckpt, shadow=shadow,
                              evaluator=ev, registry=reg,
                              guardrails=Guardrails(canary_min_labels=canary_min_labels,
                                                    **GUARDS))
    scorer.shadow_tap = shadow
    scorer.canary_gate = ctl.gate
    return dict(cfg=cfg, broker=broker, reg=reg, store=store, shadow=shadow, ctl=ctl,
                scorer=scorer)


def _pump(st, X, y, trail, batches, seed, labels_per_batch=24):
    """Live traffic (warm repeating customers through ``score_with_ids``,
    so the tap sees assembled histories) and labels on the labels topic;
    the stage after each controller step goes to ``trail``."""
    from ccfd_tpu.data.ccfd import FEATURE_NAMES

    rng = np.random.default_rng(seed)
    for _ in range(batches):
        idx = rng.integers(0, len(X), size=256)
        st["scorer"].score_with_ids([{"customer_id": int(i % 64)} for i in idx], X[idx])
        st["shadow"].step()
        for j in rng.integers(0, len(X), size=labels_per_batch):
            st["broker"].produce(st["cfg"].labels_topic, {
                "transaction": dict(zip(FEATURE_NAMES, map(float, X[j]))), "label": int(y[j])})
        st["ctl"].step()
        trail.append(st["ctl"].stage)


def _is_q8(pkg, params):
    if pkg == "ref":
        from ccfd_tpu.ops.seq_quant import is_quantized
    else:
        from ccfd_tpu_torch.ops.seq_quant import is_quantized
    return is_quantized(params)


def _fingerprint(pkg, params):
    """The lineage hash of a served tree (equal across the packages for
    equal bytes)."""
    if pkg == "ref":
        import jax

        from ccfd_tpu.parallel.partition import params_fingerprint

        return params_fingerprint(jax.tree.map(np.asarray, params))
    from ccfd_tpu_torch.params import params_fingerprint

    return params_fingerprint(to_numpy(params))


def _canary_rows(st):
    c = st["reg"].counter("ccfd_lifecycle_canary_rows_total", "")
    return (c.value(labels={"arm": "champion"}), c.value(labels={"arm": "challenger"}))


def test_the_quantized_candidate_passes_shadow_serves_a_canary_and_is_promoted(tmp_path):
    from ccfd_tpu.data.ccfd import synthetic_dataset

    ds = synthetic_dataset(n=2048, fraud_rate=0.05, seed=0)
    params = _ref_params(2, ds)
    cand = _ref_q8(params)
    out = {}
    for pkg in ("ref", "port"):
        st = _stack(pkg, tmp_path, params, canary_min_labels=8)
        c = cand if pkg == "ref" else from_jax_model_params("seq_q8", cand)
        v = st["ctl"].submit_candidate(c, label_watermark=1)
        assert st["scorer"].challenger_version == v
        trail = []
        _pump(st, ds.X, ds.y, trail, batches=3, seed=0)
        _pump(st, ds.X, ds.y, trail, batches=2, seed=7)
        rows = _canary_rows(st)
        assert rows[0] > 0 and rows[1] > 0, (pkg, rows)
        for _ in range(4):
            st["ctl"].step()
            trail.append(st["ctl"].stage)
        assert st["ctl"].champion == v and st["store"].get(v).stage == "CHAMPION"
        assert _is_q8(pkg, st["scorer"].params)
        assert st["scorer"].challenger_version is None
        p = st["scorer"].score(ds.X[:16], ids=[int(i % 4) for i in range(16)])
        assert p.shape == (16,) and np.isfinite(p).all()
        out[pkg] = dict(trail=trail, rows=rows, v=v,
                        stages=[(x.version, x.stage) for x in st["store"].versions()],
                        hash=st["store"].get(v).checkpoint_hash)
    assert out["port"]["trail"] == out["ref"]["trail"]
    assert out["port"]["stages"] == out["ref"]["stages"]
    assert out["port"]["v"] == out["ref"]["v"]
    # the lineage hash of the promoted int8 tree is the reference's
    assert out["port"]["hash"] == out["ref"]["hash"]


def test_a_broken_quantization_is_rejected_and_the_champion_untouched(tmp_path):
    from ccfd_tpu.data.ccfd import synthetic_dataset

    ds = synthetic_dataset(n=2048, fraud_rate=0.05, seed=1)
    params = _ref_params(3, ds)
    broken = _broken(_ref_q8(params))
    out = {}
    for pkg in ("ref", "port"):
        st = _stack(pkg, tmp_path, params, canary_min_labels=0)
        before = _fingerprint(pkg, st["scorer"].params)
        c = broken if pkg == "ref" else from_jax_model_params("seq_q8", broken)
        v = st["ctl"].submit_candidate(c, label_watermark=2)
        trail = []
        _pump(st, ds.X, ds.y, trail, batches=3, seed=1)
        assert st["store"].get(v).stage == "REJECTED" and st["ctl"].champion != v
        assert not _is_q8(pkg, st["scorer"].params)
        assert st["scorer"].challenger_version is None
        audit = st["store"].audit_trail(v)
        rejected = [e for e in audit if "REJECTED" in str(e)]
        assert rejected, audit
        assert _fingerprint(pkg, st["scorer"].params) == before
        out[pkg] = dict(trail=trail, champion=before,
                        reasons=[e.get("reasons") or e.get("reason")
                                 for e in rejected if isinstance(e, dict)])
    assert out["port"]["trail"] == out["ref"]["trail"]
    assert out["port"]["reasons"] == out["ref"]["reasons"]
    assert out["port"]["champion"] == out["ref"]["champion"]


@pytest.fixture(scope="module")
def slots():
    """Both scorers with the same champion and the same histories stored."""
    from ccfd_tpu.data.ccfd import synthetic_dataset
    from ccfd_tpu.serving.history import SeqScorer as RefSeqScorer
    from ccfd_tpu_torch.serving.history import SeqScorer

    ds = synthetic_dataset(n=1024, fraud_rate=0.05, seed=4)
    params = _ref_params(5, ds)
    ref = RefSeqScorer(params, length=L, batch_sizes=(64, 256), compute_dtype="float32",
                       max_customers=256)
    port = SeqScorer(from_jax_model_params("seq", params), length=L, batch_sizes=(64, 256),
                     compute_dtype="float32", max_customers=256, device="cpu")
    rng = np.random.default_rng(9)
    for _ in range(4):
        idx = rng.integers(0, len(ds.X), size=200)
        ids = [int(i % 40) for i in idx]
        np.testing.assert_allclose(port.score(ds.X[idx], ids), ref.score(ds.X[idx], ids),
                                   rtol=0, atol=1e-5)
    return ds, params, ref, port


def test_host_score_matches_the_references(slots):
    ds, _params, ref, port = slots
    x = ds.X[:300]
    got, want = port.host_score(x), ref.host_score(x)
    assert got.shape == (300,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["float", "q8"])
def test_challenger_score_matches_the_references(slots, kind):
    ds, params, ref, port = slots
    if kind == "float":
        rng = np.random.default_rng(11)
        import jax

        chall = jax.tree.map(
            lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
            if a.dtype == np.float32 and a.ndim == 2 else a, params)
        tol = 1e-5
    else:
        chall = _ref_q8(params)
        tol = 2e-2  # the seq_q8 bar (module docstring; ROADMAP C)
    ref.install_challenger(7, chall)
    port.install_challenger(7, from_jax_model_params("seq" if kind == "float" else "seq_q8",
                                                     chall))
    try:
        assert port.challenger_version == ref.challenger_version == 7
        rng = np.random.default_rng(3)
        rows = ds.X[:300]
        hists = rng.normal(size=(70, L, 30)).astype(np.float32)
        for x in (rows, hists, hists[:, -3:]):
            got, want = port.challenger_score(x), ref.challenger_score(x)
            assert got.shape == (len(x),) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
            # the q8 gap is a few rows' rint flips, not a drift of every row
            assert (np.abs(got - want) <= 1e-5).mean() >= 0.9
        port.clear_challenger(version=8)  # another version: kept
        assert port.challenger_version == 7
    finally:
        port.clear_challenger()
        ref.clear_challenger()
    assert port.challenger_version is None
    with pytest.raises(RuntimeError, match="no challenger"):
        port.challenger_score(ds.X[:4])


def test_the_tap_is_offered_pure_champion_scores_and_the_gate_rescores_the_same_contexts():
    """The resolve path's lane: with the tap armed each assembled chunk's
    full-L histories go to the tap with the champion's scores (before any
    canary override); an active gate re-scores its masked rows through the
    challenger on those same histories."""
    from ccfd_tpu.data.ccfd import synthetic_dataset
    from ccfd_tpu_torch.serving.history import SeqScorer

    ds = synthetic_dataset(n=600, fraud_rate=0.05, seed=6)
    params = from_jax_model_params("seq", _ref_params(7, ds))
    scorer = SeqScorer(params, length=L, batch_sizes=(64,), compute_dtype="float32",
                       max_customers=64, device="cpu")
    plain = SeqScorer(params, length=L, batch_sizes=(64,), compute_dtype="float32",
                      max_customers=64, device="cpu")
    offered, rescored = [], []

    class Tap:
        armed_version = 3

        def offer(self, hist, proba):
            offered.append((np.array(hist), np.array(proba)))

    class Gate:
        active = True

        def apply(self, x, proba, rescore):
            mask = np.zeros(len(x), bool)
            mask[::3] = True
            alt = rescore(mask)
            rescored.append((mask, alt))
            out = proba.copy()
            out[mask] = alt
            return out

    scorer.install_challenger(3, params)  # the champion's own tree: same scores
    scorer.shadow_tap, scorer.canary_gate = Tap(), Gate()
    ids = [int(i % 20) for i in range(150)]
    got = scorer.score(ds.X[:150], ids)
    want = plain.score(ds.X[:150], ids)
    # 150 rows over a 64-row ladder: three assembled chunks, each offered
    assert [len(h) for h, _ in offered] == [64, 64, 22]
    np.testing.assert_array_equal(np.concatenate([p for _, p in offered]), want)
    assert all(h.shape[1:] == (L, 30) for h, _ in offered)
    (mask, alt), = rescored
    assert len(alt) == int(mask.sum())
    np.testing.assert_allclose(alt, want[mask], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # idle (tap disarmed, gate inactive): no history kept, no rescore
    Tap.armed_version, Gate.active = None, False
    offered.clear()
    scorer.score(ds.X[150:200], ids[:50])
    assert offered == [] and len(rescored) == 1


def test_seq_loss_fn_and_its_gradients_match_the_references():
    import jax
    import jax.numpy as jnp

    from ccfd_tpu.data.ccfd import synthetic_dataset
    from ccfd_tpu.models import seq as ref_seq
    from ccfd_tpu_torch.models import seq as port_seq
    from ccfd_tpu_torch.params import tree_map

    ds = synthetic_dataset(n=256, fraud_rate=0.1, seed=8)
    params = _ref_params(8, ds)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, L, 30)).astype(np.float32)
    y = (rng.uniform(size=32) < 0.3).astype(np.float32)
    ref_loss, ref_grad = jax.value_and_grad(ref_seq.loss_fn)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y), 8.0, jnp.float32)
    tp = tree_map(lambda a: a.clone().requires_grad_(a.is_floating_point()),
                  from_jax_model_params("seq", params))
    loss = port_seq.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y), 8.0, torch.float32)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-6
    got = tree_map(lambda a: a.grad.numpy() if a.grad is not None else np.zeros(a.shape), tp)
    want = jax.tree.map(np.asarray, ref_grad)
    flat_got, flat_want = to_numpy(got), want

    def leaves(t, prefix=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{prefix}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, np.asarray(t)

    g, w = dict(leaves(flat_got)), dict(leaves(flat_want))
    assert set(g) == set(w)
    for k in w:
        scale = max(float(np.abs(w[k]).max()), 1e-12)
        assert float(np.abs(g[k] - w[k]).max()) <= 1e-5 * scale, k
    # the registry entry stays untrainable, as the reference's
    from ccfd_tpu_torch.models.registry import get_model

    assert get_model("seq").trainable is False and get_model("seq_q8").trainable is False


def _seq_cr(tmp_path, **blocks):
    spec = {
        "store": {"enabled": False}, "bus": {"partitions": 2},
        "scorer": {"enabled": True, "model": "seq", "history_length": L},
        "engine": {"enabled": True}, "notify": {"enabled": False}, "router": {"enabled": True},
        "retrain": {"enabled": False}, "producer": {"enabled": False},
        "monitoring": {"enabled": False}, "health": {"enabled": False},
        "analytics": {"enabled": False}, "heal": {"enabled": False},
        "incident": {"enabled": False}, "capacity": {"enabled": False},
        "lifecycle": {"enabled": True, "state_dir": str(tmp_path / "lc")},
        # plain logs, so the warning reaches caplog
        "tracing": {"json_logs": False},
    }
    spec.update(blocks)
    return {"spec": spec}


@pytest.mark.parametrize("model", ["seq", "seq_q8"])
def test_the_operator_governs_a_seq_scorer(tmp_path, caplog, model):
    """``lifecycle`` under a seq scorer comes up (no longer refused): the
    tap and the gate are set on the SeqScorer, the router's score lane is
    the scorer object itself, and a ladder of more than one rung warns as
    the reference's operator does. Retrain and the decision plane under
    seq stay refused."""
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.platform.operator import Platform, PlatformSpec
    from ccfd_tpu_torch.serving.history import SeqScorer

    cfg = Config.from_env({"CCFD_BATCH_SIZES": "16,128", "CCFD_NATIVE_FRONT": "0",
                           "CCFD_SEQ_LEN_BUCKETS": "4"})
    cr = _seq_cr(tmp_path)
    cr["spec"]["scorer"]["model"] = model
    assert PlatformSpec.from_cr(cr, cfg=cfg).refused() == []
    with caplog.at_level(logging.WARNING, logger="ccfd_tpu_torch"):
        p = Platform(PlatformSpec.from_cr(cr, cfg=cfg), device="cpu").up()
    try:
        assert isinstance(p.scorer, SeqScorer) and p.lifecycle is not None
        assert p.scorer.shadow_tap is not None
        assert p.scorer.canary_gate is p.lifecycle.gate
        assert len(p.scorer.len_buckets) > 1
        assert any("len_buckets" in r.getMessage() for r in caplog.records)
        assert p.scorer.challenger_version is None
    finally:
        p.down()
    for blocks, match in (({"retrain": {"enabled": True}}, "retrain with scorer.model"),
                          ({"scorer": {"enabled": True, "model": model,
                                       "fused_decision": True}},
                           "scorer.fused_decision with scorer.model")):
        refused = PlatformSpec.from_cr(_seq_cr(tmp_path, **blocks), cfg=cfg).refused()
        assert any(match in r for r in refused), refused
