"""The port's history store and seq scorer (serving/history.py) against the
reference's, on the CPU.

- **HistoryStore.** The same seeded scripts of ``prepare`` (chunks with
  repeated and anonymous ids, with and without an overlay), ``commit``
  (in order, out of order, after a ``restore``) and ``restore`` (a
  snapshot or genesis) under a binding customer cap give equal snapshots
  after every step (keys in eviction order, buffers, depths), equal
  commit verdicts (stale generations), equal ``contended_skips`` and equal
  sizes.
- **SeqScorer.** One stream of router batches (repeat customers, anonymous
  rows, batches across chunk and bucket boundaries, the short-sequence
  ladder on and off) gives the reference's scores (1e-5 in f32; 1e-2 in
  bf16, see tests/test_torch_seq.py), the same store, and the same
  bucket, row, anonymous and stale-commit counters. ``swap_params`` to the
  int8 tree re-binds the forward to ``seq_q8`` (held against the
  reference's ``seq_q8``). A ``mesh``, a ``partitioner`` and
  ``seq_parallel`` ``ring``/``ulysses`` serve the same stream on logical
  CPU shards (A15b; tests/test_torch_partition.py and
  tests/test_torch_ring_ulysses.py hold the sharded path in depth).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ccfd_tpu.metrics.prom import Registry as RefRegistry
from ccfd_tpu.serving.history import HistoryStore as RefStore
from ccfd_tpu.serving.history import SeqScorer as RefSeqScorer
from ccfd_tpu_torch.metrics.prom import Registry
from ccfd_tpu_torch.params import from_jax_model_params
from ccfd_tpu_torch.serving.history import HistoryStore, SeqScorer
from tests import torch_helpers  # noqa: F401  (one intra-op thread)

F = 30


def _snap_equal(a: dict, b: dict) -> None:
    assert (a["version"], a["length"], a["num_features"]) == \
        (b["version"], b["length"], b["num_features"])
    assert [(k, f) for k, _, f in a["customers"]] == [(k, f) for k, _, f in b["customers"]]
    for (_, ba, _), (_, bb, _) in zip(a["customers"], b["customers"]):
        np.testing.assert_array_equal(np.asarray(ba), np.asarray(bb))


def _script(seed: int, steps: int = 60):
    """Seeded store operations: ('prep', ids, rows, use_overlay),
    ('commit', k) for the k-th outstanding token (oldest first or newest),
    ('restore', which)."""
    rng = np.random.default_rng(seed)
    keys = [f"c{i}" for i in range(9)] + list(range(5))
    ops = []
    for _ in range(steps):
        r = rng.uniform()
        if r < 0.55:
            n = int(rng.integers(1, 7))
            ids = [None if rng.uniform() < 0.15 else keys[int(rng.integers(len(keys)))]
                   for _ in range(n)]
            rows = rng.normal(size=(n, F)).astype(np.float32)
            ops.append(("prep", ids, rows, bool(rng.uniform() < 0.3)))
        elif r < 0.9:
            ops.append(("commit", int(rng.integers(0, 2))))
        else:
            ops.append(("restore", "genesis" if rng.uniform() < 0.3 else "snap"))
    return ops


def _run_store(store, ops):
    trace = []
    tokens = []
    overlay: dict = {}
    saved = None
    for op in ops:
        if op[0] == "prep":
            _, ids, rows, use_overlay = op
            hist, tok = store.prepare(list(ids), rows, overlay=overlay if use_overlay else None)
            if use_overlay:
                overlay.update(tok[1])
            else:
                overlay = {}
            tokens.append(tok)
            trace.append(("prep", hist.copy(), tok[2].copy(), sorted(map(str, tok[1]))))
        elif op[0] == "commit":
            if not tokens:
                continue
            tok = tokens.pop(0 if op[1] == 0 else -1)
            trace.append(("commit", store.commit(tok)))
        else:
            if op[1] == "snap" and saved is not None:
                store.restore(saved)
            elif op[1] == "genesis":
                store.restore(None)
            saved = store.snapshot()
            trace.append(("restore",))
        trace.append(("size", len(store), store.contended_skips))
        trace.append(("snap", store.snapshot()))
    return trace


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("stripes,cap", [(1, 5), (3, 6), (8, 100)])
def test_store_scripts_give_the_references_snapshots(seed, stripes, cap):
    ops = _script(seed)
    ref = _run_store(RefStore(length=4, max_customers=cap, stripes=stripes), ops)
    port = _run_store(HistoryStore(length=4, max_customers=cap, stripes=stripes), ops)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert a[0] == b[0]
        if a[0] == "snap":
            _snap_equal(a[1], b[1])
        elif a[0] == "prep":
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
            assert a[3] == b[3]
        else:
            assert a == b


def test_contended_and_stale_commits_match():
    def drive(store):
        rows = np.arange(3 * F, dtype=np.float32).reshape(3, F)
        _, t1 = store.prepare(["a", "b", "c"], rows)
        store.commit(t1)
        _, t2 = store.prepare(["a", "b"], rows[:2] + 1)  # derives from t1's stamps
        _, t3 = store.prepare(["b", "c"], rows[1:] + 2)
        out = [store.commit(t3), store.commit(t2), store.contended_skips]
        _, t4 = store.prepare(["a"], rows[:1])
        snap = store.snapshot()
        store.restore(snap)
        out += [store.commit(t4), store.contended_skips]  # stale generation
        return out, store.snapshot()

    (r, rs), (p, ps) = drive(RefStore(length=3)), drive(HistoryStore(length=3))
    assert r == p == [True, True, 1, False, 1]
    _snap_equal(rs, ps)


def test_restore_accepts_the_json_form_and_refuses_a_bad_shape():
    store = HistoryStore(length=2)
    _, tok = store.prepare(["k"], np.ones((1, F), np.float32))
    store.commit(tok)
    snap = store.snapshot()
    js = {**snap, "customers": [[k, np.asarray(b).tolist(), f] for k, b, f in snap["customers"]]}
    other = HistoryStore(length=2)
    other.restore(js)
    _snap_equal(other.snapshot(), snap)
    with pytest.raises(ValueError, match="shape"):
        HistoryStore(length=3).restore(snap)


# -- the scorer ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    """Small seq params in the reference's layout (numpy): the reference's
    init at PRNGKey(3) with a fitted normalizer."""
    import jax

    from ccfd_tpu.data.ccfd import synthetic_dataset
    from ccfd_tpu.models import seq as ref_seq

    p = ref_seq.init(jax.random.PRNGKey(3))
    ds = synthetic_dataset(n=1024, seed=2)
    p = ref_seq.set_normalizer(p, ds.X.mean(0), ds.X.std(0))
    return jax.tree.map(np.asarray, p)


def _stream(seed: int = 0):
    from ccfd_tpu.data.ccfd import synthetic_dataset

    ds = synthetic_dataset(n=2048, fraud_rate=0.05, seed=seed)
    rng = np.random.default_rng(seed)
    start = 0
    for n in (1, 5, 17, 3, 40, 33, 2, 64, 9):
        x = ds.X[start:start + n]
        start += n
        txs = []
        for i in range(n):
            r = rng.uniform()
            if r < 0.1:
                txs.append({"Amount": 1.0})  # anonymous
            elif r < 0.2:
                txs.append({"id": f"tx{start + i}"})  # keyed by id
            else:
                txs.append({"customer_id": int(rng.integers(0, 12)), "id": start + i})
        yield txs, x


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("len_buckets,inflight", [((), 2), ((1, 4), 0), ((1, 4), 3)])
def test_seq_scorer_matches_the_reference(tree, dtype, tol, len_buckets, inflight):
    kw = dict(length=8, batch_sizes=(4, 16), compute_dtype=dtype, max_customers=10,
              stripes=3, inflight=inflight, len_buckets=len_buckets)
    rreg, preg = RefRegistry(), Registry()
    ref = RefSeqScorer(tree, registry=rreg, **kw)
    port = SeqScorer(from_jax_model_params("seq", tree), registry=preg, device="cpu", **kw)
    assert port.len_buckets == ref.len_buckets and port.batch_sizes == ref.batch_sizes
    for txs, x in _stream():
        want = ref.score_with_ids(txs, x)
        got = port.score_with_ids(txs, x)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        _snap_equal(port.store.snapshot(), ref.store.snapshot())
    for name in ("seq_bucket_dispatch_total", "seq_bucket_rows_total"):
        for lb in port.len_buckets:
            for b in port.batch_sizes:
                lab = {"l_bucket": str(lb), "b_bucket": str(b)}
                if name == "seq_bucket_rows_total":
                    lab = {"l_bucket": str(lb)}
                assert preg.counter(name).value(lab) == rreg.counter(name).value(lab), \
                    (name, lab)
    assert preg.counter("seq_anonymous_rows_total").value() == \
        rreg.counter("seq_anonymous_rows_total").value() > 0
    assert preg.gauge("seq_history_customers").value() == \
        rreg.gauge("seq_history_customers").value() == len(port.store)
    assert port.executable_grid() == {**ref.executable_grid()}
    assert port.dispatch_total() == sum(e["dispatches"] for e in port.executable_grid()["grid"])
    # the plain (x,) path scores cold and tracks nothing
    x = next(_stream(3))[1]
    np.testing.assert_allclose(port(x), ref(x), rtol=0, atol=tol)


def test_stale_commit_across_a_restore_is_counted(tree):
    reg = Registry()
    port = SeqScorer(from_jax_model_params("seq", tree), length=4, batch_sizes=(4,),
                     registry=reg, device="cpu", compute_dtype="float32")
    snap = port.store.snapshot()
    real = port.store.prepare

    def prepare_then_restore(*a, **kw):
        out = real(*a, **kw)
        port.store.restore(snap)  # a crash restore lands mid-batch
        return out

    port.store.prepare = prepare_then_restore
    port.score(np.ones((3, F), np.float32), ids=["a", "b", "a"])
    assert reg.counter("seq_stale_commits_total").value() == 1 and len(port.store) == 0


def test_swap_to_the_int8_tree_rebinds_to_seq_q8(tree):
    from ccfd_tpu.ops import seq_quant as ref_q8

    kw = dict(length=8, batch_sizes=(4, 16), compute_dtype="bfloat16")
    ref = RefSeqScorer(tree, **kw)
    port = SeqScorer(from_jax_model_params("seq", tree), device="cpu", **kw)
    q8 = ref_q8.quantize_seq(tree)
    ref.swap_params(q8)
    port.swap_params(from_jax_model_params("seq_q8", q8))
    assert port.executable_grid()["model"] == "seq_q8" == ref.executable_grid()["model"]
    for txs, x in _stream(1):
        np.testing.assert_allclose(port.score_with_ids(txs, x), ref.score_with_ids(txs, x),
                                   rtol=0, atol=2e-2)
    port.swap_params(from_jax_model_params("seq", tree))
    assert port.executable_grid()["model"] == "seq"


def _cpu_mesh_kw(which: str) -> dict:
    """The sharded path's arguments over logical CPU shards (A15b)."""
    from ccfd_tpu_torch.parallel.mesh import make_named_mesh
    from ccfd_tpu_torch.parallel.partition import DataParallelPartitioner

    cpu = [torch.device("cpu")] * 4
    if which == "mesh":
        return {"mesh": make_named_mesh(cpu)}
    if which == "partitioner":
        return {"partitioner": DataParallelPartitioner(make_named_mesh(cpu))}
    return {"partitioner": DataParallelPartitioner(make_named_mesh(cpu, tp=2)),
            "seq_parallel": which}


@pytest.mark.parametrize("which,match", [
    ("mesh", "mesh"),
    ("partitioner", "partitioner"),
    ("ring", "seq_parallel='ring'"),
    ("ulysses", "seq_parallel='ulysses'"),
])
def test_the_sharded_path_is_refused_by_name(tree, which, match):
    """Named for the refusal before A15b: the sharded seq path is served
    since, so each case now scores the reference's stream through it on
    logical CPU shards, within the f32 bar of the reference's single-device
    scorer (the batch split over the mesh, L over tp for ring and
    Ulysses); an unknown mode is still refused by name."""
    kw = dict(length=8, batch_sizes=(4, 16, 64), compute_dtype="float32")
    ref = RefSeqScorer(tree, **kw)
    port = SeqScorer(from_jax_model_params("seq", tree), **kw, **_cpu_mesh_kw(which))
    assert port.mesh is not None and all(b % 4 == 0 or b % 2 == 0 for b in port.batch_sizes)
    for txs, x in _stream(2):
        np.testing.assert_allclose(port.score_with_ids(txs, x), ref.score_with_ids(txs, x),
                                   rtol=0, atol=1e-5, err_msg=match)
    if which in ("ring", "ulysses"):
        assert port.executable_grid()["seq_parallel"] == which
    with pytest.raises(ValueError, match="none|ring|ulysses"):
        SeqScorer(from_jax_model_params("seq", tree), device="cpu", seq_parallel="tree")


def test_default_telemetry_records_the_history_bytes(tree):
    from ccfd_tpu_torch.observability import device as dev_mod

    tel = dev_mod.DeviceTelemetry()
    dev_mod.set_default(tel)
    try:
        port = SeqScorer(from_jax_model_params("seq", tree), length=4, batch_sizes=(4,),
                         device="cpu")
        assert port.telemetry is tel
        port.score(np.ones((3, F), np.float32), ids=["a", "b", "c"])
        assert tel.h2d_bytes() == 4 * 4 * F * 4
    finally:
        dev_mod.set_default(None)
    assert dev_mod.get_default() is None
    assert tel.peak_memory_bytes() is None or tel.peak_memory_bytes() >= 0


def test_the_card_is_the_default_device(tree):
    if torch.cuda.is_available():
        pytest.skip("this box has a card")  # pragma: no cover
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SeqScorer(from_jax_model_params("seq", tree))


@pytest.mark.parametrize("model", ["seq", "seq_q8"])
def test_the_row_scorer_names_the_seq_scorer(model):
    from ccfd_tpu_torch.serving.scorer import Scorer

    with pytest.raises(ValueError, match="SeqScorer"):
        Scorer(model, device="cpu")
