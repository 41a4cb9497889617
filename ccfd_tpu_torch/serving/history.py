"""Per-customer transaction history for the sequence scorer.

The port of ccfd_tpu/serving/history.py, its single-device half. The seq
model (models/seq.py) scores the NEWEST transaction given the customer's
recent history (B, L, F). Single-row REST scoring is stateless by design
(the Seldon contract); history lives where the stream lives, in the
routing tier, which sees every transaction in arrival order.

- ``HistoryStore`` (numpy, the reference's behaviour line for line) —
  fixed-depth ring buffer per customer, bounded total customers (LRU
  eviction at the cap, by arrival order), striped by key hash with
  per-stripe locks, a global monotonic touch stamp keeping LRU exact
  across stripes, an all-anonymous fast path that takes no lock, and a
  vectorized ``prepare`` for the common no-duplicate-key chunk. Mutation
  is two-phase: ``prepare()`` stages copies, ``commit()`` publishes them
  (a failed dispatch leaves no transaction in history that was never
  routed); ``restore`` bumps a generation, so a commit staged before it
  is dropped, and a per-key optimistic check skips keys a concurrent
  commit moved (``contended_skips``). ``snapshot`` is stripe-incremental;
  the recovery coordinator holds the store as pipeline state
  (``register_state("history", ...)``), so a crash rewind's replay
  re-builds exactly the histories of the cut, with no double append.
- ``SeqScorer`` — the router-facing scorer: rows bucket by history depth
  (the ``len_buckets`` ladder, off by default) and batch size (a greedy
  decomposition into exact-fit buckets); each (L, B) group's forward is
  launched on the card and its probabilities copied back into a pinned
  buffer without blocking, an event recorded after the copy, and the next
  group assembles while the card runs. The loop waits on the oldest
  group's event only when more than ``inflight`` are pending, and the
  store commits once, after every group resolved. The forward is
  ``models/seq.py::apply_serving``, or ``ops/seq_quant.py::apply`` when
  the params are the int8 tree (``swap_params`` re-binds on that). The
  forward is torch code (the reference leaves it to XLA): it launches
  none of the port's hand kernels.
- **Fault seams.** ``device_seam("dispatch")`` before each (L, B) launch
  and ``device_seam("put")`` before each history copy (runtime/faults.py),
  as the reference's: the heal ladder drills the seq path too.

- **The lifecycle lane.** A challenger slot (``install_challenger``: a
  second params tree, typically the int8 ``seq_q8`` tree, with its own
  forward), the ``shadow_tap`` offer and the ``canary_gate``. The router
  calls ``score_with_ids`` on this object, so there is no score lane to
  wrap: when a tap is armed each assembled chunk's (full-L histories, PURE
  champion probabilities) pair is offered to it, and an active canary gate
  re-scores its challenger slice on the SAME assembled contexts through
  ``rescore(mask)``. The challenger runs the same torch forward as the
  champion (``models/seq.py`` or ``ops/seq_quant.py``, at ``pos_length =
  store.length``) on the scorer's device, as the reference's challenger is
  its device program too; ``host_score`` is the champion's cold-context
  score, the paired half of the evaluator's label join.

- **The mesh** (``mesh=`` or ``partitioner=``, parallel/partition.py):
  history batches split over the mesh's partitioned axes (every axis of
  size > 1 but the sequence-parallel one), and B buckets round up to the
  number of batch groups. The params lie on the mesh as the partitioner
  lays them out (the rule table under ``param_partition: rules``,
  replicated under data parallelism; a tree the table does not cover, such
  as the int8 ``seq_q8`` tree, replicates with a warning), and each batch
  group runs the forward on its device with the params gathered there.
  History assembly stays on the host either way.
- **Sequence parallelism** (``seq_parallel``: ``none`` | ``ring`` |
  ``ulysses``): the attention's L dim shards over the mesh's ``tp`` (or
  legacy ``model``) axis through ops/ring_attention.py or ops/ulysses.py,
  within each batch group. The gate is static: a block that cannot shard
  (the readout block's single query; an L the axis does not divide;
  ulysses also a head count it does not divide) takes
  ``reference_attention``, and a full-attention block that cannot shard
  warns once. The inventory's ``seq_parallel_engaged`` says whether any
  attention block was actually sharded.
- **The publish gate**: ``swap_params`` enters the partitioner's
  ``PublishGate`` (``set_swap_gate``) for the flip, as the row Scorer does.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Any

import numpy as np
import torch

from ccfd_tpu_torch.data.ccfd import NUM_FEATURES
from ccfd_tpu_torch.device import resolve
from ccfd_tpu_torch.observability.device import settle_copies, timed_copy
from ccfd_tpu_torch.runtime.faults import device_seam

DEFAULT_STRIPES = 8
# short-sequence ladder OFF by default: bucketed windows attend fewer
# zero-pad tokens than the full-L graph (reference_attention has no
# padding mask), so scores for cold rows differ between rungs
DEFAULT_LEN_BUCKETS: tuple = ()
DEFAULT_INFLIGHT = 2


class _PlacedTree(dict):
    """A mesh SeqScorer's params: the laid-out tree (dict items) and, by
    batch-group device, the params gathered there (``local``)."""

    def __init__(self, tree: dict):
        super().__init__(tree)
        self.local: dict = {}


class _Stripe:
    __slots__ = ("lock", "h", "dirty", "cache")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        # key -> (buffer (L, F) f32, filled count, touch stamp)
        self.h: OrderedDict[Any, tuple[np.ndarray, int, int]] = OrderedDict()
        self.dirty = True
        self.cache: list[tuple[int, Any, np.ndarray, int]] = []


class HistoryStore:
    """Fixed-depth per-customer ring buffers with bounded total keys.

    Memory bound: ``max_customers * length * num_features * 4`` bytes —
    the default (20k x 64 x 30 x f32) admits ~150 MB resident on the
    serving host; size the cap to the deployment's live-customer working
    set, not its total cardinality (LRU keeps the hot set).

    Concurrency: reads/stages take only the key's stripe lock (and the
    all-anonymous path none); ``commit``/``restore``/``snapshot``
    serialize on one commit lock (commits are per router batch — rare
    next to prepares — and a restore interleaving a half-published
    commit would corrupt the cut). Stored buffers are IMMUTABLE by
    convention: prepare copies before mutating and commit replaces
    entries, which is what lets lookups hand out references under the
    stripe lock and snapshots share entries across generations."""

    def __init__(self, length: int = 64, num_features: int = NUM_FEATURES,
                 max_customers: int = 20_000, stripes: int = DEFAULT_STRIPES):
        if length < 1:
            raise ValueError("history length must be >= 1")
        self.length = int(length)
        self.num_features = int(num_features)
        self.max_customers = int(max_customers)
        self.stripes = max(1, int(stripes))
        self._stripes = [_Stripe() for _ in range(self.stripes)]
        self._commit_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._total = 0
        # global touch stamp: commit order defines recency ACROSS stripes,
        # so LRU eviction at the cap stays exact despite per-stripe LRU
        # order (itertools.count().__next__ is GIL-atomic)
        self._stamp = itertools.count().__next__
        # commits skipped by the per-key optimistic check (see commit());
        # nonzero means concurrent same-key batches raced — e.g. a
        # watchdog-abandoned dispatch's late commit
        self._contended = 0
        # epoch generation: restore() bumps it and commit() drops staged
        # chunks from an older generation — a scorer dispatch that was in
        # flight across a crash restore (the unacked-barrier path) must
        # not land its doomed-epoch rows on the restored state (the
        # engine's equivalent guard is Engine._check_alive)
        self._gen = 0

    def _stripe_of(self, key: Any) -> _Stripe:
        return self._stripes[hash(key) % self.stripes]

    def __len__(self) -> int:
        with self._count_lock:
            return self._total

    # -- staging ------------------------------------------------------------
    # ccfd-lint: hot-path
    def prepare(
        self, ids: list, rows: np.ndarray, overlay: dict | None = None
    ) -> tuple[np.ndarray, tuple[int, dict, np.ndarray]]:
        """Stage this chunk: return the (B, L, F) batch of post-append
        histories (newest last) plus a token ``(gen, staged, filled)``,
        WITHOUT mutating the store. ``commit()`` publishes staged state
        only after the scorer dispatch succeeded — a dropped batch
        (transient scorer failure) must leave histories exactly matching
        the routed stream. ``filled`` is the per-row post-append history
        depth — what the scorer's L-bucket ladder partitions on.

        A customer appearing twice in one chunk sees its earlier
        same-chunk rows in the later assembly; ``overlay`` extends that
        visibility across the chunks of ONE router batch (the caller
        accumulates staged dicts and commits once). ``None`` ids are
        anonymous: scored against an empty history and NEVER stored — a
        bounded store must not spend its cap (and evict real customers)
        on keys no future record can match. An ALL-anonymous chunk takes
        no lock and stages nothing (the cold-REST fast path)."""
        rows = np.ascontiguousarray(rows, np.float32)
        n = len(rows)
        L = self.length
        out = np.zeros((n, L, self.num_features), np.float32)
        filled_out = np.ones((n,), np.int32)
        gen = self._gen
        if n:
            out[:, -1] = rows
        keyed = [(i, ids[i]) for i in range(n) if ids[i] is not None]
        if not keyed:
            return out, (gen, {}, filled_out)
        keys = [k for _, k in keyed]
        if len(set(keys)) == len(keys):
            staged = self._prepare_unique(keyed, rows, out, filled_out,
                                          overlay)
        else:
            staged = self._prepare_general(ids, rows, out, filled_out,
                                           overlay)
        return out, (gen, staged, filled_out)

    def _lookup_refs(self, pairs: list[tuple[int, Any]]) -> dict:
        """(row, key) pairs -> {row: (buf_ref, filled)} for keys live in
        the store; one pass per touched stripe, references only under the
        lock (buffers are immutable, see class docstring)."""
        by_stripe: dict[int, list[tuple[int, Any]]] = {}
        for i, key in pairs:
            by_stripe.setdefault(hash(key) % self.stripes, []).append((i, key))
        hits: dict[int, tuple[np.ndarray, int, int]] = {}
        for si, group in by_stripe.items():
            st = self._stripes[si]
            with st.lock:
                h = st.h
                for i, key in group:
                    ent = h.get(key)
                    if ent is not None:
                        hits[i] = ent  # (buf, filled, stamp) — immutable
        return hits

    def _prepare_unique(self, keyed, rows, out, filled_out, overlay) -> dict:
        """No key repeats in the chunk: assembly vectorizes — one stripe
        pass collects buffer references, one batched shifted-gather fills
        ``out``, one contiguous copy per row stages."""
        L = self.length
        hits: dict[int, tuple[np.ndarray, int]] = {}
        if overlay:
            missing = []
            for i, key in keyed:
                ent = overlay.get(key)
                if ent is not None:
                    hits[i] = ent
                else:
                    missing.append((i, key))
        else:
            missing = keyed
        if missing:
            hits.update(self._lookup_refs(missing))
        if hits:
            # shift-left ring, batched: rows 1..L-1 of each prior buffer
            # land at 0..L-2; the newest transaction is already at L-1
            hi = np.fromiter(hits.keys(), np.intp, len(hits))
            out[hi, : L - 1] = np.stack([hits[i][0] for i in hi])[:, 1:]
        staged: dict[Any, tuple[np.ndarray, int, int | None]] = {}
        for i, key in keyed:
            ent = hits.get(i)
            filled = min((ent[1] if ent is not None else 0) + 1, L)
            # base = the stamp of the store entry this staging derives
            # from (None for a fresh key): commit's optimistic check
            staged[key] = (out[i].copy(), filled,
                           ent[2] if ent is not None else None)
            filled_out[i] = filled
        return staged

    def _prepare_general(self, ids, rows, out, filled_out, overlay) -> dict:
        """Duplicate keys in the chunk: the per-row loop (earlier
        same-chunk rows must be visible to later assemblies), with store
        lookups still batched per stripe up front."""
        L = self.length
        seen: dict[Any, int] = {}
        firsts = []
        for i, key in enumerate(ids):
            if key is not None and key not in seen:
                seen[key] = i
                firsts.append((i, key))
        refs_by_row = self._lookup_refs(firsts)
        refs = {ids[i]: ent for i, ent in refs_by_row.items()}
        staged: dict[Any, tuple[np.ndarray, int, int | None]] = {}
        for i, key in enumerate(ids):
            if key is None:
                continue  # cold context + this row, already assembled
            ent = staged.get(key)
            if ent is None and overlay is not None:
                o = overlay.get(key)
                if o is not None:  # earlier chunk's staged copy keeps its
                    ent = (o[0].copy(), o[1], o[2])  # original base stamp
            if ent is None:
                r = refs.get(key)
                if r is None:
                    buf = np.zeros((L, self.num_features), np.float32)
                    filled, base = 0, None
                else:  # copy-on-write: the live buffer stays untouched
                    buf, filled, base = r[0].copy(), r[1], r[2]
            else:
                buf, filled, base = ent
            buf[:-1] = buf[1:]
            buf[-1] = rows[i]
            filled = min(filled + 1, L)
            if key in staged:  # recency = LAST occurrence (see score())
                del staged[key]
            staged[key] = (buf, filled, base)
            out[i] = buf
            filled_out[i] = filled
        return staged

    # -- publication --------------------------------------------------------
    # ccfd-lint: hot-path
    def commit(self, token: tuple) -> bool:
        """Publish a prepared chunk (call only after every dispatch of the
        batch resolved). Evicts the globally-coldest keys past the cap.
        Returns False — and changes nothing — when the store was restored
        since the prepare (stale generation: the rewound bus will
        re-drive those records onto the restored state).

        Per-key optimistic check: each staged entry carries the stamp of
        the store entry it derives from; a key whose live entry moved
        since the prepare (a CONCURRENT batch committed it — e.g. a
        watchdog-abandoned dispatch's late commit racing the worker's
        next batch on the same partition keys) is SKIPPED rather than
        clobbering the newer state, counted in ``contended_skips``. The
        skipped batch's appends are recovered by the next crash-restore
        replay (the records are in the routed stream)."""
        gen, staged = token[0], token[1]
        if not staged:
            return True
        with self._commit_lock:
            if gen != self._gen:
                return False
            # stamps follow the batch's ARRIVAL order (staged dicts
            # preserve first-occurrence order), assigned BEFORE the
            # per-stripe insertion pass: stamping inside that pass would
            # make whole stripe-groups "newest" within a batch, and under
            # a binding cap eviction would systematically keep one hash
            # class of each batch (found by the replay drill: disjoint
            # survivor sets before/after a rewind)
            by_stripe: dict[int, list] = {}
            for key, ent in staged.items():
                by_stripe.setdefault(hash(key) % self.stripes, []).append(
                    (key, ent, self._stamp()))
            added = 0
            for si, items in by_stripe.items():
                st = self._stripes[si]
                with st.lock:
                    h = st.h
                    for key, (buf, filled, base), stamp in items:
                        cur = h.get(key)
                        if cur is not None and (base is None
                                                or cur[2] != base):
                            # live entry moved since this prepare: a
                            # concurrent batch owns the newer state
                            self._contended += 1
                            continue
                        if cur is not None:
                            h.move_to_end(key)
                        else:
                            added += 1
                        h[key] = (buf, filled, stamp)
                    st.dirty = True
            if added:
                with self._count_lock:
                    self._total += added
            self._evict_over_cap()
        return True

    def _evict_over_cap(self) -> None:
        """Pop the globally-oldest entry until under the cap. Runs under
        the commit lock (single evictor); takes one stripe lock at a time
        — the scan reads each stripe's LRU head stamp, the pop re-checks
        under the chosen stripe's lock."""
        while True:
            with self._count_lock:
                if self._total <= self.max_customers:
                    return
            best_i, best_stamp = -1, None
            for i, st in enumerate(self._stripes):
                with st.lock:
                    if st.h:
                        stamp = next(iter(st.h.values()))[2]
                        if best_stamp is None or stamp < best_stamp:
                            best_i, best_stamp = i, stamp
            if best_i < 0:
                return
            st = self._stripes[best_i]
            with st.lock:
                if st.h:
                    st.h.popitem(last=False)
                    st.dirty = True
                    with self._count_lock:
                        self._total -= 1

    # -- checkpoint surface (pipeline state, like the engine) ---------------
    def snapshot(self) -> dict:
        """State for the recovery coordinator's cut: runs under the
        checkpoint barrier. Stripe-incremental and ZERO-copy: a stripe
        untouched since the last snapshot reuses its cached entry list,
        and entries share the live buffers (immutable by convention — the
        store replaces, never mutates them), so the barrier cost is
        proportional to churn, not store size. The coordinator
        JSON-normalizes outside the barrier (recovery.py _np_jsonable);
        ``restore`` accepts either form. Entries are ordered coldest
        first (global touch stamps), so a restore rebuilds the same
        eviction order."""
        with self._commit_lock:
            entries: list[tuple[int, Any, np.ndarray, int]] = []
            for st in self._stripes:
                with st.lock:
                    if st.dirty:
                        st.cache = [
                            (stamp, key, buf, filled)
                            for key, (buf, filled, stamp) in st.h.items()
                        ]
                        st.dirty = False
                    entries.extend(st.cache)
            entries.sort(key=lambda e: e[0])
            return {
                "version": 1,
                "length": self.length,
                "num_features": self.num_features,
                "customers": [[key, buf, filled]
                              for _, key, buf, filled in entries],
            }

    def restore(self, snap: dict | None) -> None:
        """Replace the store's content with a snapshot's (crash recovery:
        the rewound bus re-drives post-cut records, re-building exactly
        the histories the cut had). ``None`` resets to empty (genesis
        restore — replay from offset 0 rebuilds everything). The
        generation bumps LAST, so a prepare racing this call either sees
        the old generation (its commit is dropped) or the fully-restored
        state."""
        with self._commit_lock:
            for st in self._stripes:
                with st.lock:
                    st.h.clear()
                    st.dirty = True
                    st.cache = []
            total = 0
            if snap is not None:
                if snap.get("version") != 1:
                    raise ValueError(
                        f"unknown history snapshot {snap.get('version')!r}")
                if (int(snap["length"]) != self.length
                        or int(snap["num_features"]) != self.num_features):
                    raise ValueError("history snapshot shape mismatch")
                for key, buf, filled in snap["customers"]:
                    st = self._stripe_of(key)
                    with st.lock:
                        st.h[key] = (
                            np.asarray(buf, np.float32).reshape(
                                self.length, self.num_features),
                            int(filled),
                            self._stamp(),
                        )
                    total += 1
            with self._count_lock:
                self._total = total
            self._gen += 1  # in-flight prepares become stale commits

    @property
    def contended_skips(self) -> int:
        return self._contended

    def snapshot_counts(self) -> dict:
        return {"customers": len(self), "length": self.length,
                "stripes": self.stripes}


class SeqScorer:
    """History-aware scorer with the row scorer's serving discipline —
    bucketed static shapes — run as an overlapped dataflow: per-(L, B)
    bucket launches enqueue while the next group assembles, bounded by
    ``inflight``; ONE commit per router batch after every group resolved
    (see the module docstring)."""

    def __init__(
        self,
        params: Any,
        length: int = 64,
        batch_sizes: tuple = (16, 128, 1024, 4096),
        compute_dtype: str = "bfloat16",
        max_customers: int = 20_000,
        registry: Any = None,
        mesh: Any = None,
        stripes: int = DEFAULT_STRIPES,
        inflight: int = DEFAULT_INFLIGHT,
        len_buckets: tuple | None = None,
        telemetry: Any = None,
        partitioner: Any = None,
        seq_parallel: str = "none",
        device: "str | torch.device | None" = None,
    ):
        """``inflight``: launches in flight before the loop waits on the
        oldest (0 = resolve each at once, the synchronous path).
        ``len_buckets``: the short-sequence ladder; the full ``length`` is
        always appended. A row dispatches at the smallest bucket covering
        its post-append history depth. ``device``: the card unless the
        caller asks for the CPU."""
        sp = str(seq_parallel or "none").lower()
        if sp not in ("none", "ring", "ulysses"):
            raise ValueError(f"seq_parallel={seq_parallel!r}: expected none|ring|ulysses")
        self.partitioner = partitioner
        if partitioner is not None:
            mesh = partitioner.mesh
        self.mesh = mesh
        self.seq_parallel = sp
        self._sp_axis = None
        self._groups: list | None = None
        self._sp_engaged = 0
        self._sp_fallback = 0
        self._sp_warned = False
        self._swap_gate: Any = None
        if sp != "none" and mesh is None:
            raise ValueError("seq_parallel needs a mesh")
        if mesh is not None:
            home = mesh.flat[0]
            if device is not None and torch.device(device).type != home.type:
                raise ValueError(f"device={device!r} but the mesh's shards lie on {home}")
            device = home
            if sp != "none":
                # L shards over the tensor-parallel axis (named mesh "tp";
                # legacy 2-D mesh "model"): the batch must not split over it
                for a in ("tp", "model"):
                    if mesh.shape.get(a, 1) > 1:
                        self._sp_axis = a
                        break
                if self._sp_axis is None:
                    raise ValueError(
                        f"seq_parallel={sp!r} needs a tp/model mesh axis of size > 1; "
                        f"mesh axes are {dict(mesh.shape)}")
            # the batch splits over EVERY non-sp axis the mesh has
            part_axes = tuple(a for a in ("data", "fsdp", "tp", "model")
                              if mesh.shape.get(a, 1) > 1 and a != self._sp_axis) \
                or tuple(a for a in mesh.axis_names if a != self._sp_axis)[:1]
            self._groups = [pos for pos in mesh.positions()
                            if all(c == 0 for a, c in zip(mesh.axis_names, pos)
                                   if a not in part_axes)]
            dsize = len(self._groups)
            batch_sizes = tuple(max(1, -(-int(b) // dsize)) * dsize for b in batch_sizes)
        self.device = resolve(device)
        self.store = HistoryStore(length=length, max_customers=max_customers,
                                  stripes=stripes)
        # device telemetry plane (observability/device.py): the bytes of
        # each history batch copied to the device (ccfd_h2d_bytes_total)
        if telemetry is None:
            from ccfd_tpu_torch.observability import device as _device

            telemetry = _device.get_default()
        self.telemetry = telemetry
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else torch.float32)
        self.inflight = max(0, int(inflight))
        if len_buckets is None:
            len_buckets = DEFAULT_LEN_BUCKETS
        self.len_buckets = tuple(sorted(
            {int(b) for b in len_buckets if 0 < int(b) < length} | {int(length)}))
        self.batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
        self.params = self._to_device(params)
        self._quantized = self._is_quantized(self.params)
        self._apply = self._make_apply(self._quantized)
        self._params_lock = threading.Lock()
        # challenger slot (lifecycle/): (version, params, forward), scored
        # off the hot path by the shadow tap's worker and the canary gate
        self._challenger: tuple[int, Any, Any] | None = None
        # shadow tap + canary gate (lifecycle/), wired by the operator
        self.shadow_tap: Any = None
        self.canary_gate: Any = None
        self.dispatches = 0  # forward launches (every (L, B) group)
        self._g_customers = None
        self._h_assembly = self._h_dispatch = None
        self._c_bucket = self._c_bucket_rows = None
        self._g_inflight = self._c_anon = self._c_stale = None
        if registry is not None:
            self._g_customers = registry.gauge(
                "seq_history_customers", "customers with live history")
            self._h_assembly = registry.histogram(
                "seq_assembly_seconds",
                "host-side history assembly time per router batch "
                "(prepare + L/B bucketing + padding)")
            self._h_dispatch = registry.histogram(
                "seq_dispatch_seconds",
                "device dispatch time per router batch: enqueue plus the "
                "blocking waits the overlap could not hide")
            self._c_bucket = registry.counter(
                "seq_bucket_dispatch_total",
                "seq dispatches by (L bucket, B bucket) executable")
            self._c_bucket_rows = registry.counter(
                "seq_bucket_rows_total",
                "rows scored per L bucket (short buckets = the cold-row "
                "fast lane actually firing)")
            self._g_inflight = registry.gauge(
                "seq_inflight_dispatches", "seq dispatches currently in flight")
            self._c_anon = registry.counter(
                "seq_anonymous_rows_total",
                "anonymous rows scored cold (lock-free prepare fast path; "
                "never stored)")
            self._c_stale = registry.counter(
                "seq_stale_commits_total",
                "commits dropped for stale generation (dispatch in flight "
                "across a crash restore — the no-op that keeps replay "
                "from double-appending)")

    # -- variant dispatch ---------------------------------------------------
    def _to_device(self, params: Any) -> dict:
        """The params on the scorer's device; on a mesh, laid out per
        ``_param_layout`` (a tree of ``ShardedTensor``, with each batch
        group's gathered copy in ``.local``)."""
        from ccfd_tpu_torch.params import tensor_leaf, to_device, tree_map

        if self.mesh is None:
            return to_device(params, self.device)
        from ccfd_tpu_torch.parallel.sharding import shard_params

        host = tree_map(lambda a: tensor_leaf(a, "cpu"), params)
        placed = _PlacedTree(shard_params(host, self._param_layout(host)))
        for pos in self._groups:
            dev = self.mesh.devices[pos]
            if str(dev) not in placed.local:
                placed.local[str(dev)] = to_device(placed, dev)
        return placed

    def _param_layout(self, params: Any) -> Any:
        """``NamedSharding`` tree for the seq params on the mesh: the
        partitioner's layout when one is given, else replicated; a tree
        the rule table does not cover replicates with a warning."""
        from ccfd_tpu_torch.parallel.partition import DataParallelPartitioner

        rep = DataParallelPartitioner(self.mesh)
        if self.partitioner is None:
            return rep.param_sharding(params)
        try:
            return self.partitioner.param_sharding(params)
        except ValueError as e:
            import logging

            logging.getLogger(__name__).warning(
                "seq param layout: rule table does not cover this tree (%s); "
                "replicating instead", e)
            return rep.param_sharding(params)

    def set_swap_gate(self, gate: Any) -> None:
        """Arm the partitioner's publish gate: every ``swap_params`` then
        pauses the router pool at a batch boundary for the flip, as the row
        Scorer's."""
        self._swap_gate = gate

    def _sp_attention(self, pos: tuple) -> Any:
        """The selected sequence-parallel attention over the sp axis of the
        batch group at ``pos``, or None (module docstring's static gate)."""
        if self._sp_axis is None:
            return None
        from ccfd_tpu_torch.ops.ring_attention import reference_attention

        mesh, axis = self.mesh, self._sp_axis
        n = int(mesh.shape[axis])
        at = {a: c for a, c in zip(mesh.axis_names, pos) if a != axis}
        if self.seq_parallel == "ring":
            from ccfd_tpu_torch.ops.ring_attention import ring_attention as sp_fn
        else:
            from ccfd_tpu_torch.ops.ulysses import ulysses_attention as sp_fn
        needs_heads = self.seq_parallel == "ulysses"

        def attn(q, k, v):
            shardable = (q.shape[2] == k.shape[2]  # not the readout query
                         and q.shape[2] % n == 0
                         and (not needs_heads or q.shape[1] % n == 0))
            if not shardable:
                self._sp_fallback += 1
                if q.shape[2] == k.shape[2] and not self._sp_warned:
                    self._sp_warned = True
                    import logging

                    logging.getLogger(__name__).warning(
                        "seq_parallel=%s cannot shard a (heads=%d, L=%d) attention over "
                        "the %d-way %r axis; that shape serves reference attention",
                        self.seq_parallel, q.shape[1], q.shape[2], n, axis)
                return reference_attention(q, k, v)
            self._sp_engaged += 1
            return sp_fn(q, k, v, mesh, axis, at=at)

        return attn

    @staticmethod
    def _is_quantized(params: Any) -> bool:
        from ccfd_tpu_torch.ops import seq_quant

        return seq_quant.is_quantized(params)

    def _make_apply(self, quantized: bool):
        """The forward for a float (``models/seq.py``) or an int8
        (``ops/seq_quant.py``) tree, at the store's full-L positions."""
        from ccfd_tpu_torch.models import seq as seq_mod
        from ccfd_tpu_torch.ops import seq_quant

        dtype = self.compute_dtype
        # positions anchor at the store's FULL length: a short L-bucket
        # window's tokens keep the positions the full-L path gives them
        plen = self.store.length
        if self.mesh is None:
            if quantized:
                return lambda p, xs: seq_quant.apply_serving(p, xs, dtype, pos_length=plen)
            return lambda p, xs: seq_mod.apply_serving(p, xs, dtype, pos_length=plen)
        fn = seq_quant.logits if quantized else seq_mod.logits_readout
        groups = [(self.mesh.devices[pos], self._sp_attention(pos)) for pos in self._groups]

        @torch.no_grad()
        def sharded(p: Any, xs: torch.Tensor) -> torch.Tensor:
            # one forward a batch group, on its device with its copy of
            # the params; the attention shards over the group's sp axis
            outs = [torch.sigmoid(fn(p.local[str(dev)], part.to(dev), dtype,
                                     attention_fn=attn, pos_length=plen)).to(xs.device)
                    for (dev, attn), part in zip(groups, xs.chunk(len(groups)))]
            return torch.cat(outs)

        return sharded

    def swap_params(self, params: Any) -> None:
        """Hot-swap model weights. A variant change (the float tree
        replaced by the int8 ``seq_q8`` tree, or back) re-binds the
        forward; the new params run the whole (L, B) grid once before they
        are published, as the reference precompiles it."""
        params = self._to_device(params)
        quantized = self._is_quantized(params)
        new_apply = None
        if quantized != self._quantized:
            new_apply = self._make_apply(quantized)
            self._run_grid(params, new_apply)
        gate = self._swap_gate
        with gate if gate is not None else contextlib.nullcontext():
            with self._params_lock:
                self.params = params
                if new_apply is not None:
                    self._quantized = quantized
                    self._apply = new_apply

    def _run_grid(self, params: Any, apply_fn: Any) -> None:
        for b in self.batch_sizes:
            for lb in self.len_buckets:
                xs = torch.zeros((b, lb, self.store.num_features), device=self.device)
                apply_fn(params, xs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Run every (B bucket, L bucket) shape the ladder can dispatch
        once (the card's first launch of each shape picks its kernels)."""
        with self._params_lock:
            params, apply_fn = self.params, self._apply
        self._run_grid(params, apply_fn)

    def executable_grid(self) -> dict:
        """The (L, B) grid with per-shape dispatch counts — the seq
        family's entry in the device telemetry inventory."""
        grid = []
        for lb in self.len_buckets:
            for b in self.batch_sizes:
                entry: dict = {"l_bucket": int(lb), "b_bucket": int(b)}
                if self._c_bucket is not None:
                    entry["dispatches"] = int(self._c_bucket.value(
                        {"l_bucket": str(lb), "b_bucket": str(b)}))
                grid.append(entry)
        out = {"model": "seq_q8" if self._quantized else "seq",
               "length": int(self.store.length), "grid": grid}
        if self.mesh is not None:
            out["mesh_devices"] = int(self.mesh.size)
            out["seq_parallel"] = self.seq_parallel
            if self.seq_parallel != "none":
                # configured is not engaged: did any block actually shard?
                out["seq_parallel_engaged"] = self._sp_engaged > 0
        return out

    def dispatch_total(self) -> int:
        """Forward launches so far (the operator's ``ccfd_scorer_dispatches``)."""
        return self.dispatches

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def _len_bucket_index(self, filled: np.ndarray) -> np.ndarray:
        """Per-row ladder index: smallest L bucket covering the row's
        post-append history depth."""
        return np.searchsorted(np.asarray(self.len_buckets), filled, side="left")

    # -- the overlapped scoring loop ---------------------------------------
    def _launch(self, apply_fn: Any, params: Any, sub: np.ndarray, m: int) -> tuple:
        """Copy ``sub`` to the device and launch the forward; on the card
        the first ``m`` probabilities are copied back into a pinned buffer
        without blocking and an event is recorded after the copy."""
        # the row scorer's staging copy: the put_fail seam, the failure
        # count and the copy's bytes and time (observability/device.py)
        xs, tok = timed_copy(self.telemetry, torch.from_numpy(sub), self.device)
        proba = apply_fn(params, xs)
        self.dispatches += 1
        if self.device.type != "cuda":
            settle_copies(self.telemetry, (tok,))
            return None, proba[:m], None
        host = torch.empty((m,), dtype=torch.float32, pin_memory=True)
        host.copy_(proba[:m], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return ev, host, tok

    def score(self, x: np.ndarray, ids: list | None = None) -> np.ndarray:
        """Router-compatible scorer: (B, F) rows -> (B,) probabilities,
        each conditioned on that customer's history. Rows with no id
        (``ids`` absent or None entries) score against an empty history
        and are not tracked.

        ONE commit for the whole router batch, after EVERY group resolved:
        a mid-batch failure drops the batch at the router, and a
        half-committed history would diverge from the routed stream. The
        overlay keeps same-customer visibility across chunks; the
        generation token makes a commit that raced a crash restore a
        no-op (the rewind re-drives those records)."""
        n = len(x)
        if n == 0:
            return np.zeros((0,), np.float32)
        if ids is None:
            ids = [None] * n
        out = np.empty((n,), np.float32)
        largest = self.batch_sizes[-1]
        L = self.store.length
        ladder = self.len_buckets
        merged: dict = {}
        gen = None
        pending: deque = deque()  # (event, probabilities, global row idx)
        # shadow/canary lane: with a challenger armed (tap) or a canary
        # slice live (gate), keep each chunk's assembled full-L histories
        # so the challenger scores the SAME contexts the champion did
        tap = self.shadow_tap
        if tap is not None and tap.armed_version is None:
            tap = None
        gate = self.canary_gate
        if gate is not None and not gate.active:
            gate = None
        tap_chunks: list[tuple[np.ndarray, int, int]] = []
        keep_hist = tap is not None or gate is not None
        t_asm = 0.0
        t_disp = 0.0
        n_anon = 0
        start = 0
        while start < n:
            stop = min(start + largest, n)
            t0 = time.perf_counter()
            chunk_ids = ids[start:stop]
            hist, (chunk_gen, staged, filled) = self.store.prepare(
                chunk_ids, x[start:stop], overlay=merged)
            # the FIRST chunk's generation stamps the whole batch: a
            # restore between chunk prepares makes the commit a no-op
            if gen is None:
                gen = chunk_gen
            # recency = LAST occurrence: a key re-staged by a later chunk
            # moves to the end of merged, so commit stamps follow stream
            # order
            for k in staged:
                if k in merged:
                    del merged[k]
            merged.update(staged)
            n_anon += chunk_ids.count(None)
            li = self._len_bucket_index(filled)
            if keep_hist:
                tap_chunks.append((hist, start, stop))
            t_asm += time.perf_counter() - t0
            for bi in np.unique(li):
                lb = ladder[bi]
                idx = np.nonzero(li == bi)[0]
                # greedy B decomposition: a group between bucket sizes
                # dispatches as exact-fit sub-batches (1229 -> 1024 + 128
                # + 128-padded-77) instead of one bucket padded to 3x
                pos = 0
                m_total = len(idx)
                while pos < m_total:
                    t0 = time.perf_counter()
                    rem = m_total - pos
                    bucket = None
                    for b in reversed(self.batch_sizes):
                        if b <= rem:
                            bucket = b
                            break
                    if bucket is None:
                        bucket = self.batch_sizes[0]
                    m = min(rem, bucket)
                    sub_idx = idx[pos:pos + m]
                    pos += m
                    if lb == L and m == len(hist):
                        sub = hist
                    else:  # right-aligned window
                        sub = hist[sub_idx, L - lb:, :]
                    if m < bucket:
                        sub = np.concatenate(
                            [sub, np.zeros((bucket - m, *sub.shape[1:]), np.float32)])
                    sub = np.ascontiguousarray(sub)
                    with self._params_lock:
                        params, apply_fn = self.params, self._apply
                    t_asm += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    # the device-fault dispatch seam (runtime/faults.py):
                    # device_hang and compile_stall drill the heal ladder
                    # through the seq path's own dispatch loop
                    device_seam("dispatch")
                    ev, proba, tok = self._launch(apply_fn, params, sub, m)
                    t_disp += time.perf_counter() - t0
                    pending.append((ev, proba, tok, sub_idx + start))
                    if self._c_bucket is not None:
                        self._c_bucket.inc(labels={"l_bucket": str(lb), "b_bucket": str(bucket)})
                        self._c_bucket_rows.inc(m, labels={"l_bucket": str(lb)})
                    if self._g_inflight is not None:
                        self._g_inflight.set(float(len(pending)))
                    while len(pending) > self.inflight:
                        t_disp += self._resolve(pending, out)
            start = stop
        while pending:
            t_disp += self._resolve(pending, out)
        if gen is not None:
            if not self.store.commit((gen, merged)):
                if self._c_stale is not None:
                    self._c_stale.inc()
        if tap is not None:
            # the tap pairs PURE champion scores, offered before any
            # canary override (the row lane's tap-inside/gate-outside)
            for hist, s0, s1 in tap_chunks:
                tap.offer(hist, out[s0:s1])
        if gate is not None and tap_chunks:
            # the canary slice: the challenger arm re-scores on the SAME
            # assembled contexts (a challenger failure keeps the
            # champion's scores and is counted by the gate)
            def rescore(mask: np.ndarray) -> np.ndarray:
                parts = [h[mask[s0:s1]] for h, s0, s1 in tap_chunks]
                sel = parts[0] if len(parts) == 1 else np.concatenate(parts)
                return self.challenger_score(sel)

            out = gate.apply(np.ascontiguousarray(x, np.float32), out, rescore=rescore)
        if self._g_customers is not None:
            self._g_customers.set(float(len(self.store)))
        if self._h_assembly is not None:
            self._h_assembly.observe(t_asm)
            self._h_dispatch.observe(t_disp)
        if n_anon and self._c_anon is not None:
            self._c_anon.inc(n_anon)
        return out

    def _resolve(self, pending: deque, out: np.ndarray) -> float:
        """Wait for the oldest group and scatter its rows; returns the
        blocking wait (the dispatch time the overlap failed to hide)."""
        ev, proba, tok, idx = pending.popleft()
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
            settle_copies(self.telemetry, (tok,))
        out[idx] = proba.numpy()
        dt = time.perf_counter() - t0
        if self._g_inflight is not None:
            self._g_inflight.set(float(len(pending)))
        return dt

    # Router contract: the router calls the object for the plain (x,)
    # path, and detects score_with_ids to feed decoded records alongside x
    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.score(x)

    def score_with_ids(self, txs: list, x: np.ndarray) -> np.ndarray:
        """Batch entry for the router: ids come from each record's
        ``customer_id``/``id`` field; records with neither are anonymous
        (scored cold, not tracked)."""
        ids: list = []
        for t in txs:
            key = None
            if isinstance(t, dict):
                key = t.get("customer_id")
                if key is None:
                    key = t.get("id")
            ids.append(key)
        return self.score(x, ids)

    # -- challenger slot (the model lifecycle's shadow scoring of seq_q8) --
    def install_challenger(self, version: int, params: Any) -> None:
        """Stage a challenger (typically the int8 ``seq_q8`` tree) beside
        the champion, on the scorer's device. Its forwards run on the
        shadow tap's worker and in the canary gate's slice, bounded by the
        tap's sampling budget and the gate's weight."""
        params = self._to_device(params)
        fn = self._make_apply(self._is_quantized(params))
        with self._params_lock:
            self._challenger = (int(version), params, fn)

    def clear_challenger(self, version: int | None = None) -> None:
        with self._params_lock:
            if (self._challenger is not None
                    and (version is None or self._challenger[0] == int(version))):
                self._challenger = None

    @property
    def challenger_version(self) -> int | None:
        ch = self._challenger
        return None if ch is None else ch[0]

    def challenger_score(self, x: np.ndarray) -> np.ndarray:
        """(n, F) rows (scored against a COLD context: the evaluator's
        label joins carry no history) or (n, L', F) histories (tapped
        batches) -> (n,) probabilities on the challenger params."""
        ch = self._challenger
        if ch is None:
            raise RuntimeError("no challenger installed")
        _, params, fn = ch
        return self._score_direct(np.asarray(x, np.float32), params, fn)

    def host_score(self, x: np.ndarray) -> np.ndarray:
        """The champion's cold-context score for (n, F) rows: the paired
        half of the evaluator's label join (same rows, same cold context,
        champion against challenger)."""
        with self._params_lock:
            params, fn = self.params, self._apply
        return self._score_direct(np.asarray(x, np.float32), params, fn)

    def _score_direct(self, x: np.ndarray, params: Any, fn: Any) -> np.ndarray:
        """Bucketed forwards of ``x`` with no history store involved: a
        2-D ``x`` becomes the newest row of an otherwise empty window of
        the ladder's shortest rung."""
        if x.ndim == 2:
            lb = self.len_buckets[0]
            h = np.zeros((len(x), lb, self.store.num_features), np.float32)
            h[:, -1] = x
            x = h
        n = len(x)
        out = np.empty((n,), np.float32)
        largest = self.batch_sizes[-1]
        start = 0
        while start < n:
            stop = min(start + largest, n)
            m = stop - start
            sub = x[start:stop]
            bucket = self._bucket(m)
            if m < bucket:
                sub = np.concatenate([sub, np.zeros((bucket - m, *sub.shape[1:]), np.float32)])
            xs = torch.from_numpy(np.ascontiguousarray(sub)).to(self.device)
            out[start:stop] = fn(params, xs)[:m].float().cpu().numpy()
            start = stop
        return out
