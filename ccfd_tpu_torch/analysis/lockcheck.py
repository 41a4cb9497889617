"""Runtime lock-order sanitizer: the dynamic half of the lock-order rule.

The port's copy of ccfd_tpu/analysis/lockcheck.py. The static rule
(analysis/rules.py) sees lexically nested ``with`` sites; it cannot see an
inversion that happens through a method call made while holding a lock,
the shape of the races only live kill-storm drills caught. This module is
lockdep-lite for those: with ``CCFD_LOCKCHECK=1`` (:func:`armed_from_env`),
:func:`install` replaces ``threading.Lock``/``threading.RLock`` with a
factory that wraps every lock constructed FROM THEN ON in a checked
proxy. Each acquisition records, per thread, the edge (every lock
currently held) -> (lock being acquired) into one process-global
acquisition-order graph; the first edge that closes a cycle is a proven
ordering inversion, two interleavings away from a deadlock, and fails
the process right there (:class:`LockOrderError`), instead of hanging a
soak later.

Design notes:

- **Per-instance nodes.** Aggregating by construction site would flag
  two shard locks of the same stripe acquired in address order as a
  self-cycle. Per-instance edges only ever flag inversions that two real
  lock objects actually exhibited. Node ids are monotonic tokens, not
  ``id()``: CPython recycles addresses after GC.
- **Reentrancy.** Re-acquiring an RLock already held by this thread adds
  no edge (it cannot deadlock against itself).
- **Condition compatibility.** ``threading.Condition`` reaches the
  protocol methods (``_release_save``/``_acquire_restore``/``_is_owned``)
  through ``__getattr__`` delegation to the real lock, so ``wait()``
  bypasses the tracker symmetrically on release and re-acquire: the
  bookkeeping still matches the logical held-state on both sides of the
  wait.
- **Hot-path cost.** The common case (acquire with nothing held, or an
  edge already known) touches only a thread-local list and a frozenset
  lookup; the global mutex is taken only for NEW edges, which are O(lock
  pairs) per process lifetime.

Nothing arms it at import; a test fixture or a drill calls :func:`install`
when :func:`armed_from_env` says so (tests/test_torch_lint.py exercises it).
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import traceback
from typing import Any

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


class LockOrderError(RuntimeError):
    """Two locks were acquired in opposite orders by different paths."""


def raw_lock():
    """An UNchecked lock, regardless of install state — for the
    sanitizer's own internals and for tests that build deliberate
    inversions against a private graph without tripping the global one."""
    return _REAL_LOCK()


def raw_rlock():
    return _REAL_RLOCK()


class LockGraph:
    """One acquisition-order graph + its violation log. The module holds
    a global instance for :func:`install`; tests construct their own and
    wrap locks explicitly via :meth:`wrap`."""

    def __init__(self, raise_on_cycle: bool = True):
        self.raise_on_cycle = raise_on_cycle
        self._mu = _REAL_LOCK()
        self._tokens = itertools.count(1)
        self._labels: dict[int, str] = {}
        self._adj: dict[int, set[int]] = {}
        # frozen read-mostly view for the lock-free fast path: rebuilt on
        # every new edge (rare), read on every nested acquire (hot)
        self._known_edges: frozenset[tuple[int, int]] = frozenset()
        self._tls = threading.local()
        self.violations: list[dict[str, Any]] = []

    # -- wrapping ----------------------------------------------------------
    def new_token(self, label: str) -> int:
        with self._mu:
            tok = next(self._tokens)
            self._labels[tok] = label
        return tok

    def wrap(self, lock: Any, label: str) -> "_CheckedLock":
        return _CheckedLock(lock, self, self.new_token(label))

    # -- per-thread held stack ---------------------------------------------
    def _held(self) -> list[int]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    def note_acquired(self, token: int) -> None:
        held = self._held()
        if token in held:  # RLock reentry: no edge, no deadlock potential
            held.append(token)
            return
        new_edges = [
            (h, token) for h in dict.fromkeys(held)
            if (h, token) not in self._known_edges
        ]
        held.append(token)
        if not new_edges:
            return
        with self._mu:
            for a, b in new_edges:
                self._adj.setdefault(a, set()).add(b)
            cycle = None
            bad_edge = None
            for a, b in new_edges:
                cycle = self._cycle_through(b, a)
                if cycle:
                    cycle = cycle + [b]
                    bad_edge = (a, b)
                    break
            if self.raise_on_cycle and bad_edge is not None:
                # un-commit the cycle-closing edge: detection must not be
                # one-shot — a REPEAT of the same inversion (e.g. after a
                # broad except swallowed the first LockOrderError) has to
                # re-detect and re-raise, not ride the known-edge fast
                # path straight into the real deadlock
                self._adj[bad_edge[0]].discard(bad_edge[1])
            self._known_edges = frozenset(
                (a, b) for a, nbrs in self._adj.items() for b in nbrs)
            if cycle is None:
                return
            names = [self._labels.get(t, f"lock#{t}") for t in cycle]
            violation = {
                "cycle": names,
                "thread": threading.current_thread().name,
                "stack": "".join(traceback.format_stack(limit=12)[:-2]),
            }
            self.violations.append(violation)
        print(
            "[ccfd-lockcheck] lock-order inversion: "
            + " -> ".join(names)
            + f" (thread {violation['thread']})",
            file=sys.stderr,
        )
        if self.raise_on_cycle:
            # undo the held-stack push: the proxy releases the real lock
            # before propagating, so the bookkeeping must match
            self.note_released(token)
            raise LockOrderError(
                "lock-order inversion: " + " -> ".join(names))

    def note_released(self, token: int) -> None:
        held = self._held()
        # release order need not mirror acquire order; drop the LAST
        # occurrence (matches RLock reentry bookkeeping)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == token:
                del held[i]
                return

    def _cycle_through(self, src: int, dst: int) -> list[int] | None:
        """A path src ~> dst in the edge graph (call under self._mu).
        Adding dst->src then closes the cycle the caller reports."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._adj.get(node, ()):
                if nxt == dst:
                    return path + [dst]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


class _CheckedLock:
    """Delegating lock proxy. Everything not overridden falls through to
    the real lock — including the Condition protocol methods, which MUST
    bypass tracking (see module docstring)."""

    __slots__ = ("_ccfd_inner", "_ccfd_graph", "_ccfd_token")

    def __init__(self, inner: Any, graph: LockGraph, token: int):
        object.__setattr__(self, "_ccfd_inner", inner)
        object.__setattr__(self, "_ccfd_graph", graph)
        object.__setattr__(self, "_ccfd_token", token)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._ccfd_inner.acquire(blocking, timeout)
        if got:
            try:
                self._ccfd_graph.note_acquired(self._ccfd_token)
            except LockOrderError:
                # never leave the real lock held behind a raising acquire:
                # the caller's `with` will not run __exit__
                self._ccfd_inner.release()
                raise
        return got

    def release(self) -> None:
        self._ccfd_inner.release()
        self._ccfd_graph.note_released(self._ccfd_token)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        return self._ccfd_inner.locked()

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_ccfd_inner"), name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<CheckedLock #{self._ccfd_token} "
                f"wrapping {self._ccfd_inner!r}>")


# -- global install surface --------------------------------------------------

_global_graph: LockGraph | None = None


def _caller_label() -> str:
    """Construction site of the lock being created: the first frame
    outside this module and threading.py. Diagnostic only — identity is
    the per-instance token."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(("lockcheck.py", "threading.py")):
            rel = fn
            for marker in ("ccfd_tpu_torch/", "tests/", "tools/"):
                i = fn.rfind(marker)
                if i >= 0:
                    rel = fn[i:]
                    break
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"  # pragma: no cover


def install(raise_on_cycle: bool = True,
            scope: tuple[str, ...] = ("ccfd_tpu_torch/",)) -> LockGraph:
    """Arm the sanitizer process-wide: locks constructed after this call
    FROM CODE MATCHING ``scope`` (substring of the constructing frame's
    filename) are checked; everything else (torch internals, stdlib
    machinery like queue.Queue) gets a real lock, keeping foreign lock
    graphs out of ours and the overhead on our own code only. Idempotent;
    returns the global graph."""
    global _global_graph
    if _global_graph is not None:
        return _global_graph
    graph = LockGraph(raise_on_cycle=raise_on_cycle)
    _global_graph = graph

    def _in_scope() -> str | None:
        """Constructing site when it falls under ``scope``, else None."""
        label = _caller_label()
        return label if any(m in label for m in scope) else None

    def make_lock() -> Any:
        site = _in_scope()
        if site is None:
            return _REAL_LOCK()
        return _CheckedLock(_REAL_LOCK(), graph, graph.new_token(site))

    def make_rlock() -> Any:
        site = _in_scope()
        if site is None:
            return _REAL_RLOCK()
        return _CheckedLock(_REAL_RLOCK(), graph, graph.new_token(site))

    threading.Lock = make_lock  # type: ignore[assignment]
    threading.RLock = make_rlock  # type: ignore[assignment]
    return graph


def uninstall() -> None:
    """Restore the real factories. Already-wrapped locks keep working
    (their graph just stops gaining edges that matter)."""
    global _global_graph
    threading.Lock = _REAL_LOCK  # type: ignore[assignment]
    threading.RLock = _REAL_RLOCK  # type: ignore[assignment]
    _global_graph = None


def installed() -> bool:
    return _global_graph is not None


def violations() -> list[dict[str, Any]]:
    """Inversions the global sanitizer has recorded (empty when healthy
    or not armed)."""
    return list(_global_graph.violations) if _global_graph else []


def armed_from_env() -> bool:
    return bool(os.environ.get("CCFD_LOCKCHECK"))
