"""Network-edge fault injection: degraded RPC hops, seeded and installable.

The port's copy of the edge half of ccfd_tpu/runtime/faults.py. The far
more common production failure than a dead component is a *sick edge* — a
scorer endpoint that answers slowly, a partitioned bus, a flaky engine hop.
This module makes degraded edges injectable on the client hops the router
role owns — router->scorer (``serving/client.py`` or the local score_fn)
and router->engine (``process/client.py``) — so the circuit breaker and
the router's degradation ladder (``runtime/breaker.py``,
``router/router.py``) are exercised instead of trusted.

Model: a ``FaultPlan`` maps edge names to ``FaultSpec``s (latency + jitter,
error rate, blackhole/partition, corrupt-response, slow-drip) and is parsed
from ``CCFD_FAULTS``::

    CCFD_FAULTS="scorer:latency=50,jitter=20,error=0.05;engine:blackhole"

A ``FaultInjector`` binds one edge of the plan around a client (or a bare
callable) and perturbs every call while the plan is ACTIVE. Plans are
seeded: an edge's RNG seeds from ``seed ^ crc32(edge)``, so the same plan
draws the same delays, errors and corruptions as the reference's, call for
call. Each perturbation counts in ``faults_injected_total{edge,kind}``.

Injected failures raise :class:`InjectedFault` (a ``ConnectionError``), so
every client's transport-error handling — retries, breakers, the router's
tier ladder — engages exactly as it would for the real thing.

Still to port, with the platform operator and the heal gate that arm them
(ROADMAP A6, A7): the device fault plans (``device_hang``,
``compile_stall``, ``device_oom``, ``put_fail``), the storage fault plans
that ``runtime/durability.py`` draws from, and the ChaosMonkey's storm
schedule.
"""

from __future__ import annotations

import binascii
import random
import threading
import time
from typing import Any, Callable, Iterable, Mapping

import numpy as np


class InjectedFault(ConnectionError):
    """A fault-plan failure. Subclasses ConnectionError so client retry /
    breaker paths treat it exactly like a real transport error."""


# fault kinds a spec can carry; parse-time validation names them
_KINDS = ("latency", "jitter", "error", "blackhole", "corrupt", "drip",
          "stall")


class FaultSpec:
    """One edge's degradation profile. All times in milliseconds.

    - ``latency_ms`` fixed added delay per call
    - ``jitter_ms`` extra uniform delay in [0, jitter_ms)
    - ``error_rate`` probability a call raises :class:`InjectedFault`
    - ``blackhole`` the peer is partitioned: every call stalls ``stall_ms``
      (the SYN-timeout analog, bounded so tests stay fast) then raises
    - ``corrupt_rate`` probability a *response* comes back mangled (float
      arrays go NaN — silent corruption the validation layers must catch;
      anything else raises, the decode-error analog)
    - ``drip_ms`` slow drip: added delay GROWS by drip_ms per call while
      the plan is active (a degrading endpoint), capped at ``drip_cap_ms``
    """

    __slots__ = ("latency_ms", "jitter_ms", "error_rate", "blackhole",
                 "corrupt_rate", "drip_ms", "drip_cap_ms", "stall_ms")

    def __init__(
        self,
        latency_ms: float = 0.0,
        jitter_ms: float = 0.0,
        error_rate: float = 0.0,
        blackhole: bool = False,
        corrupt_rate: float = 0.0,
        drip_ms: float = 0.0,
        drip_cap_ms: float = 1000.0,
        stall_ms: float = 250.0,
    ):
        if not 0.0 <= error_rate <= 1.0:
            raise ValueError(f"error_rate {error_rate} outside [0, 1]")
        if not 0.0 <= corrupt_rate <= 1.0:
            raise ValueError(f"corrupt_rate {corrupt_rate} outside [0, 1]")
        for name, v in (("latency_ms", latency_ms), ("jitter_ms", jitter_ms),
                        ("drip_ms", drip_ms), ("drip_cap_ms", drip_cap_ms),
                        ("stall_ms", stall_ms)):
            if v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        self.latency_ms = float(latency_ms)
        self.jitter_ms = float(jitter_ms)
        self.error_rate = float(error_rate)
        self.blackhole = bool(blackhole)
        self.corrupt_rate = float(corrupt_rate)
        self.drip_ms = float(drip_ms)
        self.drip_cap_ms = float(drip_cap_ms)
        self.stall_ms = float(stall_ms)

    @staticmethod
    def parse(body: str) -> "FaultSpec":
        """``"latency=50,jitter=20,error=0.1,blackhole"`` -> FaultSpec.
        Bare ``blackhole``/``corrupt`` flags take their default strength."""
        kw: dict[str, Any] = {}
        for item in body.split(","):
            item = item.strip()
            if not item:
                continue
            key, sep, val = item.partition("=")
            key = key.strip()
            if key not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {key!r}; known: {_KINDS}")
            if key == "blackhole":
                kw["blackhole"] = (val.strip().lower()
                                   not in ("0", "false", "no")
                                   if sep else True)
            elif key == "corrupt":
                kw["corrupt_rate"] = float(val) if sep else 1.0
            elif key == "error":
                kw["error_rate"] = float(val)
            elif key == "stall":
                kw["stall_ms"] = float(val)
            else:  # latency / jitter / drip
                kw[f"{key}_ms"] = float(val)
        return FaultSpec(**kw)

    def __repr__(self) -> str:  # debugging / soak reports
        parts = [f"{k}={getattr(self, k)}" for k in self.__slots__
                 if getattr(self, k)]
        return f"FaultSpec({', '.join(parts)})"


class FaultPlan:
    """Edge name -> FaultSpec, with a thread-safe activation toggle.

    ``"*"`` is the wildcard edge (applies to any edge without its own
    spec). A plan parsed from env starts ACTIVE (the operator asked for
    standing degradation); a plan handed to the ChaosMonkey for storm
    scheduling is usually built with ``active=False`` and toggled.
    """

    def __init__(self, specs: Mapping[str, FaultSpec] | None = None,
                 seed: int = 0, active: bool = True):
        self.specs = dict(specs or {})
        self.seed = int(seed)
        self._active = threading.Event()
        if active:
            self._active.set()
        self.activations = 0

    @staticmethod
    def from_string(text: str, seed: int = 0,
                    active: bool = True) -> "FaultPlan":
        """``"edge:kind=v,kind;edge2:kind"`` -> FaultPlan. Empty text means
        an empty (no-op) plan."""
        specs: dict[str, FaultSpec] = {}
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            edge, sep, body = part.partition(":")
            edge = edge.strip()
            if not edge or not sep:
                raise ValueError(
                    f"CCFD_FAULTS entry {part!r}: expected edge:spec")
            specs[edge] = FaultSpec.parse(body)
        return FaultPlan(specs, seed=seed, active=active)

    @staticmethod
    def from_env(env: Mapping[str, str] | None = None,
                 seed: int = 0) -> "FaultPlan":
        import os

        e = os.environ if env is None else env
        return FaultPlan.from_string(e.get("CCFD_FAULTS", ""), seed=seed)

    # -- activation (ChaosMonkey storm windows) ---------------------------
    @property
    def active(self) -> bool:
        return self._active.is_set()

    def activate(self) -> None:
        self.activations += 1
        self._active.set()

    def deactivate(self) -> None:
        self._active.clear()

    def spec_for(self, edge: str) -> FaultSpec | None:
        return self.specs.get(edge) or self.specs.get("*")

    def injector(self, edge: str, registry=None) -> "FaultInjector | None":
        """Injector bound to one edge, or None when the plan has nothing
        for it — callers then skip wrapping entirely (zero overhead)."""
        spec = self.spec_for(edge)
        if spec is None:
            return None
        return FaultInjector(self, edge, spec, registry=registry)


class FaultInjector:
    """Applies one edge's FaultSpec around calls.

    Deterministic per (plan seed, edge): the RNG seeds from
    ``seed ^ crc32(edge)`` so two runs with the same plan draw the same
    error sequence per edge regardless of edge iteration order.
    """

    def __init__(self, plan: FaultPlan, edge: str, spec: FaultSpec,
                 registry=None):
        self.plan = plan
        self.edge = edge
        self.spec = spec
        self._rng = random.Random(
            plan.seed ^ binascii.crc32(edge.encode()))
        self._mu = threading.Lock()
        self._calls_active = 0  # drip ramp position
        self.injected = 0       # lifetime count, any kind
        self._c_injected = None
        if registry is not None:
            self._c_injected = registry.counter(
                "faults_injected_total",
                "fault-plan perturbations by edge and kind",
            )

    def _count(self, kind: str) -> None:
        self.injected += 1
        if self._c_injected is not None:
            self._c_injected.inc(labels={"edge": self.edge, "kind": kind})

    def before(self) -> bool:
        """Pre-call perturbation: delay, blackhole, error draw. Returns
        whether the caller should corrupt the response (pass the flag to
        :meth:`after` — per-call state stays on the caller's stack so
        concurrent calls through one injector don't cross-attribute)."""
        if not self.plan.active:
            with self._mu:
                self._calls_active = 0  # drip ramp resets between storms
            return False
        s = self.spec
        with self._mu:
            n = self._calls_active
            self._calls_active = n + 1
            jitter = self._rng.random() * s.jitter_ms
            err_draw = self._rng.random()
            corrupt = self._rng.random() < s.corrupt_rate
        delay_ms = s.latency_ms + jitter + min(s.drip_ms * n, s.drip_cap_ms)
        if delay_ms > 0:
            self._count("latency")
            time.sleep(delay_ms / 1e3)
        if s.blackhole:
            self._count("blackhole")
            time.sleep(s.stall_ms / 1e3)
            raise InjectedFault(
                f"edge {self.edge!r} blackholed (injected partition)")
        if err_draw < s.error_rate:
            self._count("error")
            raise InjectedFault(f"edge {self.edge!r} injected error")
        return corrupt

    def after(self, result: Any, corrupt: bool) -> Any:
        """Post-call perturbation: corrupt the response in flight."""
        if not corrupt or not self.plan.active:
            return result
        self._count("corrupt")
        if isinstance(result, np.ndarray) and np.issubdtype(
                result.dtype, np.floating):
            # silent corruption: the payload decodes but the numbers are
            # garbage — exactly what response validation must catch
            return np.full_like(result, np.nan)
        raise InjectedFault(
            f"edge {self.edge!r} returned an undecodable response "
            "(injected corruption)")

    def run(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        corrupt = self.before()
        return self.after(fn(*args, **kwargs), corrupt)

    def wrap_fn(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        """Bare-callable edge (e.g. the router's in-process score_fn)."""
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            return self.run(fn, *args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped

    def wrap(self, obj: Any, methods: Iterable[str] | None = None) -> Any:
        """Proxy an object, perturbing the named public methods (all public
        callables when ``methods`` is None). Everything else delegates, so
        the proxy keeps the wrapped client's full surface (e.g. the
        router's ``definitions`` probe on an engine)."""
        from ccfd_tpu_torch.runtime.breaker import MethodProxy

        return MethodProxy(obj, self.run,
                           frozenset(methods) if methods else None)
