"""Device & transfer telemetry: the measured side of the H2D/memory story.

The port of ccfd_tpu/observability/device.py on ``torch.cuda``:

- **Per-device memory gauges** — ``ccfd_device_memory_bytes{device,kind}``
  from the caching allocator of each CUDA device of this process
  (``torch.cuda.memory_stats``: ``bytes_in_use`` = allocated bytes now,
  ``peak_bytes_in_use`` = their peak, ``reserved_bytes`` = what the
  allocator holds from the driver) and ``torch.cuda.mem_get_info``
  (``bytes_limit`` = the card's memory, ``free_bytes``), in place of the
  reference's ``jax.local_devices()`` allocator stats. ``live_buffer_bytes``
  (the reference's ``jax.live_arrays()`` walk) is the allocated bytes:
  every live tensor's block. A process without CUDA reports no device.
- **Measured H2D transfer accounting** — the Scorer's staging copies
  (``serving/scorer.py``: one copy of the bf16/f32 rows, or two on the
  int8 wire, q and scale, as the reference's two puts) go through
  :func:`timed_copy`: on the card a pair of CUDA events brackets each copy
  on the stream, and :func:`settle_copies` reads their elapsed time once
  the dispatch has synchronized, so every copy is timed without blocking
  the host (the reference blocks on every ``sample_every``-th put). The
  bytes land in ``ccfd_h2d_bytes_total``, the times in the
  ``ccfd_h2d_seconds`` histogram and a
  :class:`~ccfd_tpu_torch.observability.profile.LatencyDigest` the SLO
  engine's budget ledger reads. A copy that raises counts in
  ``ccfd_h2d_put_failures_total``.
- **Executable inventory** — registered sources (the Scorer's kernel ×
  bucket grid with warmed buckets and dispatches per bucket, the decision
  plane's) rendered into one document.

One instance per platform (operator ``device:`` block, CCFD_DEVICE=0 kill
switch). ``set_default`` installs a process-default plane: a ``Scorer`` or
``SeqScorer`` built with ``telemetry=None`` records into it, as the
reference's do. ``peak_memory_bytes`` is the largest allocator peak
(``torch.cuda.max_memory_allocated``) over this process's devices. Not
carried over: the put sampling (``sample_every``: the port's events need
no host sync).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Mapping

from ccfd_tpu_torch.observability.profile import LatencyDigest

# H2D copies are µs..ms scale; the default request-latency ladder starts at
# 5 ms and would fold every transfer into the first bucket
H2D_BUCKETS = (25e-6, 1e-4, 5e-4, 1e-3, 5e-3, 0.025, 0.1, 0.5, 2.5)

_DEFAULT: "DeviceTelemetry | None" = None


def set_default(telemetry: "DeviceTelemetry | None") -> None:
    """Install a process-default telemetry plane (scorers built with
    ``telemetry=None`` pick it up). Pass None to clear."""
    global _DEFAULT
    _DEFAULT = telemetry


def get_default() -> "DeviceTelemetry | None":
    return _DEFAULT


class DeviceTelemetry:
    """Collects device memory, H2D transfer and executable-inventory
    evidence; see the module docstring. Thread-safe."""

    def __init__(self, registry=None):
        self.registry = registry
        self._mu = threading.Lock()
        self._h2d_digest = LatencyDigest()
        self._h2d_bytes = 0
        self._put_failures = 0
        self._sources: dict[str, Callable[[], Any]] = {}
        self._g_mem = self._c_bytes = self._h_seconds = None
        self._c_put_fail = None
        if registry is not None:
            self._g_mem = registry.gauge(
                "ccfd_device_memory_bytes",
                "per-device memory by kind: the CUDA caching allocator's "
                "bytes_in_use/peak_bytes_in_use/reserved_bytes, the card's "
                "bytes_limit/free_bytes, and live_buffer_bytes (= bytes_in_use)",
            )
            self._c_bytes = registry.counter(
                "ccfd_h2d_bytes_total",
                "bytes staged host->device on the scorer dispatch path "
                "(measured, not estimated; CPU runs count the same copies)",
            )
            self._h_seconds = registry.histogram(
                "ccfd_h2d_seconds",
                "device time of one host->device staging copy on the scorer "
                "dispatch path (CUDA events around the copy)",
                buckets=H2D_BUCKETS,
            )
            self._c_put_fail = registry.counter(
                "ccfd_h2d_put_failures_total",
                "host->device staging copies that raised",
            )

    # -- H2D transfer accounting ------------------------------------------
    def record_h2d(self, nbytes: int, seconds: float | None = None) -> None:
        """One staging transfer: ``nbytes`` always counts; ``seconds``
        (when the copy was timed) additionally lands in the histogram and
        the ledger's digest."""
        with self._mu:
            self._h2d_bytes += int(nbytes)
            if seconds is not None:
                self._h2d_digest.add(float(seconds))
        if self._c_bytes is not None:
            self._c_bytes.inc(int(nbytes))
            if seconds is not None:
                self._h_seconds.observe(float(seconds))

    def h2d_bytes(self) -> int:
        with self._mu:
            return self._h2d_bytes

    def h2d_count(self) -> int:
        with self._mu:
            return self._h2d_digest.count

    def h2d_digest(self) -> LatencyDigest:
        """A consistent copy of the per-transfer digest: what the
        BudgetLedger's ``h2d`` layer reads when this plane is armed."""
        with self._mu:
            return self._h2d_digest.copy()

    def record_h2d_failure(self) -> None:
        """One failed staging copy (the copy raised before bytes landed)."""
        with self._mu:
            self._put_failures += 1
        if self._c_put_fail is not None:
            self._c_put_fail.inc()

    def h2d_failures(self) -> int:
        with self._mu:
            return self._put_failures

    # -- device memory ------------------------------------------------------
    @staticmethod
    def device_memory() -> dict[str, dict[str, int]]:
        """Per-device memory stats of this process's CUDA devices, {} when
        CUDA is not available, with the injected ``device_oom`` pressure
        laid over them while a device-fault plan carries it."""
        import torch

        out: dict[str, dict[str, int]] = {}
        for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
            entry: dict[str, int] = {}
            try:
                stats = torch.cuda.memory_stats(i)
                free, total = torch.cuda.mem_get_info(i)
            # ccfd-lint: disable=counted-drops -- the empty entry lands in the snapshot: a device whose stats failed reads as absent keys on the board
            except Exception:  # noqa: BLE001 - telemetry must never raise
                out[f"cuda:{i}"] = entry
                continue
            entry["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
            entry["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
            entry["reserved_bytes"] = int(stats.get("reserved_bytes.all.current", 0))
            entry["bytes_limit"] = int(total)
            entry["free_bytes"] = int(free)
            entry["live_buffer_bytes"] = entry["bytes_in_use"]
            out[f"cuda:{i}"] = entry
        # injected allocator pressure (runtime/faults.py device_oom): the
        # synthetic bytes ride the keys the allocator reports, so the heal
        # supervisor's math is the same; on a process without CUDA the
        # overlay stands for the CPU device (``cpu:0``), so the signal is
        # drillable there too
        from ccfd_tpu_torch.runtime.faults import device_oom_overlay

        ratio = device_oom_overlay()
        if ratio is not None:
            if not out:
                out["cpu:0"] = {"live_buffer_bytes": 0}
            limit = 16 * 1024**3  # a plausible size; only the RATIO matters
            for entry in out.values():
                entry.setdefault("bytes_limit", limit)
                entry["bytes_in_use"] = int(ratio * entry.get("bytes_limit", limit))
        return out

    def peak_memory_bytes(self) -> int | None:
        """The largest allocator peak over this process's CUDA devices;
        None without CUDA."""
        peaks = [e["peak_bytes_in_use"] for e in self.device_memory().values()
                 if "peak_bytes_in_use" in e]
        return max(peaks) if peaks else None

    def refresh(self, mem: Mapping[str, Mapping[str, int]] | None = None) -> None:
        """Refresh the memory gauges (the exporter scrape is the sampling
        clock, as for the RSS gauge)."""
        if self._g_mem is None:
            return
        if mem is None:
            mem = self.device_memory()
        for device, kinds in mem.items():
            for kind, val in kinds.items():
                self._g_mem.set(float(val), labels={"device": device, "kind": kind})

    # -- executable inventory -----------------------------------------------
    def register_executable_source(self, name: str, fn: Callable[[], Any]) -> None:
        """``fn()`` -> a JSON-safe description of a component's warmed
        kernel × bucket set (the Scorer's grid, the decision plane's)."""
        with self._mu:
            self._sources[name] = fn

    def executable_inventory(self) -> dict[str, Any]:
        with self._mu:
            sources = dict(self._sources)
        out: dict[str, Any] = {}
        for name, fn in sources.items():
            try:
                out[name] = fn()
            # ccfd-lint: disable=counted-drops -- the error string lands IN the snapshot: recorded evidence, not a swallow
            except Exception as e:  # noqa: BLE001 - a dead source is evidence
                out[name] = {"error": repr(e)[:120]}
        return out

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """The /debug/device document: memory, H2D accounting, inventory."""
        mem = self.device_memory()
        self.refresh(mem)
        with self._mu:
            h2d = {
                "bytes_total": self._h2d_bytes,
                "failures": self._put_failures,
                "transfer": self._h2d_digest.to_dict(),
            }
        return {"memory": mem, "h2d": h2d, "executables": self.executable_inventory()}


def timed_copy(telemetry: "DeviceTelemetry | None", host, device) -> tuple:
    """Copy one staging tensor to ``device`` (``non_blocking``) ->
    ``(device tensor, token)``. With telemetry, a CUDA event pair
    brackets the copy on the current stream (on the CPU the host clock);
    pass the tokens to :func:`settle_copies` once the stream has
    synchronized. A copy that raises counts as a failure and re-raises,
    an injected ``put_fail`` (runtime/faults.py) included. Without
    telemetry the token is None and nothing is timed."""
    from ccfd_tpu_torch.runtime.faults import device_seam

    if telemetry is None:
        device_seam("put")
        return host.to(device, non_blocking=True), None
    import torch

    nbytes = host.numel() * host.element_size()
    try:
        # the device-fault staging seam (runtime/faults.py put_fail): an
        # injected failure raises here, before the copy, so it counts in
        # h2d_failures() as a real failed copy does and adds no bytes
        device_seam("put")
        if device.type == "cuda":
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(device)
            ev0.record(stream)
            out = host.to(device, non_blocking=True)
            ev1.record(stream)
            return out, (nbytes, ev0, ev1)
        t0 = time.perf_counter()
        out = host.to(device, non_blocking=True)
        return out, (nbytes, time.perf_counter() - t0)
    except Exception:
        telemetry.record_h2d_failure()
        raise


def settle_copies(telemetry: "DeviceTelemetry | None", tokens) -> None:
    """Feed the bytes and times of finished :func:`timed_copy` tokens (their
    stream synchronized) to ``telemetry``."""
    if telemetry is None:
        return
    for tok in tokens:
        if tok is None:
            continue
        if len(tok) == 3:
            nbytes, ev0, ev1 = tok
            telemetry.record_h2d(nbytes, ev0.elapsed_time(ev1) / 1e3)
        else:
            telemetry.record_h2d(*tok)
