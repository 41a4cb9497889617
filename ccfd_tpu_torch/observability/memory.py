"""Memory evidence for the exporter: RSS, GC counts, per-component object
counts and tracemalloc's top allocators.

The port's copy of ccfd_tpu/observability/memory.py. Every scrape gauges
the process RSS (``ccfd_process_rss_bytes``); ``GET /memory`` returns
:func:`memory_report`, with the allocator table once ``?trace=1`` armed
tracemalloc (which roughly doubles allocation cost, so it is off until
asked for).
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Mapping


def rss_bytes() -> int:
    """Resident set size from /proc (Linux); 0 where unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def ensure_tracemalloc(nframes: int = 5) -> bool:
    """Arm allocation tracing (idempotent); returns whether it is on."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start(nframes)
    return tracemalloc.is_tracing()


def tracemalloc_top(limit: int = 15) -> list[dict[str, Any]]:
    """Top allocation sites by retained bytes; [] when tracing is off."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        return []
    snap = tracemalloc.take_snapshot().filter_traces((
        tracemalloc.Filter(False, "<frozen importlib._bootstrap>"),
        tracemalloc.Filter(False, tracemalloc.__file__),
    ))
    return [{"file": s.traceback[0].filename, "line": s.traceback[0].lineno,
             "size_bytes": s.size, "count": s.count}
            for s in snap.statistics("lineno")[:limit]]


def memory_report(probes: Mapping[str, Callable[[], float]] | None = None,
                  top: int = 15) -> dict[str, Any]:
    """The /memory body. ``probes`` maps a component to a live-object-count
    callable; a probe that raises reads -1."""
    import tracemalloc

    components: dict[str, float] = {}
    for name, fn in (probes or {}).items():
        try:
            components[name] = float(fn())
        # ccfd-lint: disable=counted-drops -- the -1 sentinel lands in the scraped gauge: a dead component is visible evidence, not a swallow
        except Exception:  # noqa: BLE001 - a broken probe reads -1, visibly
            components[name] = -1.0
    report: dict[str, Any] = {
        "rss_bytes": rss_bytes(),
        "gc": {"counts": gc.get_count(), "garbage": len(gc.garbage)},
        "components": components,
        "tracemalloc": {"tracing": tracemalloc.is_tracing(), "top": tracemalloc_top(top)},
    }
    if tracemalloc.is_tracing():
        # the full object walk rides the same opt-in as the allocator table
        report["gc"]["tracked_objects"] = len(gc.get_objects())
        cur, peak = tracemalloc.get_traced_memory()
        report["tracemalloc"]["traced_bytes"] = cur
        report["tracemalloc"]["peak_bytes"] = peak
    return report
