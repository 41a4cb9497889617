"""Launch counts of the port's CUDA kernels.

Each kernel wrapper owns one ``LaunchCounter`` and adds one where it
launches its kernel, and nowhere else; the plain version on a CPU tensor
does not count. The server's ``ccfd_kernel_launches{kernel=...}`` gauge and
``chip_smoke.py`` read the counts to show that the serving path went
through the kernels.
"""

from __future__ import annotations

import threading


class LaunchCounter:
    """Thread-safe count of one kernel's launches."""

    def __init__(self, kernel: str = "") -> None:
        self.kernel = kernel  # the name the gauge's ``kernel`` label carries
        self._lock = threading.Lock()
        self._n = 0

    def inc(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n
