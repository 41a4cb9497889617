"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles, at first use, into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/ccfd_tpu_torch/<name>-<hash>.so

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source never loads a stale
build. ``build`` starts one nvcc per source not
built yet, all at once, and waits for them all. What ``-Xptxas -v`` printed
(registers, shared memory, spills per kernel) is kept in ``ptxas_log``.
Each nvcc run that succeeds counts as one build in the stage profiler
(``observability/profile.py::record_build``), the port's counterpart of the
reference's XLA compile events.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ccfd_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("fused_mlp", "fused_mlp_q8")  # every kernel library of the port

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on PATH, else the
    toolkit's usual place. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels build from ops/csrc at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: "tuple[str, ...] | list[str]" = SOURCES) -> None:
    """Compile each ``ops/csrc/<name>.cu`` not built yet, one nvcc each,
    all started together. Raises ``RuntimeError`` with the compiler's
    output when a build fails (after every nvcc has ended)."""
    with _lock:
        todo = [(n, _target(n)) for n in names if not _target(n).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs = []
        for name, target in todo:
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append((name, target, tmp, proc))
        failed = []
        for name, target, tmp, proc in procs:
            out, _ = proc.communicate()
            ptxas_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            else:
                # ccfd-lint: disable=durability-seam -- kernel library install: a rebuildable cache keyed by its source hash, not platform state
                os.replace(tmp, target)
                from ccfd_tpu_torch.observability.profile import record_build

                record_build(time.perf_counter() - t0)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Compile ``ops/csrc/<name>.cu`` (where not built yet) and load it.

    Raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    build([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_target(name)))
        return _loaded[name]
