"""The port's native (C++) host path, loaded with ctypes: the port of
ccfd_tpu/native/__init__.py.

Three sources, copies of the reference's, build into one library:

- ``decode.cpp``: ``decode_csv`` (the router's CSV wire), ``decode_ndarray_json``
  (the canonical Seldon predict payload, for the REST handler) and
  ``pad_batch``;
- ``httpfront.cpp``: the epoll REST front that ``serving/native_front.py``
  drives (``lib()`` hands it the loaded library), without the reference's
  in-front host model;
- ``log.cpp``: ``frame_records`` and ``scan_records``, the durable bus
  log's ``[u32 len][u32 crc32][payload]`` framing and its replay scan
  (``bus/log.py``).

**The build.** g++ (or ``$CXX``) compiles the sources at first use::

    g++ -O3 -march=$CCFD_NATIVE_MARCH|native -shared -fPIC -pthread
        decode.cpp httpfront.cpp log.cpp
        -o build/ccfd_tpu_torch/ccfd_native-<hash>.so

as the reference does. The file name carries a hash of the sources, the
compiler, the flags and the target they resolve to (the compiler's
predefined macros under that ``-march``, which name the instruction sets),
so an edited source never loads a stale build, and a build directory
carried to a CPU with other instruction sets never loads a library built
for the first.
There is no fallback: where the reference drops to numpy when g++ fails,
here a failed build raises ``RuntimeError`` with the compiler's output.
``build_seconds`` holds how long this process's build took (0.0 when it
found the library built).

The plain versions of the functions (``_decode_csv_numpy``,
``_decode_ndarray_json_numpy``, ``_pad_batch_numpy``, ``_frame_records_py``,
``_scan_records_py``) have the same semantics and are the tests' reference;
nothing in the port calls them.
``strtof`` rounds a decimal once where ``float()`` and a float32 cast round
twice, so the two agree to the reference's test bar (rtol 1e-5, atol 1e-6),
not bit for bit.
"""

from __future__ import annotations

import binascii
import ctypes
import hashlib
import json
import os
import struct
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ccfd_tpu_torch.ops._build import BUILD_DIR

HERE = Path(__file__).resolve().parent
SOURCES = ("decode.cpp", "httpfront.cpp", "log.cpp")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_targets: dict[tuple[str, str], bytes] = {}
build_seconds = 0.0


def compiler() -> str:
    return os.environ.get("CXX", "").strip() or "g++"


def flags() -> tuple[str, ...]:
    # CCFD_NATIVE_MARCH overrides the target microarchitecture, as in the
    # reference: an image built on one CPU and run on another must not bake
    # the build machine's -march=native (x86-64-v3 is the portable AVX2 choice)
    march = os.environ.get("CCFD_NATIVE_MARCH", "").strip() or "native"
    return ("-O3", f"-march={march}", "-shared", "-fPIC", "-pthread")


def build_command(target: Path) -> list[str]:
    return [compiler(), *flags(), *(str(HERE / s) for s in SOURCES), "-o", str(target)]


def _target(cxx: str, march_flag: str) -> bytes:
    """The predefined macros ``cxx`` sets under ``march_flag`` (``-dM -E``,
    which g++ and clang++ both take): the instruction sets the build will
    use."""
    key = (cxx, march_flag)
    if key not in _targets:
        cmd = [cxx, "-x", "c++", march_flag, "-dM", "-E", "-"]
        try:
            proc = subprocess.run(cmd, input="", capture_output=True, text=True, timeout=60)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native build: {' '.join(cmd)} did not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native build: {' '.join(cmd)} exited "
                               f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
        _targets[key] = "\n".join(sorted(proc.stdout.splitlines())).encode()
    return _targets[key]


def library_path() -> Path:
    """Where the library for the current sources, compiler, flags and
    resolved target lives."""
    fl = flags()
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((HERE / s).read_bytes())
    h.update(" ".join((compiler(), *fl)).encode())
    h.update(_target(compiler(), next(f for f in fl if f.startswith("-march="))))
    return BUILD_DIR / f"ccfd_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library where it is not built yet; returns its path.
    Raises ``RuntimeError`` with the compiler's output when the build fails."""
    global build_seconds
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = build_command(tmp)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native build: {' '.join(cmd)} did not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {' '.join(cmd)} exited "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builds each write their own tmp
    build_seconds = time.perf_counter() - t0
    from ccfd_tpu_torch.observability.profile import record_build

    record_build(build_seconds)  # the stage profiler's build attribution
    return target


def _declare(lib: ctypes.CDLL) -> None:
    c_int, c_long, c_double = ctypes.c_int, ctypes.c_long, ctypes.c_double
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    sig = {
        "ccfd_decode_csv": (c_int, [ctypes.c_char_p, ctypes.c_size_t, fp, c_int, c_int, ip]),
        "ccfd_decode_ndarray": (c_int, [ctypes.c_char_p, ctypes.c_size_t, fp, c_int, c_int,
                                        ip]),
        "ccfd_pad_batch": (None, [fp, c_int, c_int, fp, c_int]),
        "ccfd_front_create": (ctypes.c_void_p, [ctypes.c_char_p, c_int, c_int,
                                                ctypes.c_char_p, ip]),
        "ccfd_front_take": (c_int, [ctypes.c_void_p, fp, c_int, ip,
                                    ctypes.POINTER(c_double), c_int, c_int]),
        "ccfd_front_respond": (None, [ctypes.c_void_p, ip, ip, c_int, fp, ctypes.c_char_p]),
        "ccfd_front_take_misc": (c_int, [ctypes.c_void_p, ctypes.c_char_p, c_int,
                                         ctypes.c_char_p, c_int,
                                         ctypes.POINTER(ctypes.c_void_p), ip, c_int]),
        "ccfd_front_free": (None, [ctypes.c_void_p]),
        "ccfd_front_respond_misc": (None, [ctypes.c_void_p, c_int, c_int, ctypes.c_char_p,
                                           ctypes.c_char_p, c_int]),
        "ccfd_front_stats": (None, [ctypes.c_void_p, ctypes.POINTER(c_long)]),
        "ccfd_front_stop": (None, [ctypes.c_void_p]),
        "ccfd_front_destroy": (None, [ctypes.c_void_p]),
        "ccfd_log_frame": (ctypes.c_size_t, [ctypes.c_char_p,
                                             ctypes.POINTER(ctypes.c_uint32), c_int,
                                             ctypes.POINTER(ctypes.c_uint8)]),
        "ccfd_log_scan": (c_int, [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.POINTER(ctypes.c_uint32), c_int,
                                  ctypes.POINTER(ctypes.c_size_t)]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use. ``ctypes.CDLL``, not
    ``PyDLL``: every call releases the interpreter lock, so the front's
    blocking ``ccfd_front_take`` does not serialize the scorer threads."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            _declare(loaded)
            _lib = loaded
        return _lib


# ---------------------------------------------------------------------------
# the native functions (the reference's signatures and semantics)

_FP = ctypes.POINTER(ctypes.c_float)


def decode_csv(data: bytes, n_features: int = 30) -> tuple[np.ndarray, int]:
    """Newline-separated CSV float rows -> ((B, F) float32, #bad rows). A row
    with the wrong field count or a field that is not a number decodes to
    zeros and counts as bad; a trailing \\r (CRLF) is accepted."""
    if not data:
        return np.zeros((0, n_features), np.float32), 0
    max_rows = data.count(b"\n") + (0 if data.endswith(b"\n") else 1)
    out = np.zeros((max_rows, n_features), np.float32)
    bad = ctypes.c_int(0)
    rows = lib().ccfd_decode_csv(data, len(data), out.ctypes.data_as(_FP), max_rows,
                                 n_features, ctypes.byref(bad))
    return out[:rows], int(bad.value)


def decode_ndarray_json(body: bytes, n_features: int = 30,
                        max_rows: int = 1 << 16) -> np.ndarray | None:
    """The canonical Seldon predict payload's ``data.ndarray`` matrix ->
    (B, F) float32; short rows zero-pad. Returns None where the payload
    needs the Python JSON route: a ``names`` key anywhere (column
    remapping), non-numeric cells, rows wider than the schema, more than
    ``max_rows`` rows, keys after the matrix, or a body that is not JSON."""
    if not body:
        return None
    # '[' count bounds the row count (the outer bracket plus one per row)
    max_rows = min(max_rows, body.count(b"["))
    if max_rows <= 0:
        return None
    out = np.empty((max_rows, n_features), np.float32)
    width = ctypes.c_int(0)
    rows = lib().ccfd_decode_ndarray(body, len(body), out.ctypes.data_as(_FP), max_rows,
                                     n_features, ctypes.byref(width))
    if rows < 0:
        return None
    return out[:rows]


def pad_batch(x: np.ndarray, bucket_rows: int) -> np.ndarray:
    """(n, F) -> (bucket_rows, F) zero-padded float32 (truncates if larger)."""
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty((bucket_rows, x.shape[1]), np.float32)
    lib().ccfd_pad_batch(x.ctypes.data_as(_FP), x.shape[0], x.shape[1],
                         out.ctypes.data_as(_FP), bucket_rows)
    return out


def frame_records(payloads: list[bytes]) -> bytes:
    """Frame payloads as ``[u32 len][u32 crc32][payload]...`` (one buffer)."""
    if not payloads:
        return b""
    concat = b"".join(payloads)
    lens = (ctypes.c_uint32 * len(payloads))(*[len(p) for p in payloads])
    out = ctypes.create_string_buffer(len(concat) + 8 * len(payloads))
    n = lib().ccfd_log_frame(concat, lens, len(payloads),
                             ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)))
    return out.raw[:n]


def scan_records(buf: bytes) -> tuple[list[bytes], int, bool]:
    """Replay a segment buffer -> (payloads, valid_prefix_len, corrupt).

    Stops at the first torn or corrupt frame; ``valid_prefix_len`` is where
    a recovering writer truncates. ``corrupt`` tells a bad CRC or an
    insane length from a clean partial tail."""
    native = lib()
    out: list[bytes] = []
    pos = 0
    corrupt = False
    chunk = 4096
    offs = (ctypes.c_uint64 * chunk)()
    lens = (ctypes.c_uint32 * chunk)()
    consumed = ctypes.c_size_t(0)
    # one copy up front, then chunked scans by pointer offset: re-slicing
    # the bytes per chunk would make a large segment's replay O(n^2)
    base = ctypes.create_string_buffer(buf, len(buf))
    addr = ctypes.addressof(base)
    while pos < len(buf):
        n = native.ccfd_log_scan(ctypes.c_char_p(addr + pos), len(buf) - pos, offs, lens,
                                 chunk, ctypes.byref(consumed))
        got = n if n >= 0 else -n - 1  # corruption encodes -(valid + 1)
        for i in range(got):
            off = pos + offs[i]
            out.append(buf[off: off + lens[i]])
        pos += consumed.value
        if n < 0:
            corrupt = True
            break
        if n < chunk:  # a clean end (EOF or a partial tail)
            break
    return out, pos, corrupt


# ---------------------------------------------------------------------------
# plain versions (identical semantics; the tests' reference)


def _decode_csv_numpy(data: bytes, n_features: int = 30) -> tuple[np.ndarray, int]:
    lines = data.decode("utf-8", errors="replace").splitlines()
    out = np.zeros((len(lines), n_features), np.float32)
    bad = 0
    for i, line in enumerate(lines):
        parts = line.split(",")
        if len(parts) != n_features:
            bad += 1
            continue
        try:
            out[i] = [float(p) for p in parts]
        except ValueError:
            out[i] = 0.0
            bad += 1
    return out, bad


def _decode_ndarray_json_numpy(body: bytes, n_features: int = 30,
                               max_rows: int = 1 << 16) -> np.ndarray | None:
    if not body or b'"names"' in body:
        return None
    try:
        payload = json.loads(body)
    except ValueError:
        return None
    # the matrix must close the body: "data" the top level's last key and
    # "ndarray" the last key of "data"
    if not isinstance(payload, dict) or list(payload)[-1:] != ["data"]:
        return None
    data = payload["data"]
    if not isinstance(data, dict) or list(data)[-1:] != ["ndarray"]:
        return None
    rows = data["ndarray"]
    if not isinstance(rows, list) or len(rows) > max_rows:
        return None
    out = np.zeros((len(rows), n_features), np.float32)
    for i, row in enumerate(rows):
        if not isinstance(row, list) or len(row) > n_features:
            return None
        for j, v in enumerate(row):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            out[i, j] = v
    return out


def _pad_batch_numpy(x: np.ndarray, bucket_rows: int) -> np.ndarray:
    x = np.asarray(x, np.float32)
    out = np.zeros((bucket_rows, x.shape[1]), np.float32)
    out[: min(len(x), bucket_rows)] = x[:bucket_rows]
    return out


def _frame_records_py(payloads: list[bytes]) -> bytes:
    parts = []
    for p in payloads:
        parts.append(struct.pack("<II", len(p), binascii.crc32(p)))
        parts.append(p)
    return b"".join(parts)


def _scan_records_py(buf: bytes) -> tuple[list[bytes], int, bool]:
    out: list[bytes] = []
    pos = 0
    while pos + 8 <= len(buf):
        plen, want = struct.unpack_from("<II", buf, pos)
        if plen > 1 << 30:
            return out, pos, True
        if pos + 8 + plen > len(buf):
            break
        payload = buf[pos + 8: pos + 8 + plen]
        if binascii.crc32(payload) != want:
            return out, pos, True
        out.append(payload)
        pos += 8 + plen
    return out, pos, False
