"""Checksummed, atomic durable artifacts: the one seam every persistent
writer and reader of the port goes through.

The port's copy of ccfd_tpu/runtime/durability.py, for the checkpoint's npz
form (``parallel/checkpoint.py``), the bus's segment log (``bus/log.py``)
and the engine's snapshots (``process/engine.py``):

- :func:`atomic_write_bytes`: unique tmp + write + fsync + rename (+ a
  directory fsync), so a crash mid-write leaves the previous bytes and an
  orphan ``*.tmp`` for :func:`sweep_tmp`; the one seam where the storage
  fault plan (runtime/faults.py, ``CCFD_STORAGE_FAULTS``) injects, in the
  reference's draw order; :func:`flip_bytes` corrupts a landed file;
- :func:`frame` / :func:`parse_frame`: the payload under a one-line sha256
  header, ``CCFDSUM1 <sha256hex> <len>\\n<payload>``, byte for byte the
  reference's framing, so either side verifies the other's files;
- :func:`write_artifact` / :func:`read_artifact`: the framed write with
  generation retention (``<path>.g<seq>``) and the verified read that
  quarantines a corrupt file (``*.corrupt``) and falls back to the newest
  retained generation that verifies;
- :func:`write_json_artifact` / :func:`read_json_artifact`: the same for a
  JSON document (the engine's snapshot);
- :func:`scan_frames`: the streaming scan of concatenated frames, which
  stops at the first bad one (an append-only file's valid prefix);
- :func:`verify_file` and :func:`has_generations`: peeks that change
  nothing on disk;
- :func:`sweep_tmp`: the start-up sweep of orphan ``*.tmp`` files;
- :func:`configure`: the module defaults (retained generations, fsync,
  the sweep), which per-call arguments override;
- :func:`note` / :func:`counts` / :func:`bind_registry`: the process-wide
  tally of integrity events (``corrupt``, ``fallback``, ``write_errors``,
  ``verified``, ``unverified``, ``tmp_swept``, ``log_truncated_records``)
  per artifact, replayed into the ``ccfd_storage_*`` counters of a
  registry once one is bound.

- :func:`write_json_interchange`: a plain JSON document with a
  ``<path>.sha256`` sidecar (the stage profile's artifact);
- :class:`StoragePinGate` and :class:`ComposedHealGate`: the router's
  heal-gate seam (``device_allowed``/``host_allowed``), which the platform
  operator arms with the storage pin (the rules tier while no params
  generation verifies) composed with the device heal supervisor
  (runtime/heal.py; it closes the card only, so the host tier serves).

Still to port (ROADMAP A14): the flight-recorder hook and directory
manifests.
"""

from __future__ import annotations

import errno
import hashlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Any

log = logging.getLogger(__name__)

MAGIC = b"CCFDSUM1 "


class CorruptArtifactError(Exception):
    """No verifiable copy of a durable artifact exists (the main file and
    every retained generation failed verification)."""


# metric short names labelled by artifact; the others have no labels
_ARTIFACT_METRICS = ("corrupt", "fallback", "write_errors", "verified", "unverified")
_HELP = {
    "corrupt": ("ccfd_storage_corrupt_total",
                "corrupt durable artifacts detected (and quarantined)"),
    "fallback": ("ccfd_storage_fallback_total",
                 "reads served from a last-good retained generation"),
    "write_errors": ("ccfd_storage_write_errors_total",
                     "durable writes that failed (artifact kept last-good)"),
    "verified": ("ccfd_storage_verified_reads_total",
                 "artifact reads with a matching sha256 frame"),
    "unverified": ("ccfd_storage_unverified_reads_total",
                   "legacy (unframed) artifact reads accepted unverified"),
    "tmp_swept": ("ccfd_storage_tmp_swept_total",
                  "orphaned *.tmp files removed by the startup sweep"),
    "log_truncated_records": ("ccfd_storage_log_truncated_records_total",
                              "valid bus-log records dropped past a mid-file corrupt frame"),
}

_mu = threading.RLock()
_counts: dict[tuple[str, str], int] = {}  # (metric, artifact|"") -> n
_prom: dict[str, Any] = {}
_tmp_seq = itertools.count()
_defaults = {"retain": 3, "fsync": True, "sweep": True}


def configure(retain: int | None = None, fsync: bool | None = None,
              sweep: bool | None = None) -> None:
    """Set the module defaults; per-call arguments still win."""
    if retain is not None:
        _defaults["retain"] = max(0, int(retain))
    if fsync is not None:
        _defaults["fsync"] = bool(fsync)
    if sweep is not None:
        _defaults["sweep"] = bool(sweep)


def default_retain() -> int:
    return int(_defaults["retain"])


def bind_registry(registry) -> None:
    """Attach a scraped registry: creates the ``ccfd_storage_*`` counters
    and replays the tallies collected before binding. The tallies span the
    process, so a second binding replays the full history into its
    registry."""
    with _mu:
        _prom.clear()
        for short, (name, help_) in _HELP.items():
            _prom[short] = registry.counter(name, help_)
        for (short, artifact), n in _counts.items():
            _inc(short, n, artifact)


def _inc(metric: str, n: int, artifact: str) -> None:
    c = _prom.get(metric)
    if c is None or n <= 0:
        return
    if metric in _ARTIFACT_METRICS:
        c.inc(n, labels={"artifact": artifact})
    else:
        c.inc(n)


def note(metric: str, n: int = 1, artifact: str = "") -> None:
    """Count one integrity event (``bus/log.py`` counts mid-file log
    corruption here)."""
    if n <= 0:
        return
    with _mu:
        _counts[(metric, artifact)] = _counts.get((metric, artifact), 0) + n
        _inc(metric, n, artifact)


def counts() -> dict[str, dict[str, int]]:
    """{metric: {artifact: n}} snapshot of every tally so far."""
    with _mu:
        out: dict[str, dict[str, int]] = {}
        for (metric, artifact), n in _counts.items():
            out.setdefault(metric, {})[artifact] = n
        return out


def _storage_plan():
    from ccfd_tpu_torch.runtime import faults

    return faults.storage_faults()


def _flip_byte(path: str) -> None:
    """In-place single-byte corruption of a landed file (the ``bitrot``
    injection; also the helper drills and tests corrupt artifacts with)."""
    try:
        size = os.path.getsize(path)
        if size == 0:
            return
        off = size // 2
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
    except OSError:
        log.exception("bitrot injection failed for %s", path)


def flip_bytes(path: str) -> None:
    """Deliberately corrupt an on-disk artifact (drills and tests)."""
    _flip_byte(path)


def atomic_write_bytes(path: str, data: bytes, fsync: bool | None = None,
                       artifact: str = "artifact") -> None:
    """Unique tmp + write + fsync + rename. Raises OSError on failure
    (injected or real); a failed write never touches the previous
    artifact, though it may leave an orphan ``*.tmp`` for the start-up
    sweep, exactly what a crash mid-write leaves.

    The installed storage-fault plan (runtime/faults.py) is drawn here in
    the reference's order, one draw a kind a write: ``slow_disk``,
    ``enospc``, ``torn_write``, ``fsync_fail`` (only when syncing),
    ``rename_lost``, ``bitrot``. ``artifact`` is taken for parity with
    the reference's signature and, as there, read by nothing: no write
    is accounted per artifact."""
    fsync = _defaults["fsync"] if fsync is None else bool(fsync)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    plan = _storage_plan()

    def draw(kind: str):
        return plan.draw(kind) if plan is not None else None

    s = draw("slow_disk")
    if s is not None:
        time.sleep(s.ms / 1e3)
    if draw("enospc") is not None:
        raise OSError(errno.ENOSPC, "injected ENOSPC", path)
    tmp = f"{path}.{os.getpid()}.{next(_tmp_seq)}.tmp"
    torn = draw("torn_write")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        if torn is not None:
            # the crash-mid-write case: a prefix lands, the process dies
            # before the rename; the artifact keeps its previous bytes and
            # the orphan tmp waits for the sweep
            os.write(fd, data[: max(0, int(len(data) * torn.frac))])
            raise OSError(errno.EIO, "injected torn write", tmp)
        os.write(fd, data)
        if fsync:
            if draw("fsync_fail") is not None:
                raise OSError(errno.EIO, "injected fsync failure", tmp)
            os.fsync(fd)
    finally:
        os.close(fd)
    if draw("rename_lost") is not None:
        # the metadata-lost case: data written and synced but the rename
        # never lands (journal lost on a power cut); the caller believes the
        # write succeeded, the artifact keeps its previous bytes, the tmp is
        # crash debris for the sweep
        return
    os.replace(tmp, path)
    if fsync:
        # the rename itself must survive a host crash: sync the directory
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:  # pragma: no cover - platform-dependent
            pass
    if draw("bitrot") is not None:
        # latent media corruption surfacing after a successful write: the
        # read side's quarantine and last-good fallback must catch it
        _flip_byte(path)


def frame(payload: bytes) -> bytes:
    """``CCFDSUM1 <sha256hex> <len>\\n<payload>``: self-verifying in one
    file."""
    h = hashlib.sha256(payload).hexdigest()
    return MAGIC + h.encode() + (" %d\n" % len(payload)).encode() + payload


def parse_frame(data: bytes) -> tuple[bytes | None, bool]:
    """-> (payload, framed). ``(data, False)`` for a legacy (unframed)
    file; ``(None, True)`` for a framed file that fails verification
    (torn, truncated, bit-flipped)."""
    if not data.startswith(MAGIC):
        return data, False
    nl = data.find(b"\n", len(MAGIC))
    if nl < 0:
        return None, True
    try:
        hexdigest, length = data[len(MAGIC):nl].split()
        length = int(length)
    except ValueError:
        return None, True
    payload = data[nl + 1:]
    if (len(payload) != length
            or hashlib.sha256(payload).hexdigest() != hexdigest.decode(
                "ascii", "replace")):
        return None, True
    return payload, True


def scan_frames(data: bytes) -> tuple[list[tuple[int, bytes]], int, bool]:
    """Streaming scan of concatenated :func:`frame` blocks (append-only
    logs) -> ``([(start_offset, payload), ...], valid_prefix_bytes,
    torn)``. It stops at the first bad frame: in an append-only file
    everything after it postdates the corruption, so the caller truncates
    to the valid prefix."""
    frames: list[tuple[int, bytes]] = []
    pos = 0
    n = len(data)
    while pos < n:
        if not data.startswith(MAGIC, pos):
            return frames, pos, True
        nl = data.find(b"\n", pos + len(MAGIC))
        if nl < 0:
            return frames, pos, True
        try:
            hexdigest, length = data[pos + len(MAGIC):nl].split()
            length = int(length)
        except ValueError:
            return frames, pos, True
        end = nl + 1 + length
        if end > n:
            return frames, pos, True
        payload = data[nl + 1:end]
        if hashlib.sha256(payload).hexdigest() != hexdigest.decode("ascii", "replace"):
            return frames, pos, True
        frames.append((pos, payload))
        pos = end
    return frames, pos, False


def _generations(path: str) -> list[tuple[int, str]]:
    """Retained generations of ``path``, ascending ``[(seq, path)]``."""
    d = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path) + ".g"
    out: list[tuple[int, str]] = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in names:
        if name.startswith(base):
            tail = name[len(base):]
            if tail.isdigit():
                out.append((int(tail), os.path.join(d, name)))
    return sorted(out)


def has_generations(path: str) -> bool:
    return bool(_generations(path))


def write_artifact(path: str, payload: bytes, artifact: str = "artifact",
                   retain: int | None = None, fsync: bool | None = None,
                   best_effort: bool = True) -> bool:
    """Framed, checksummed, atomic write + generation retention (a full
    second copy at ``<path>.g<seq>``, the newest ``retain`` kept). Returns
    False (and counts ``write_errors``) when the write failed and
    ``best_effort``: the previous artifact stays the last-good state."""
    data = frame(payload)
    try:
        atomic_write_bytes(path, data, fsync=fsync, artifact=artifact)
    except OSError as e:
        note("write_errors", artifact=artifact)
        log.error("durable write of %s (%s) failed: %s; keeping last-good",
                  path, artifact, e)
        if not best_effort:
            raise
        return False
    r = _defaults["retain"] if retain is None else max(0, int(retain))
    if r > 0:
        try:
            gens = _generations(path)
            seq = (gens[-1][0] + 1) if gens else 1
            atomic_write_bytes(f"{path}.g{seq:08d}", data, fsync=fsync,
                               artifact=artifact)
            for _s, p in _generations(path)[:-r]:
                try:
                    os.unlink(p)
                except OSError:
                    pass
        except OSError as e:
            note("write_errors", artifact=artifact)
            log.warning("generation retention for %s failed: %s", path, e)
    return True


def _quarantine(path: str, artifact: str) -> None:
    dest = path + ".corrupt"
    try:
        os.replace(path, dest)
    except OSError:
        dest = "<unmovable>"
    note("corrupt", artifact=artifact)
    log.error("corrupt %s artifact %s quarantined to %s", artifact, path, dest)


def read_artifact(path: str, artifact: str = "artifact",
                  fallback: bool = True, quarantine: bool = True) -> bytes:
    """Verified read. A framed file that fails its sha256 is quarantined
    (``*.corrupt``) and the newest verifiable retained generation is
    served instead (counted ``fallback``). Raises FileNotFoundError when
    nothing was ever written, and :class:`CorruptArtifactError` when data
    existed but no copy verifies. ``quarantine=False`` peeks without
    touching disk state; ``fallback=False`` raises on the main file's
    verdict alone (artifacts with their own retention, e.g. checkpoint
    step dirs)."""
    data: bytes | None = None
    read_failed = False
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        pass
    except OSError as e:
        # an unreadable main file is treated like a failed checksum
        read_failed = True
        log.error("%s artifact %s unreadable (%s)", artifact, path, e)
    if data is not None:
        payload, framed = parse_frame(data)
        if payload is not None:
            note("verified" if framed else "unverified", artifact=artifact)
            return payload
    if data is not None or read_failed:
        if quarantine:
            _quarantine(path, artifact)
        else:
            note("corrupt", artifact=artifact)
    if not fallback:
        if data is None and not read_failed:
            raise FileNotFoundError(path)
        raise CorruptArtifactError(
            f"{artifact} artifact {path} failed verification")
    gens = _generations(path)
    for seq, gp in reversed(gens):
        try:
            with open(gp, "rb") as f:
                gdata = f.read()
        except OSError:
            continue
        payload, framed = parse_frame(gdata)
        if payload is not None and framed:
            note("fallback", artifact=artifact)
            log.warning("%s artifact %s served from last-good generation g%d",
                        artifact, path, seq)
            return payload
        # a corrupt generation must not be re-tried on every read
        note("corrupt", artifact=artifact)
        if quarantine:
            try:
                os.replace(gp, gp + ".corrupt")
            except OSError:
                pass
    if data is None and not read_failed and not gens:
        raise FileNotFoundError(path)
    raise CorruptArtifactError(
        f"no verifiable copy of {artifact} artifact {path}")


def verify_file(path: str) -> bool | None:
    """Peek verification: None when missing, True for a verified frame or
    a legacy unframed file (nothing to check against), False when a frame
    fails its checksum. Never mutates disk state."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return None
    except OSError:
        return False
    payload, _framed = parse_frame(data)
    return payload is not None


def write_json_artifact(path: str, doc: Any, artifact: str = "artifact",
                        retain: int | None = None, fsync: bool | None = None,
                        best_effort: bool = True, **dump_kw: Any) -> bool:
    return write_artifact(path, json.dumps(doc, **dump_kw).encode(), artifact=artifact,
                          retain=retain, fsync=fsync, best_effort=best_effort)


def read_json_artifact(path: str, artifact: str = "artifact",
                       fallback: bool = True, quarantine: bool = True) -> Any:
    return json.loads(read_artifact(path, artifact=artifact, fallback=fallback,
                                    quarantine=quarantine))


def sweep_tmp(*dirs: str, enabled: bool | None = None) -> int:
    """Remove orphaned ``*.tmp`` files a crash mid-write left behind (the
    bus log's offsets compaction tmp, say). Start-up only: live writers use
    unique tmp names and rename within the same call, so any ``*.tmp``
    present when a component constructs is debris. Counted as
    ``tmp_swept``. ``enabled`` overrides the module default."""
    if not (_defaults["sweep"] if enabled is None else enabled):
        return 0
    n = 0
    for d in dirs:
        if not d:
            continue
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for name in names:
            if not name.endswith(".tmp"):
                continue
            try:
                os.unlink(os.path.join(d, name))
                n += 1
            except OSError:
                pass
    if n:
        note("tmp_swept", n)
        log.warning("start-up sweep removed %d orphaned tmp file(s) from %s",
                    n, ", ".join(d for d in dirs if d))
    return n


def write_json_interchange(path: str, doc: Any, artifact: str = "interchange",
                           best_effort: bool = True, **dump_kw: Any) -> bool:
    """Crash-safe write for documents external readers ``json.load``
    directly: the body stays plain JSON; integrity rides a
    ``<path>.sha256`` sidecar written after the body (the stale sidecar is
    removed first), so every crash window leaves either the old pair or a
    new body whose missing sidecar reads as unverified."""
    dump_kw.setdefault("indent", 1)
    body = (json.dumps(doc, **dump_kw) + "\n").encode()
    try:
        try:
            os.unlink(path + ".sha256")
        except FileNotFoundError:
            pass
        atomic_write_bytes(path, body, artifact=artifact)
        atomic_write_bytes(path + ".sha256",
                           hashlib.sha256(body).hexdigest().encode() + b"\n",
                           artifact=artifact)
    except OSError as e:
        note("write_errors", artifact=artifact)
        log.error("interchange write of %s failed: %s", path, e)
        if not best_effort:
            raise
        return False
    return True


class StoragePinGate:
    """Heal-gate-shaped pin (``device_allowed`` + ``host_allowed``): while
    it is pinned the router serves from the rules tier only, since the host
    tier would forward the very same unverified params. ``pin``/``unpin``
    are the surface a params restore arms (the lifecycle controller's,
    when no champion checkpoint verifies);
    the operator binds the gate to the router whether or not anything pins
    it, as the reference's does."""

    def __init__(self, registry=None):
        self._mu = threading.Lock()
        self._pinned = False
        self.reason: str | None = None
        self.pins = 0
        self._g = None
        if registry is not None:
            self._g = registry.gauge(
                "ccfd_storage_pinned",
                "1 while serving is pinned to the rules tier because no "
                "durable params generation verifies")
            self._g.set(0)

    @property
    def pinned(self) -> bool:
        with self._mu:
            return self._pinned

    def pin(self, reason: str) -> None:
        with self._mu:
            if not self._pinned:
                self.pins += 1
            self._pinned = True
            self.reason = reason
            if self._g is not None:
                self._g.set(1)
        log.error("storage pin: serving pinned to the rules tier (%s)", reason)

    def unpin(self) -> None:
        with self._mu:
            was = self._pinned
            self._pinned = False
            self.reason = None
            if self._g is not None:
                self._g.set(0)
        if was:
            log.warning("storage pin cleared: verified params published")

    # the router's heal-gate surface
    def device_allowed(self) -> bool:
        return not self.pinned

    def host_allowed(self) -> bool:
        return not self.pinned


class ComposedHealGate:
    """AND-composition of heal-gate-shaped objects: the operator hands the
    router ONE gate built from the storage pin and (when the heal component
    is up) the DeviceSupervisor. ``host_allowed`` consults only the gates
    that define it: the storage pin blocks the host tier too, the
    supervisor only the card, so the host tier stays the heal ladder's
    fallback."""

    def __init__(self, *gates: Any):
        self.gates = tuple(g for g in gates if g is not None)

    def device_allowed(self) -> bool:
        return all(g.device_allowed() for g in self.gates)

    def host_allowed(self) -> bool:
        return all(g.host_allowed() for g in self.gates
                   if callable(getattr(g, "host_allowed", None)))
