"""S3-shaped object store: the dataset layer (reference L0).

The port's copy of ccfd_tpu/store/objectstore.py (the same ETags and
errors).

The reference keeps ``creditcard.csv`` in a Rook-Ceph S3 object store and
hands the producer an endpoint + bucket + key plus credentials from the
``keysecret`` secret (reference deploy/ceph/s3-secretceph.yaml:1-8,
deploy/kafka/ProducerDeployment.yaml:77-97, setup README.md:136-343). This
module reproduces that capability locally: named buckets of keyed byte
objects with access-key/secret-key authentication, backed either by memory
(tests, demo) or a filesystem root (durable). The HTTP face lives in
``store/server.py`` (S3 v2-signed REST subset) and the consumer side in
``store/client.py``.

Auth model matches the reference secret contract: a store is provisioned
with (access_key, secret_key) pairs; every operation presents an access key
that must be known. Signature verification happens at the HTTP layer (the
in-process path trusts the caller the way the producer pod trusts its
mounted secret).
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
import time
from dataclasses import dataclass

_BUCKET_RE = re.compile(r"^[a-z0-9][a-z0-9.-]{2,62}$")


@dataclass(frozen=True)
class Credentials:
    """The reference's ``keysecret`` pair (s3-secretceph.yaml:4-7)."""

    access_key: str
    secret_key: str


@dataclass(frozen=True)
class ObjectInfo:
    key: str
    size: int
    etag: str
    last_modified: float


class StoreError(Exception):
    status = 500


class NoSuchBucket(StoreError):
    status = 404


class NoSuchKey(StoreError):
    status = 404


class AccessDenied(StoreError):
    status = 403


class InvalidBucketName(StoreError):
    status = 400


class ObjectStore:
    """Bucket/key byte store with optional filesystem persistence.

    ``root=None`` keeps everything in memory. With a ``root`` directory,
    buckets are subdirectories and keys are files (slashes in keys become
    nested paths), so a store survives process restarts the way the
    reference's Ceph PVs do.
    """

    def __init__(self, root: str | None = None):
        self._root = root
        self._lock = threading.RLock()
        self._mem: dict[str, dict[str, tuple[bytes, float]]] = {}
        self._creds: dict[str, str] = {}
        if root:
            os.makedirs(root, exist_ok=True)
            for name in sorted(os.listdir(root)):
                if os.path.isdir(os.path.join(root, name)):
                    self._mem.setdefault(name, {})

    # --- credentials -----------------------------------------------------
    def add_credentials(self, creds: Credentials) -> None:
        with self._lock:
            self._creds[creds.access_key] = creds.secret_key

    def secret_for(self, access_key: str) -> str:
        with self._lock:
            try:
                return self._creds[access_key]
            except KeyError:
                raise AccessDenied(f"unknown access key {access_key!r}") from None

    def check_access(self, access_key: str) -> None:
        self.secret_for(access_key)

    # --- buckets ---------------------------------------------------------
    def create_bucket(self, bucket: str) -> None:
        if not _BUCKET_RE.match(bucket):
            raise InvalidBucketName(bucket)
        with self._lock:
            self._mem.setdefault(bucket, {})
            if self._root:
                os.makedirs(os.path.join(self._root, bucket), exist_ok=True)

    def list_buckets(self) -> list[str]:
        with self._lock:
            return sorted(self._mem)

    def _bucket(self, bucket: str) -> dict[str, tuple[bytes, float]]:
        try:
            return self._mem[bucket]
        except KeyError:
            raise NoSuchBucket(bucket) from None

    # --- objects ---------------------------------------------------------
    def _path(self, bucket: str, key: str) -> str:
        assert self._root
        broot = os.path.join(self._root, bucket)
        p = os.path.normpath(os.path.join(broot, key))
        if p != broot and not p.startswith(broot + os.sep):
            raise AccessDenied(f"key escapes bucket: {key!r}")
        return p

    def put(self, bucket: str, key: str, data: bytes) -> ObjectInfo:
        data = bytes(data)
        now = time.time()
        with self._lock:
            b = self._bucket(bucket)
            b[key] = (data, now)
            if self._root:
                # the shared atomic-write helper (tmp + fsync + rename,
                # runtime/durability.py): NO frame — object bytes are the
                # caller's payload, integrity rides the etag
                from ccfd_tpu_torch.runtime.durability import atomic_write_bytes

                p = self._path(bucket, key)
                atomic_write_bytes(p, data, artifact="object")
        return ObjectInfo(key, len(data), _etag(data), now)

    def get(self, bucket: str, key: str) -> bytes:
        with self._lock:
            b = self._bucket(bucket)
            if key in b:
                return b[key][0]
            if self._root:
                p = self._path(bucket, key)
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        data = f.read()
                    b[key] = (data, os.path.getmtime(p))
                    return data
            raise NoSuchKey(f"{bucket}/{key}")

    def head(self, bucket: str, key: str) -> ObjectInfo:
        data = self.get(bucket, key)
        with self._lock:
            mtime = self._bucket(bucket)[key][1]
        return ObjectInfo(key, len(data), _etag(data), mtime)

    def delete(self, bucket: str, key: str) -> None:
        with self._lock:
            b = self._bucket(bucket)
            b.pop(key, None)
            if self._root:
                p = self._path(bucket, key)
                if os.path.exists(p):
                    os.remove(p)

    def list(self, bucket: str, prefix: str = "") -> list[ObjectInfo]:
        """`aws s3 ls`-equivalent listing (reference README.md:320-343).

        Filesystem-backed objects are stat'ed, not read: listing a bucket of
        large CSVs must not pull their bytes into memory (etag of uncached
        files is computed from size+mtime, a weak but read-free identity).
        """
        with self._lock:
            b = self._bucket(bucket)
            out = {
                k: ObjectInfo(k, len(v), _etag(v), ts)
                for k, (v, ts) in b.items()
                if k.startswith(prefix)
            }
            if self._root:
                broot = os.path.join(self._root, bucket)
                if os.path.isdir(broot):
                    for dirpath, _, files in os.walk(broot):
                        for fn in files:
                            p = os.path.join(dirpath, fn)
                            k = os.path.relpath(p, broot)
                            if k not in out and k.startswith(prefix):
                                st = os.stat(p)
                                weak = hashlib.md5(
                                    f"{st.st_size}:{st.st_mtime_ns}".encode()
                                ).hexdigest()
                                out[k] = ObjectInfo(k, st.st_size, weak, st.st_mtime)
        return sorted(out.values(), key=lambda o: o.key)


def _etag(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


# --- inproc endpoint registry (mirrors the bus's inproc:// seam) ---------
_INPROC: dict[str, ObjectStore] = {}
_INPROC_LOCK = threading.Lock()


def register_inproc(name: str, store: ObjectStore) -> str:
    """Bind a store to an ``inproc://<name>`` endpoint for same-process use."""
    with _INPROC_LOCK:
        _INPROC[name] = store
    return f"inproc://{name}"


def resolve_inproc(endpoint: str) -> ObjectStore:
    name = endpoint[len("inproc://"):]
    with _INPROC_LOCK:
        try:
            return _INPROC[name]
        except KeyError:
            raise NoSuchBucket(f"no inproc store {name!r}") from None


