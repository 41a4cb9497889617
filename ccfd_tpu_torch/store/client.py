"""Object-store client: what the reference's producer + aws-cli do.

The port's copy of ccfd_tpu/store/client.py.

The reference producer receives ``s3endpoint``/``s3bucket``/``filename`` and
``ACCESS_KEY_ID``/``SECRET_ACCESS_KEY`` (from the ``keysecret`` secret) and
pulls ``creditcard.csv`` over S3 (reference
deploy/kafka/ProducerDeployment.yaml:77-97, deploy/ceph/s3-secretceph.yaml).
``S3Client`` reproduces that consumer side against either the HTTP store
server (v2-signed requests over urllib) or an ``inproc://`` store in the
same process, chosen by the endpoint scheme — the same dual-transport seam
the bus uses.
"""

from __future__ import annotations

import email.utils
import urllib.error
import urllib.request
import xml.etree.ElementTree as ET

from ccfd_tpu_torch.store.objectstore import (
    AccessDenied,
    Credentials,
    NoSuchKey,
    ObjectStore,
    resolve_inproc,
)
from ccfd_tpu_torch.store.server import quote_key, sign_v2


class S3Client:
    def __init__(self, endpoint: str, creds: Credentials, timeout_s: float = 10.0,
                 breaker=None, faults=None, tracer=None):
        self.endpoint = endpoint.rstrip("/")
        self.creds = creds
        self.timeout_s = timeout_s
        # producer↔store resilience edge (runtime/breaker.py,
        # runtime/faults.py): gates both transports — the producer's retry
        # loop sees CircuitOpenError/InjectedFault as ordinary
        # ConnectionErrors. tracer: each store op is an rpc.store client
        # span; the HTTP transport carries traceparent.
        self._breaker = breaker
        self._faults = faults
        self._tracer = tracer
        self._inproc: ObjectStore | None = None
        if endpoint.startswith("inproc://"):
            self._inproc = resolve_inproc(endpoint)
            self._inproc.check_access(creds.access_key)
            if self._inproc.secret_for(creds.access_key) != creds.secret_key:
                raise AccessDenied("secret key mismatch")

    # --- HTTP plumbing ---------------------------------------------------
    def _request(self, method: str, path: str, data: bytes | None = None) -> bytes:
        return self._call(self._request_raw, method, path, data)

    def _call(self, fn, *args):
        if self._tracer is not None:
            with self._tracer.span("rpc.store"):
                return self._call_untraced(fn, *args)
        return self._call_untraced(fn, *args)

    def _call_untraced(self, fn, *args):
        if self._breaker is not None or self._faults is not None:
            return self._guarded(fn, *args)
        return fn(*args)

    def _guarded(self, fn, *args):
        """Breaker gate + outcome recording + fault perturbation around one
        store call (shared by the HTTP and inproc transports)."""
        import time as _time

        if self._breaker is not None and not self._breaker.allow():
            from ccfd_tpu_torch.runtime.breaker import CircuitOpenError

            raise CircuitOpenError("circuit open for the object store")
        t0 = _time.monotonic()
        try:
            corrupt = (self._faults.before()
                       if self._faults is not None else False)
            out = fn(*args)
            if self._faults is not None:
                out = self._faults.after(out, corrupt)
        except (NoSuchKey, AccessDenied):
            # application-level outcomes over a HEALTHY transport: record
            # success — a gated call that records nothing would leak its
            # HALF_OPEN probe slot and wedge the circuit
            if self._breaker is not None:
                self._breaker.record_success(_time.monotonic() - t0)
            raise
        except Exception:
            if self._breaker is not None:
                self._breaker.record_failure(_time.monotonic() - t0)
            raise
        if self._breaker is not None:
            self._breaker.record_success(_time.monotonic() - t0)
        return out

    def _request_raw(self, method: str, path: str, data: bytes | None = None) -> bytes:
        headers = {"Date": email.utils.formatdate(usegmt=True)}
        if self._tracer is not None:
            from ccfd_tpu_torch.observability.trace import inject_headers

            inject_headers(headers)  # traceparent is not part of the
            # v2 StringToSign set, so signing stays valid
        if data is not None:
            # set explicitly so the signed Content-Type matches what urllib
            # sends (it would otherwise inject x-www-form-urlencoded unsigned)
            headers["Content-Type"] = "application/octet-stream"
        sig = sign_v2(self.creds.secret_key, method, path.split("?")[0], headers)
        headers["Authorization"] = f"AWS {self.creds.access_key}:{sig}"
        req = urllib.request.Request(
            self.endpoint + path, data=data, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            body = e.read().decode("utf-8", "replace")
            if e.code == 403:
                raise AccessDenied(body) from None
            if e.code == 404:
                raise NoSuchKey(body) from None
            raise

    # --- API -------------------------------------------------------------
    def create_bucket(self, bucket: str) -> None:
        if self._inproc is not None:
            self._call(self._inproc.create_bucket, bucket)
        else:
            self._request("PUT", f"/{bucket}")

    def put(self, bucket: str, key: str, data: bytes) -> None:
        if self._inproc is not None:
            self._call(self._inproc.put, bucket, key, data)
        else:
            self._request("PUT", f"/{bucket}/{quote_key(key)}", data=data)

    def get(self, bucket: str, key: str) -> bytes:
        if self._inproc is not None:
            return self._call(self._inproc.get, bucket, key)
        return self._request("GET", f"/{bucket}/{quote_key(key)}")

    def delete(self, bucket: str, key: str) -> None:
        if self._inproc is not None:
            self._call(self._inproc.delete, bucket, key)
        else:
            self._request("DELETE", f"/{bucket}/{quote_key(key)}")

    def list(self, bucket: str, prefix: str = "") -> list[str]:
        """Object keys, the `aws s3 ls` check (reference README.md:320-343)."""
        if self._inproc is not None:
            return [o.key for o in
                    self._call(self._inproc.list, bucket, prefix)]
        body = self._request("GET", f"/{bucket}?prefix={quote_key(prefix)}")
        root = ET.fromstring(body)
        return [c.findtext("Key", "") for c in root.iter("Contents")]
