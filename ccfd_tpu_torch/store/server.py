"""HTTP face of the object store: an S3 REST subset with v2 signing.

The port's copy of ccfd_tpu/store/server.py: the same wire format (the v2
StringToSign, ETags, the XML error codes), so either side's client talks to
either side's server.

The reference exposes Ceph's S3 endpoint through an OpenShift route and the
producer/aws-cli talk to it with access/secret keys (reference
README.md:241-343). This server speaks the subset those flows use:

    PUT    /<bucket>               create bucket
    PUT    /<bucket>/<key>         put object
    GET    /<bucket>/<key>         get object
    HEAD   /<bucket>/<key>         object metadata
    DELETE /<bucket>/<key>         delete object
    GET    /<bucket>?prefix=...    list bucket (ListBucketResult XML)
    GET    /                       list buckets

Requests are authenticated with AWS signature v2 (``Authorization: AWS
<access>:<base64 hmac-sha1>``) — the scheme the reference-era aws-cli/boto
used against Ceph RGW — verified against the store's provisioned
credentials; a bad key or signature is a 403 the same way RGW rejects it.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import threading
from http.server import BaseHTTPRequestHandler

from ccfd_tpu_torch.utils.httpserver import FrameworkHTTPServer
from urllib.parse import parse_qs, quote, unquote, urlsplit
from xml.sax.saxutils import escape

from ccfd_tpu_torch.store.objectstore import ObjectStore, StoreError


def string_to_sign(method: str, path: str, headers: dict[str, str]) -> bytes:
    """AWS v2 StringToSign over the canonicalized resource (path only)."""
    h = {k.lower(): v for k, v in headers.items()}
    parts = [
        method,
        h.get("content-md5", ""),
        h.get("content-type", ""),
        h.get("date", ""),
    ]
    amz = sorted((k, v) for k, v in h.items() if k.startswith("x-amz-"))
    parts += [f"{k}:{v}" for k, v in amz]
    parts.append(path)
    return "\n".join(parts).encode()


def sign_v2(secret_key: str, method: str, path: str, headers: dict[str, str]) -> str:
    digest = hmac.new(
        secret_key.encode(), string_to_sign(method, path, headers), hashlib.sha1
    ).digest()
    return base64.b64encode(digest).decode()


class _Handler(BaseHTTPRequestHandler):
    store: ObjectStore  # injected by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:  # quiet by default
        pass

    # --- helpers ---------------------------------------------------------
    def _authenticate(self, path: str) -> bool:
        auth = self.headers.get("Authorization", "")
        if not auth.startswith("AWS ") or ":" not in auth[4:]:
            self._error(403, "AccessDenied", "missing v2 authorization")
            return False
        access, sig = auth[4:].split(":", 1)
        try:
            secret = self.store.secret_for(access)
        except StoreError as e:
            self._error(e.status, type(e).__name__, str(e))
            return False
        expect = sign_v2(secret, self.command, path, dict(self.headers.items()))
        if not hmac.compare_digest(sig.strip(), expect):
            self._error(403, "SignatureDoesNotMatch", "bad v2 signature")
            return False
        return True

    def _error(self, status: int, code: str, message: str) -> None:
        body = (
            f"<?xml version='1.0'?><Error><Code>{escape(code)}</Code>"
            f"<Message>{escape(message)}</Message></Error>"
        ).encode()
        self._reply(status, body, "application/xml")

    def _reply(
        self, status: int, body: bytes = b"", ctype: str = "application/xml",
        extra: dict[str, str] | None = None,
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _route(self) -> tuple[str, str, dict[str, list[str]]]:
        u = urlsplit(self.path)
        parts = unquote(u.path).lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        return bucket, key, parse_qs(u.query)

    def _sign_path(self) -> str:
        u = urlsplit(self.path)
        return unquote(u.path)

    # --- verbs -----------------------------------------------------------
    def do_PUT(self) -> None:
        if not self._authenticate(self._sign_path()):
            return
        bucket, key, _ = self._route()
        length = int(self.headers.get("Content-Length", "0") or 0)
        data = self.rfile.read(length) if length else b""
        try:
            if not key:
                self.store.create_bucket(bucket)
                self._reply(200)
            else:
                info = self.store.put(bucket, key, data)
                self._reply(200, extra={"ETag": f'"{info.etag}"'})
        except StoreError as e:
            self._error(e.status, type(e).__name__, str(e))

    def do_GET(self) -> None:
        if not self._authenticate(self._sign_path()):
            return
        bucket, key, q = self._route()
        try:
            if not bucket:
                names = self.store.list_buckets()
                inner = "".join(f"<Bucket><Name>{escape(n)}</Name></Bucket>" for n in names)
                self._reply(
                    200,
                    f"<?xml version='1.0'?><ListAllMyBucketsResult><Buckets>"
                    f"{inner}</Buckets></ListAllMyBucketsResult>".encode(),
                )
            elif not key:
                prefix = (q.get("prefix") or [""])[0]
                objs = self.store.list(bucket, prefix=prefix)
                inner = "".join(
                    f"<Contents><Key>{escape(o.key)}</Key><Size>{o.size}</Size>"
                    f"<ETag>&quot;{o.etag}&quot;</ETag></Contents>"
                    for o in objs
                )
                self._reply(
                    200,
                    f"<?xml version='1.0'?><ListBucketResult>"
                    f"<Name>{escape(bucket)}</Name><Prefix>{escape(prefix)}</Prefix>"
                    f"{inner}</ListBucketResult>".encode(),
                )
            else:
                data = self.store.get(bucket, key)
                self._reply(200, data, "application/octet-stream")
        except StoreError as e:
            self._error(e.status, type(e).__name__, str(e))

    def do_HEAD(self) -> None:
        if not self._authenticate(self._sign_path()):
            return
        bucket, key, _ = self._route()
        try:
            info = self.store.head(bucket, key)
            self._reply(
                200,
                b"",
                "application/octet-stream",
                {"ETag": f'"{info.etag}"', "X-Object-Size": str(info.size)},
            )
        except StoreError as e:
            self._error(e.status, type(e).__name__, str(e))

    def do_DELETE(self) -> None:
        if not self._authenticate(self._sign_path()):
            return
        bucket, key, _ = self._route()
        try:
            self.store.delete(bucket, key)
            self._reply(204)
        except StoreError as e:
            self._error(e.status, type(e).__name__, str(e))


class StoreServer:
    """Threaded HTTP server wrapper; ``endpoint`` is http://host:port."""

    def __init__(self, store: ObjectStore, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"store": store})
        self._httpd = FrameworkHTTPServer((host, port), handler)
        self._thread: threading.Thread | None = None

    @property
    def endpoint(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "StoreServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="store-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def quote_key(key: str) -> str:
    return quote(key, safe="/")
