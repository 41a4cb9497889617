"""The port's object store against the reference's (store/, ``store``).

The same operations on both stores give the same bytes, ETags, listings and
errors; the v2 signatures are equal; the port's client works against the
reference's server and the reference's client against the port's (the
wire format is shared: the StringToSign, the ``ETag`` header, the XML error
codes). The producer's store source (``dataset_from_store``) reads what the
``store put`` command wrote. Tolerance: none (bytes and strings equal).
"""

from __future__ import annotations

import email.utils
import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from ccfd_tpu.store import client as ref_client
from ccfd_tpu.store import objectstore as ref_os
from ccfd_tpu.store import server as ref_server
from ccfd_tpu_torch.store import client as port_client
from ccfd_tpu_torch.store import objectstore as port_os
from ccfd_tpu_torch.store import server as port_server

REPO = Path(__file__).resolve().parents[1]
CREDS = ("ccfd-access", "ccfd-secret")


def _ops(mod, root):
    """A fixed sequence of store operations -> what each returned/raised."""
    st = mod.ObjectStore(root=root)
    st.add_credentials(mod.Credentials(*CREDS))
    out = []

    def rec(fn, *a):
        try:
            r = fn(*a)
            if isinstance(r, mod.ObjectInfo):
                r = (r.key, r.size, r.etag)
            elif isinstance(r, list):
                r = [(o.key, o.size, o.etag) if isinstance(o, mod.ObjectInfo) else o for o in r]
            out.append(("ok", r))
        except mod.StoreError as e:
            out.append((type(e).__name__, e.status, str(e)))

    rng = np.random.default_rng(3)
    blobs = [rng.bytes(n) for n in (0, 1, 1000, 65536)]
    rec(st.create_bucket, "ccdata")
    rec(st.create_bucket, "Bad_Name")
    for i, b in enumerate(blobs):
        rec(st.put, "ccdata", f"dir/obj{i}", b)
    rec(st.get, "ccdata", "dir/obj2")
    rec(st.head, "ccdata", "dir/obj3")
    rec(st.get, "ccdata", "missing")
    rec(st.get, "nobucket", "x")
    rec(st.list, "ccdata", "dir/")
    rec(st.delete, "ccdata", "dir/obj1")
    rec(st.list, "ccdata")
    rec(st.secret_for, "nobody")
    rec(st.list_buckets)
    if root:
        rec(st.put, "ccdata", "../escape", b"x")
    return out


@pytest.mark.parametrize("durable", [False, True])
def test_same_operations_same_results(tmp_path, durable):
    ref = _ops(ref_os, str(tmp_path / "ref") if durable else None)
    port = _ops(port_os, str(tmp_path / "port") if durable else None)
    assert port == ref
    if durable:  # the same files on disk
        for p in sorted((tmp_path / "ref").rglob("*")):
            q = tmp_path / "port" / p.relative_to(tmp_path / "ref")
            assert q.exists() and (p.is_dir() or p.read_bytes() == q.read_bytes())


def test_v2_signatures_are_the_references():
    rng = np.random.default_rng(0)
    for _ in range(20):
        headers = {"Date": "Tue, 01 Jan 2030 00:00:00 GMT",
                   "Content-Type": "application/octet-stream",
                   "x-amz-meta-b": str(rng.integers(1000)), "X-Amz-Meta-A": "v"}
        path = f"/ccdata/k{rng.integers(100)}/ä b"
        for method in ("GET", "PUT", "HEAD", "DELETE"):
            assert (port_server.string_to_sign(method, path, headers)
                    == ref_server.string_to_sign(method, path, headers))
            assert (port_server.sign_v2("s3cret", method, path, headers)
                    == ref_server.sign_v2("s3cret", method, path, headers))
    assert port_server.quote_key("a b/c") == ref_server.quote_key("a b/c")


def _served(mod_os, mod_server):
    st = mod_os.ObjectStore()
    st.add_credentials(mod_os.Credentials(*CREDS))
    return mod_server.StoreServer(st).start()


def _client_session(client_mod, os_mod, endpoint):
    c = client_mod.S3Client(endpoint, os_mod.Credentials(*CREDS))
    out = []
    c.create_bucket("ccdata")
    c.put("ccdata", "a/key.csv", b"1,2,3\n")
    c.put("ccdata", "b", b"")
    out.append(c.get("ccdata", "a/key.csv"))
    out.append(c.list("ccdata"))
    out.append(c.list("ccdata", prefix="a"))
    c.delete("ccdata", "b")
    out.append(c.list("ccdata"))
    # a key URL quoting changes: the client signs the quoted path and the
    # server verifies the unquoted one, so both sides refuse it alike
    for fn in (lambda: c.put("ccdata", "a key.csv", b"x"),
               lambda: c.get("ccdata", "missing"),
               lambda: client_mod.S3Client(endpoint, os_mod.Credentials("ccfd-access", "wrong"))
               .get("ccdata", "b"),
               lambda: client_mod.S3Client(endpoint, os_mod.Credentials("nobody", "x"))
               .get("ccdata", "b")):
        try:
            fn()
            out.append("no error")
        except Exception as e:  # noqa: BLE001 - the error type and body compared
            out.append((type(e).__name__, str(e)))
    return out


def test_clients_and_servers_interoperate():
    results = {}
    servers = {"ref": _served(ref_os, ref_server), "port": _served(port_os, port_server)}
    try:
        for cname, (cmod, omod) in {"ref": (ref_client, ref_os),
                                    "port": (port_client, port_os)}.items():
            for sname, srv in servers.items():
                results[(cname, sname)] = _client_session(cmod, omod, srv.endpoint)
    finally:
        for srv in servers.values():
            srv.stop()
    want = results[("ref", "ref")]
    assert "no error" not in want and len(want) == 8
    for key, got in results.items():
        assert got == want, key


def test_raw_http_errors_and_etag_headers_match():
    def probe(srv):
        out = []
        for method, path, auth in (("GET", "/ccdata/x", None), ("PUT", "/ccdata", "AWS bad:sig"),
                                   ("GET", "/", "Bearer x")):
            req = urllib.request.Request(srv.endpoint + path, method=method,
                                         headers={"Authorization": auth} if auth else {})
            try:
                urllib.request.urlopen(req, timeout=5)
            except urllib.error.HTTPError as e:
                out.append((e.code, e.read()))
        return out

    ref, port = _served(ref_os, ref_server), _served(port_os, port_server)
    try:
        assert probe(port) == probe(ref)
        c_ref = ref_client.S3Client(ref.endpoint, ref_os.Credentials(*CREDS))
        c_port = ref_client.S3Client(port.endpoint, ref_os.Credentials(*CREDS))
        for c in (c_ref, c_port):
            c.create_bucket("ccdata")
            c.put("ccdata", "k", b"payload")
        heads = []
        for srv in (ref, port):  # a v2-signed HEAD
            headers = {"Date": email.utils.formatdate(usegmt=True)}
            sig = ref_server.sign_v2(CREDS[1], "HEAD", "/ccdata/k", headers)
            headers["Authorization"] = f"AWS {CREDS[0]}:{sig}"
            with urllib.request.urlopen(urllib.request.Request(
                    srv.endpoint + "/ccdata/k", method="HEAD", headers=headers)) as r:
                heads.append((r.headers["ETag"], r.headers["X-Object-Size"]))
        assert heads[0] == heads[1] == (f'"{ref_os._etag(b"payload")}"', "7")
    finally:
        ref.stop()
        port.stop()


def test_inproc_endpoints():
    st = port_os.ObjectStore()
    st.add_credentials(port_os.Credentials(*CREDS))
    st.create_bucket("ccdata")
    ep = port_os.register_inproc("t-store", st)
    c = port_client.S3Client(ep, port_os.Credentials(*CREDS))
    c.put("ccdata", "k", b"v")
    assert c.get("ccdata", "k") == b"v" and c.list("ccdata") == ["k"]
    with pytest.raises(port_os.AccessDenied):
        port_client.S3Client(ep, port_os.Credentials(CREDS[0], "wrong"))


def test_producer_reads_what_store_put_wrote(tmp_path):
    """`store serve` + `store put --file` (the commands, as processes) and the
    producer's store source: the same rows as the reference's loader."""
    from ccfd_tpu.data.ccfd import load_csv_bytes as ref_load
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.data.ccfd import synthetic_dataset, to_csv_bytes
    from ccfd_tpu_torch.producer.producer import dataset_from_store

    csv = tmp_path / "rows.csv"
    csv.write_bytes(to_csv_bytes(synthetic_dataset(n=200, seed=4)))
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    srv = subprocess.Popen([sys.executable, "-m", "ccfd_tpu_torch", "store", "serve",
                            "--port", "0", "--root", str(tmp_path / "root")],
                           stdout=subprocess.PIPE, env=env, text=True)
    try:
        endpoint = json.loads(srv.stdout.readline())["endpoint"]
        put = subprocess.run([sys.executable, "-m", "ccfd_tpu_torch", "store", "put",
                              "--endpoint", endpoint, "--file", str(csv)],
                             capture_output=True, text=True, env=env, timeout=60, check=True)
        assert json.loads(put.stdout) == {"bucket": "ccdata", "key": "creditcard.csv",
                                          "bytes": csv.stat().st_size}
        ls = subprocess.run([sys.executable, "-m", "ccfd_tpu_torch", "store", "ls",
                             "--endpoint", endpoint], capture_output=True, text=True,
                            env=env, timeout=60, check=True)
        assert json.loads(ls.stdout)["keys"] == ["creditcard.csv"]
        cfg = Config.from_env({"s3endpoint": endpoint, "ACCESS_KEY_ID": CREDS[0],
                               "SECRET_ACCESS_KEY": CREDS[1]})
        ds = dataset_from_store(cfg, limit=150)
        want = ref_load(csv.read_bytes(), limit=150)
        np.testing.assert_array_equal(ds.X, want.X)
        np.testing.assert_array_equal(ds.y, want.y)
    finally:
        srv.terminate()
        srv.wait(timeout=20)
