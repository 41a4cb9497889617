"""The port's native decoders (ccfd_tpu_torch/native, built here with g++)
against their plain versions and the JAX package's native decoders.

Every case runs the same seeded bytes through three functions: the port's
native one, its plain numpy version, and ``ccfd_tpu.native``'s. The port's
native decoders are the reference's source, so they must agree with the
reference's bit for bit, bail-outs included; against the plain versions
the bar is the reference's (tests/test_native.py: rtol 1e-5, atol 1e-6),
since ``strtof`` rounds once where ``float()`` and a float32 cast round
twice.
"""

import json
import random

import numpy as np
import pytest

from ccfd_tpu import native as ref_native
from ccfd_tpu_torch import native
from ccfd_tpu_torch.router import router as port_router

RTOL, ATOL = 1e-5, 1e-6


def make_csv(n_rows: int, n_features: int = 30, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    return ("\n".join(",".join(f"{v:.6f}" for v in row) for row in m) + "\n").encode()


def make_payload(n_rows: int, n_features: int = 30, seed: int = 0, fmt: str = "repr") -> bytes:
    rng = np.random.default_rng(seed)
    m = (rng.normal(size=(n_rows, n_features)) * 10.0 ** rng.integers(-3, 4, (n_rows, 1)))
    rows = m.astype(np.float32).tolist() if fmt == "repr" else [
        [float(f"{v:.3e}") for v in r] for r in m]
    return json.dumps({"data": {"names": [], "ndarray": rows}}).replace(
        '"names": [], ', "").encode()


def test_the_reference_decoders_are_native_here():
    assert ref_native.native_available()


def _csv_three(data: bytes, nf: int = 30):
    got = native.decode_csv(data, nf)
    plain = native._decode_csv_numpy(data, nf)
    ref = ref_native.decode_csv(data, nf)
    return got, plain, ref


@pytest.mark.parametrize("seed,rows", [(0, 1), (1, 100), (2, 2500)])
def test_decode_csv_round_trip(seed, rows):
    (x, bad), (xp, badp), (xr, badr) = _csv_three(make_csv(rows, seed=seed))
    assert x.dtype == np.float32 and x.shape == (rows, 30) and bad == badp == badr == 0
    np.testing.assert_array_equal(x, xr)
    np.testing.assert_allclose(x, xp, rtol=RTOL, atol=ATOL)


def test_decode_csv_bad_rows_zero_filled():
    data = b"1.0,2.0\nnot,a,row\n" + make_csv(1, seed=3)
    for x, bad in _csv_three(data):
        assert x.shape == (3, 30) and bad == 2
        assert np.all(x[0] == 0.0) and np.all(x[1] == 0.0) and not np.all(x[2] == 0.0)


def test_decode_csv_empty_input():
    for x, bad in _csv_three(b""):
        assert x.shape == (0, 30) and bad == 0


def test_decode_csv_too_many_fields_and_crlf():
    for x, bad in _csv_three(b"1.0,2.0,3.0\n", 2):
        assert bad == 1 and np.all(x[0] == 0.0)
    for x, bad in _csv_three(b"1.0,2.0\r\n3.0,4.0\r\n", 2):
        assert bad == 0
        np.testing.assert_allclose(x, [[1, 2], [3, 4]])


def test_decode_csv_fuzz_never_crashes_and_matches_the_reference():
    rng = random.Random(1)
    for _ in range(600):
        junk = bytes(rng.randrange(256) for _ in range(rng.randint(0, 300)))
        (x, bad), _plain, (xr, badr) = _csv_three(junk)
        assert x.shape == xr.shape and x.shape[1] == 30 and bad == badr
        np.testing.assert_array_equal(x, xr)


def test_the_router_decodes_csv_records_natively(monkeypatch):
    """decode_records' CSV rows go through native.decode_csv."""
    calls = []
    real = native.decode_csv

    def spy(data, n_features=30):
        calls.append(len(data))
        return real(data, n_features)

    monkeypatch.setattr(native, "decode_csv", spy)

    class Rec:
        def __init__(self, value, key):
            self.value, self.key = value, key

    lines = make_csv(5, seed=4).splitlines()
    x, txs, bad = port_router.decode_records([Rec(ln, f"k{i}") for i, ln in enumerate(lines)])
    assert calls and bad == 0 and x.shape == (5, 30)
    np.testing.assert_array_equal(x, ref_native.decode_csv(b"\n".join(lines) + b"\n")[0])


def _nd_three(body: bytes, nf: int = 30):
    return (native.decode_ndarray_json(body, nf), native._decode_ndarray_json_numpy(body, nf),
            ref_native.decode_ndarray_json(body, nf))


@pytest.mark.parametrize("body,nf", [
    (make_payload(16, seed=5), 30),
    (make_payload(300, seed=6, fmt="sci"), 30),
    (make_payload(1, seed=7), 30),
    (b'{"data": {"ndarray": [[1.0, 2.5, -3e2], [4, 5, 6]]}}', 3),
    (b'{"data":{"ndarray":[[7.0]]}}', 3),  # short rows zero-pad
    (b'{ "data" : { "ndarray" : [ [ 1 , 2 ] , [ 3 , 4 ] ] } }', 2),
    (b'{"data":{"ndarray":[]}}', 3),  # a valid zero-row decode
    (b'{"meta":{},"data":{"ndarray":[[1,2,3]]}}', 3),  # meta before data
])
def test_decode_ndarray_canonical_payloads(body, nf):
    x, plain, ref = _nd_three(body, nf)
    assert x is not None and plain is not None and x.dtype == np.float32
    assert x.shape == plain.shape == ref.shape and x.shape[1] == nf
    np.testing.assert_array_equal(x, ref)
    np.testing.assert_allclose(x, plain, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("body", [
    b'{"data":{"names":["Amount"],"ndarray":[[1]]}}',  # names: column remapping
    b'{"data":{"ndarray":[["x"]]}}',  # a non-numeric cell
    b'{"data":{"ndarray":[[1,2,3,4]]}}',  # wider than the schema
    b'{"data":{"ndarray":[[1,2', b'{"data":{}}', b"",  # malformed, no key, empty
    b'{"data":{"ndarray":[[1,2,3]]', b'{"data":{"ndarray":[[1,2,3]]}',  # truncated
    b'{"ndarray":[[1,2,3]]}',  # no data wrapper
    b'{"data":{"ndarray":[[1]]}}}',  # over-closed
    b'{"data":{"ndarray":[[1,2,3]]},"meta":{"x":1}}',  # keys after the matrix
    b'{"data":{"ndarray":[[true]]}}', b'{"data":{"ndarray":[[1,[2]]]}}',
])
def test_decode_ndarray_bails_to_the_json_route(body):
    assert _nd_three(body, 3) == (None, None, None)


def test_decode_ndarray_over_the_row_cap_bails():
    body = make_payload(40, seed=8)
    assert native.decode_ndarray_json(body, 30, max_rows=39) is None
    assert native._decode_ndarray_json_numpy(body, 30, max_rows=39) is None
    assert native.decode_ndarray_json(body, 30, max_rows=40).shape == (40, 30)


def test_decode_ndarray_fuzz_never_crashes_and_matches_the_reference():
    rng = random.Random(0)
    base = b'{"data": {"ndarray": [[1.5, -2.5, 3e10], [4, 5, 6]]}}'
    charset = b'[]{}",:.0123456789eE+-na '
    for _ in range(2000):
        b = bytearray(base)
        for _ in range(rng.randint(1, 6)):
            op, pos = rng.random(), rng.randrange(len(b)) if b else 0
            if op < 0.4 and b:
                b[pos] = rng.choice(charset)
            elif op < 0.7 and b:
                del b[pos]
            else:
                b.insert(pos, rng.choice(charset))
        got, want = native.decode_ndarray_json(bytes(b), 3), ref_native.decode_ndarray_json(
            bytes(b), 3)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.shape == want.shape and got.shape[1] == 3
            np.testing.assert_array_equal(got, want)
    for _ in range(300):
        junk = bytes(rng.randrange(256) for _ in range(rng.randint(0, 200)))
        out = native.decode_ndarray_json(junk, 3)
        assert out is None or (out.ndim == 2 and out.shape[1] == 3)
    assert native.decode_ndarray_json(b'{"data":{"ndarray":' + b"[" * 10000, 3) is None
    deep = b'{"data":{"ndarray":[' + b"[1]," * 5000 + b"[1]]}}"
    assert native.decode_ndarray_json(deep, 3).shape == (5001, 3)


@pytest.mark.parametrize("bucket", [2, 4, 6, 16])
def test_pad_batch_semantics(bucket):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = native.pad_batch(x, bucket)
    assert got.shape == (bucket, 3)
    np.testing.assert_array_equal(got, native._pad_batch_numpy(x, bucket))
    np.testing.assert_array_equal(got, ref_native.pad_batch(x, bucket))


def test_the_library_builds_from_the_ports_sources_into_build():
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parts[-3:-1] == ("build", "ccfd_tpu_torch")
    cmd = native.build_command(path)
    srcs = [a for a in cmd if a.endswith(".cpp")]
    assert [p.rsplit("/", 2)[-2:] for p in srcs] == [["native", "decode.cpp"],
                                                       ["native", "httpfront.cpp"],
                                                       ["native", "log.cpp"]]
    assert all("/ccfd_tpu_torch/native/" in p for p in srcs)
    assert not any("/ccfd_tpu/" in a for a in cmd)
    assert {"-O3", "-shared", "-fPIC", "-pthread"} <= set(cmd)


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 3\n")
    script.chmod(0o755)
    monkeypatch.setenv("CXX", str(script))
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.build()
