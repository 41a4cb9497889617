"""``train --from-store`` and the refused ``bench`` on the port, on the CPU.

- **train --from-store** against a port ``store serve`` on an ephemeral
  port holding a Kaggle-shaped surrogate CSV: the dataset the port reads
  through the store (``store/client.py::S3Client`` and
  ``data/ccfd.py::load_csv_bytes``) is byte-equal to the reference's
  ``load_csv_bytes`` of the same object, the held-out split is the
  reference's, and the command prints ``source`` (``store:<bucket>/<file>``),
  ``rows`` and ``test_rows`` as the reference's ``train --from-store``
  prints them for the same store.
- **bench** is refused by name (exit 2): the root ``bench.py`` is the JAX
  package's benchmark, not the port's.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
ROWS = 2000


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A port ``store serve`` on an ephemeral port, the surrogate CSV in it."""
    from ccfd_tpu_torch.data.ccfd import to_csv_bytes
    from ccfd_tpu_torch.data.surrogate import kaggle_surrogate

    tmp = tmp_path_factory.mktemp("store")
    csv = tmp / "creditcard.csv"
    csv.write_bytes(to_csv_bytes(kaggle_surrogate(n=ROWS)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen([sys.executable, "-m", "ccfd_tpu_torch", "store", "serve",
                             "--port", "0", "--root", str(tmp / "root")],
                            cwd=str(tmp), env=env, stdout=subprocess.PIPE, text=True)
    try:
        url = json.loads(proc.stdout.readline())["endpoint"]
        put = subprocess.run([sys.executable, "-m", "ccfd_tpu_torch", "store", "put",
                              "--endpoint", url, "--file", str(csv)],
                             cwd=str(tmp), env=env, capture_output=True, text=True,
                             timeout=60)
        assert put.returncode == 0, put.stderr
        yield url, csv.read_bytes()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def _json_of(fn, argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_the_store_dataset_and_split_are_the_references(store):
    from ccfd_tpu.data.ccfd import load_csv_bytes as ref_load
    from ccfd_tpu.store.client import S3Client as RefClient
    from ccfd_tpu.store.objectstore import Credentials as RefCreds
    from ccfd_tpu_torch.cli import held_out_split, store_dataset
    from ccfd_tpu_torch.config import Config

    url, raw = store
    cfg = Config.from_env()
    ds, source = store_dataset(cfg, url)
    ref = ref_load(RefClient(url, RefCreds("ccfd-access", "ccfd-secret")).get(
        cfg.s3_bucket, cfg.filename))
    assert source == f"store:{cfg.s3_bucket}/{cfg.filename}"
    assert ds.n == ref.n == ROWS
    assert ds.X.dtype == ref.X.dtype and ds.X.tobytes() == ref.X.tobytes()
    assert ds.y.tobytes() == ref.y.tobytes()
    # the reference's split, as its cmd_train draws it
    order = np.random.default_rng(0).permutation(ref.n)
    n_test = max(1, int(ref.n * 0.2))
    test, train = held_out_split(ds.n, 0.2)
    assert test.tolist() == order[:n_test].tolist()
    assert train.tolist() == order[n_test:].tolist()


def test_train_from_store_prints_the_references_source_and_rows(store, tmp_path):
    from ccfd_tpu.cli import main as ref_main
    from ccfd_tpu_torch.cli import main

    url, _ = store
    rc, port = _json_of(main, ["train", "--from-store", "--store-url", url, "--steps", "3",
                               "--device", "cpu", "--checkpoint-dir", str(tmp_path / "p")])
    assert rc == 0
    rc_ref, ref = _json_of(ref_main, ["train", "--from-store", "--store-url", url,
                                      "--steps", "2", "--checkpoint-dir",
                                      str(tmp_path / "r")])
    assert rc_ref == 0
    for k in ("source", "rows", "test_rows"):
        assert port[k] == ref[k], k
    assert port["source"].startswith("store:") and port["rows"] == ROWS
    assert 0.0 <= port["auc_mlp"] <= 1.0
    assert Path(port["checkpoint"]).exists()


def test_train_from_an_unreachable_store_fails_loudly(tmp_path):
    from ccfd_tpu_torch.cli import main

    with pytest.raises(Exception):
        main(["train", "--from-store", "--store-url", "http://127.0.0.1:1", "--steps", "1",
              "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # nothing trained, nothing written


@pytest.mark.parametrize("argv", [["bench"], ["bench", "all", "x"]])
def test_bench_is_refused_by_name(argv, capsys):
    from ccfd_tpu_torch.cli import main

    assert main(argv) == 2
    err = capsys.readouterr().err
    assert "bench.py is the JAX package's benchmark" in err
    assert "BENCHMARK.json" in err
