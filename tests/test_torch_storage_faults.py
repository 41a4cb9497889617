"""The port's storage fault plans (ccfd_tpu_torch/runtime/faults.py) and
their draws in ``durability.atomic_write_bytes`` against the reference's
(ccfd_tpu/runtime/faults.py, ccfd_tpu/runtime/durability.py).

- **Plans**: the same parse, the same errors, and the same seeded draw
  sequence (1,000 draws a kind, and a mixed plan whose kinds share one
  generator).
- **The seam**: under each storage kind the same write lands the same
  bytes, leaves the same tmp debris and raises the same errno on both
  sides; a mixed plan over 200 writes does so write for write, which holds
  the port to the reference's draw order.
- **Recovery**: a bitrotted engine snapshot is quarantined to ``*.corrupt``
  and the last-good generation loads, on both sides; the object store
  labels its writes ``artifact="object"``.
"""

from __future__ import annotations

import errno
import os

import numpy as np
import pytest

from ccfd_tpu.runtime import durability as ref_dur
from ccfd_tpu.runtime import faults as ref_faults
from ccfd_tpu_torch.runtime import durability as port_dur
from ccfd_tpu_torch.runtime import faults as port_faults

SIDES = {"ref": (ref_faults, ref_dur), "port": (port_faults, port_dur)}


@pytest.fixture(autouse=True)
def _no_leaked_plans():
    yield
    for faults, _dur in SIDES.values():
        faults.install_storage_faults(None)
        faults.install_device_faults(None)


def test_storage_kinds_and_spec_defaults_are_the_references():
    assert port_faults.STORAGE_FAULT_KINDS == ref_faults.STORAGE_FAULT_KINDS
    for body in ("", "rate=0.5", "ms=10,frac=0.3", " rate = 0.25 , ms=0 "):
        got = port_faults.StorageFaultSpec.parse(body)
        want = ref_faults.StorageFaultSpec.parse(body)
        assert (got.rate, got.ms, got.frac) == (want.rate, want.ms, want.frac), body


@pytest.mark.parametrize("text,match", [
    ("warp_drive", "unknown storage fault"),
    ("bitrot:bogus=1", "unknown storage-fault option"),
    ("bitrot:rate", "expected key=value"),
    ("bitrot:rate=2", "outside"),
    ("torn_write:frac=-0.1", "outside"),
    ("slow_disk:ms=-1", "must be >= 0"),
])
def test_bad_storage_plans_fail_with_the_references_message(text, match):
    with pytest.raises(ValueError, match=match) as want:
        ref_faults.StorageFaultPlan.from_string(text)
    with pytest.raises(ValueError, match=match) as got:
        port_faults.StorageFaultPlan.from_string(text)
    assert str(got.value) == str(want.value)


def _draws(faults, text: str, seed: int, kinds, n: int) -> list:
    plan = faults.StorageFaultPlan.from_string(text, seed=seed)
    return [[plan.draw(k) is not None for k in kinds] for _ in range(n)], dict(plan.injected)


@pytest.mark.parametrize("kind", ref_faults.STORAGE_FAULT_KINDS)
def test_one_kind_draws_the_same_1000_times(kind):
    rate = float(np.random.default_rng(len(kind)).uniform(0.1, 0.9))
    text = f"{kind}:rate={rate}"
    got = _draws(port_faults, text, 11, [kind], 1000)
    want = _draws(ref_faults, text, 11, [kind], 1000)
    assert got == want
    assert 0 < got[1][kind] < 1000


def test_a_mixed_plan_shares_one_generator_in_the_same_order():
    text = ";".join(f"{k}:rate=0.3" for k in ref_faults.STORAGE_FAULT_KINDS)
    kinds = list(ref_faults.STORAGE_FAULT_KINDS)
    for seed in (0, 5):
        assert _draws(port_faults, text, seed, kinds, 1000) == \
            _draws(ref_faults, text, seed, kinds, 1000)


def test_activation_toggle_is_the_references():
    for faults in (ref_faults, port_faults):
        plan = faults.StorageFaultPlan.from_string("bitrot", active=False)
        assert plan.draw("bitrot") is None and not plan.active
        plan.activate()
        assert plan.draw("bitrot") is not None and plan.activations == 1
        plan.deactivate()
        assert plan.draw("bitrot") is None and plan.injected == {"bitrot": 1}


def _write(side: str, root, text: str | None, data: bytes, seed: int = 0,
           fsync: bool = True) -> dict:
    """One atomic write on ``side`` over a previous artifact: what landed,
    the tmp debris and the errno raised."""
    faults, dur = SIDES[side]
    d = root / side
    d.mkdir(exist_ok=True)
    path = str(d / "artifact.bin")
    faults.install_storage_faults(None)
    dur.atomic_write_bytes(path, b"previous bytes")
    faults.install_storage_faults(
        faults.StorageFaultPlan.from_string(text, seed=seed) if text else None)
    err = None
    try:
        dur.atomic_write_bytes(path, data, fsync=fsync, artifact="drill")
    except OSError as e:
        err = e.errno
    finally:
        faults.install_storage_faults(None)
    debris = sorted(open(d / n, "rb").read() for n in os.listdir(d) if n.endswith(".tmp"))
    for n in os.listdir(d):
        if n.endswith(".tmp"):
            os.unlink(d / n)
    with open(path, "rb") as f:
        landed = f.read()
    return {"landed": landed, "debris": debris, "errno": err}


WANT_ERRNO = {"enospc": errno.ENOSPC, "torn_write": errno.EIO, "fsync_fail": errno.EIO}


@pytest.mark.parametrize("kind", ref_faults.STORAGE_FAULT_KINDS)
def test_each_storage_kind_lands_the_same_bytes_and_debris(tmp_path, kind):
    data = np.random.default_rng(3).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    text = f"{kind}:ms=1" if kind == "slow_disk" else kind
    got = _write("port", tmp_path, text, data)
    want = _write("ref", tmp_path, text, data)
    assert got == want
    assert got["errno"] == WANT_ERRNO.get(kind)
    if kind in ("enospc", "torn_write", "fsync_fail", "rename_lost"):
        assert got["landed"] == b"previous bytes"  # the last-good bytes survive
    if kind == "torn_write":
        assert got["debris"] == [data[:2048]]  # a prefix of frac 0.5 in the tmp
    if kind == "rename_lost":
        assert got["debris"] == [data]  # synced, never renamed
    if kind == "bitrot":
        flipped = bytearray(data)
        flipped[2048] ^= 0xFF
        assert got["landed"] == bytes(flipped)
    if kind == "slow_disk":
        assert got["landed"] == data


def test_fsync_fail_draws_only_when_syncing(tmp_path):
    data = b"x" * 100
    got = _write("port", tmp_path, "fsync_fail", data, fsync=False)
    assert got == _write("ref", tmp_path, "fsync_fail", data, fsync=False)
    assert got["errno"] is None and got["landed"] == data


@pytest.mark.parametrize("seed", [0, 9])
def test_a_mixed_plan_faults_the_same_writes_in_the_same_order(tmp_path, seed):
    text = ";".join(f"{k}:rate=0.3" + (",ms=0" if k == "slow_disk" else "")
                    for k in ref_faults.STORAGE_FAULT_KINDS)
    sides = {}
    for side, (faults, dur) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        path = str(d / "a.bin")
        plan = faults.StorageFaultPlan.from_string(text, seed=seed)
        faults.install_storage_faults(plan)
        out = []
        rs = np.random.default_rng(seed)
        for i in range(200):
            data = rs.integers(0, 256, 64 + i, dtype=np.uint8).tobytes()
            try:
                dur.atomic_write_bytes(path, data)
                err = None
            except OSError as e:
                err = e.errno
            tmps = sorted(n for n in os.listdir(d) if n.endswith(".tmp"))
            debris = [open(d / n, "rb").read() for n in tmps]
            for n in tmps:
                os.unlink(d / n)
            landed = open(path, "rb").read() if os.path.exists(path) else None
            out.append((err, landed, debris))
        faults.install_storage_faults(None)
        sides[side] = (out, dict(plan.injected))
    assert sides["port"] == sides["ref"]
    assert set(sides["port"][1]) == set(ref_faults.STORAGE_FAULT_KINDS)


def test_flip_bytes_is_the_references(tmp_path):
    for side, (_f, dur) in SIDES.items():
        p = tmp_path / f"{side}.bin"
        p.write_bytes(bytes(range(200)))
        dur.flip_bytes(str(p))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    assert (tmp_path / "port.bin").read_bytes() != bytes(range(200))


def test_bitrotted_engine_state_loads_the_last_good_generation(tmp_path):
    """The engine's snapshot under CCFD_STORAGE_FAULTS=bitrot: the corrupt
    file is quarantined to ``*.corrupt`` and the newest generation that
    verifies loads, on both sides."""
    out = {}
    for side, (faults, dur) in SIDES.items():
        d = tmp_path / side
        path = str(d / "engine.json")
        dur.write_json_artifact(path, {"gen": 1}, artifact="engine")
        faults.install_storage_faults(faults.StorageFaultPlan.from_string("bitrot"))
        dur.write_json_artifact(path, {"gen": 2}, artifact="engine")
        faults.install_storage_faults(None)
        doc = dur.read_json_artifact(path, artifact="engine")
        out[side] = (doc, sorted(os.listdir(d)))
    assert out["port"] == out["ref"]
    doc, names = out["port"]
    assert doc == {"gen": 1}
    assert "engine.json.corrupt" in names


def test_the_port_engine_quarantines_a_bitrotted_state_file(tmp_path):
    """``Engine.save`` under an installed bitrot plan, then ``load``: the
    corrupt file goes to ``*.corrupt`` and the last-good generation
    loads (the engine's state survives on its generations)."""
    from ccfd_tpu_torch.bus.broker import Broker
    from ccfd_tpu_torch.config import Config
    from ccfd_tpu_torch.metrics.prom import Registry
    from ccfd_tpu_torch.process.fraud import build_engine

    cfg = Config()
    path = str(tmp_path / "engine.state")
    eng = build_engine(cfg, Broker(default_partitions=1), Registry(), None)
    eng.start_process_batch("standard", [{"transaction": {"id": i}, "proba": 0.1}
                                         for i in range(5)])
    eng.save(path)
    first = eng.snapshot()
    eng.start_process_batch("standard", [{"transaction": {"id": 9}, "proba": 0.1}])
    port_faults.install_storage_faults(port_faults.StorageFaultPlan.from_string("bitrot"))
    eng.save(path)
    port_faults.install_storage_faults(None)
    fresh = build_engine(cfg, Broker(default_partitions=1), Registry(), None)
    fresh.load(path)
    assert fresh.snapshot()["next_pid"] == first["next_pid"]
    assert os.path.exists(path + ".corrupt")
    eng.shutdown()
    fresh.shutdown()


def test_the_object_store_labels_its_writes_object(tmp_path, monkeypatch):
    from ccfd_tpu_torch.store.objectstore import ObjectStore

    seen = []
    real = port_dur.atomic_write_bytes

    def spy(path, data, fsync=None, artifact="artifact"):
        seen.append(artifact)
        return real(path, data, fsync=fsync, artifact=artifact)

    monkeypatch.setattr(port_dur, "atomic_write_bytes", spy)
    store = ObjectStore(root=str(tmp_path))
    store.create_bucket("ccdata")
    store.put("ccdata", "k", b"payload")
    assert seen == ["object"]
    assert store.get("ccdata", "k") == b"payload"
