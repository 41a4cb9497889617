"""The port's linter (ccfd_tpu_torch/analysis/) against the reference's
(ccfd_tpu/analysis/), and the port's tree held to it.

- **The same findings.** Every rule fixture of tests/test_lint.py goes
  through both linters (each on its own package's path): the (rule, line)
  findings are equal, and the reference test's own expectation holds.
- **hot-path-sync** names torch's device-to-host syncs in the port
  (``.cpu()``, ``.numpy()``, ``.tolist()``, ``.to("cpu")``,
  ``torch.cuda.synchronize()``, ``np.array``), where the reference's names
  JAX's (``jax.device_get``, ``.block_until_ready()``): those cases are the
  port's own, with the deviation pinned both ways.
- **Pragmas, the baseline round trip and the JSON schema**, as the
  reference's tests hold them, plus the ``lint`` command's exits.
- **The port's tree** lints clean against the port's own baseline
  (``ccfd_tpu_torch/assets/lint_baseline.json``), which is empty.
- **The lock sanitizer's five behaviours** on the port's lockcheck.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import pytest

from ccfd_tpu.analysis import core as ref_core
from ccfd_tpu.analysis.rules import metric_name_ok as ref_metric_name_ok
from ccfd_tpu_torch.analysis import core as lint_core
from ccfd_tpu_torch.analysis import lockcheck
from ccfd_tpu_torch.analysis.rules import metric_name_ok

REPO = Path(__file__).resolve().parents[1]


def run_rule(core, rule, src, tail="serving/fake_mod.py"):
    """(rule, line) findings of one rule over a virtual file of the package
    ``core`` lints (``ccfd_tpu/<tail>`` or ``ccfd_tpu_torch/<tail>``)."""
    pkg = "ccfd_tpu_torch" if core is lint_core else "ccfd_tpu"
    report = core.lint_sources({f"{pkg}/{tail}": src}, rule_names=[rule])
    return [(f.rule, f.line) for f in report.findings], report.findings


SEAM_SRC = (
    "import time, json, os\n"
    "import numpy as np\n"
    "def save(path, doc, arr):\n"
    "    with open(path, 'w') as f:\n"
    "        json.dump(doc, f)\n"
    "    os.replace(path + '.tmp', path)\n"
    "    np.savez(path, arr=arr)\n"
)
DROPS_OK = (
    "def a(self):\n    try:\n        work()\n    except Exception:\n        self._c_dropped.inc()\n"
    "def b(self):\n    try:\n        work()\n    except Exception:\n"
    "        log.warning('dropped', exc_info=True)\n"
    "def c(self):\n    try:\n        work()\n    except Exception:\n        raise\n"
    "def d(self, fut):\n    try:\n        work()\n    except Exception as e:\n"
    "        fut.set_exception(e)\n"
)
NARROW = "def a(self):\n    try:\n        work()\n    except (OSError, ValueError):\n        pass\n"
BREAKER_BALANCED = (
    "def call(self):\n    if not self._breaker.allow():\n        raise ConnectionError\n"
    "    try:\n        out = do()\n    except Exception:\n"
    "        self._breaker.record_failure(0.0)\n        raise\n"
    "    self._breaker.record_success(0.0)\n    return out\n"
)
LOCKS = "class S:\n    def f(self):\n{f}    def g(self):\n{g}"
NESTED_AB = "        with self._lock:\n            with self._mu:\n                pass\n"
NESTED_BA = "        with self._mu:\n            with self._lock:\n                pass\n"

# (id, rule, source, path tail, expected (rule, line) lines or a predicate)
SAME = [
    ("durability_flags_open_write_rename_jsondump_savez", "durability-seam", SEAM_SRC,
     "serving/fake_mod.py", [4, 5, 6, 7]),
    ("durability_read_mode_passes", "durability-seam",
     "def load(path):\n    return open(path).read()\n", "serving/fake_mod.py", []),
    ("durability_seam_module_passes", "durability-seam",
     "import os\ndef sw(a, b):\n    os.replace(a, b)\n", "runtime/durability.py", []),
    ("durability_savez_into_bytesio_is_sanctioned", "durability-seam",
     "import io\nimport numpy as np\ndef save(arr):\n    buf = io.BytesIO()\n"
     "    np.savez(buf, arr=arr)\n    return buf.getvalue()\n", "serving/fake_mod.py", []),
    ("monotonic_flags_time_time_pair", "monotonic-durations",
     "import time\ndef work():\n    t0 = time.time()\n    do()\n    return time.time() - t0\n",
     "serving/fake_mod.py", [5]),
    ("monotonic_flags_two_wall_names", "monotonic-durations",
     "import time\ndef work(rec):\n    a = time.time()\n    b = time.time()\n    return b - a\n",
     "serving/fake_mod.py", [5]),
    ("monotonic_perf_counter_and_plain_timestamps_pass", "monotonic-durations",
     "import time\ndef work(record):\n    t0 = time.perf_counter()\n    do()\n"
     "    record['ts'] = time.time()\n    return time.perf_counter() - t0\n",
     "serving/fake_mod.py", []),
    ("drops_flags_silent_broad_swallow", "counted-drops",
     "def drain(self):\n    try:\n        work()\n    except Exception:\n        pass\n",
     "router/fake.py", [4]),
    ("drops_counter_log_raise_and_future_delivery_pass", "counted-drops", DROPS_OK,
     "bus/fake.py", []),
    ("drops_narrow_catches_pass", "counted-drops", NARROW, "serving/fake.py", []),
    ("drops_foreign_modules_out_of_scope", "counted-drops",
     NARROW.replace("(OSError, ValueError)", "Exception"), "runtime/fake.py", []),
    ("drops_fleet_is_in_scope", "counted-drops",
     NARROW.replace("(OSError, ValueError)", "Exception"), "fleet/fake.py", [4]),
    ("metric_flags_bad_kinds", "metric-naming",
     "def build(r):\n    r.counter('things_done')\n    r.gauge('events_total')\n"
     "    r.histogram('latency')\n", "serving/fake_mod.py", [2, 3, 4]),
    ("metric_convention_and_reference_names_pass", "metric-naming",
     "def build(r):\n    r.counter('things_done_total')\n    r.gauge('queue_depth')\n"
     "    r.histogram('latency_seconds')\n    r.histogram('fraud_approved_amount')\n"
     "    r.gauge('proba_1')\n", "serving/fake_mod.py", []),
    ("breaker_flags_gated_call_with_zero_outcomes", "breaker-outcome",
     "def call(self):\n    if not self._breaker.allow():\n        raise ConnectionError\n"
     "    return do()\n", "serving/fake_mod.py",
     lambda fs: len(fs) == 1 and "never" in fs[0].message),
    ("breaker_flags_missing_failure_path", "breaker-outcome",
     "def call(self):\n    if not self._breaker.allow():\n        raise ConnectionError\n"
     "    out = do()\n    self._breaker.record_success(0.0)\n    return out\n",
     "serving/fake_mod.py", lambda fs: len(fs) == 1 and "record_failure" in fs[0].message),
    ("breaker_flags_double_record_on_one_path", "breaker-outcome",
     BREAKER_BALANCED.replace("    return out\n",
                              "    self._breaker.record_success(0.0)\n    return out\n"),
     "serving/fake_mod.py", lambda fs: any("two breaker outcomes" in f.message for f in fs)),
    ("breaker_balanced_gate_passes", "breaker-outcome", BREAKER_BALANCED,
     "serving/fake_mod.py", []),
    ("hot_path_flags_syncs_only_in_marked_functions", "hot-path-sync",
     "import numpy as np\n# ccfd-lint: hot-path\ndef hot(dev):\n    x = np.asarray(dev)\n"
     "    y = dev.item()\n    z = float(dev)\n    return x, y, z\ndef cold(dev):\n"
     "    return np.asarray(dev)\n", "serving/fake_mod.py", [4, 5, 6]),
    ("hot_path_clean_passes", "hot-path-sync",
     "# ccfd-lint: hot-path\ndef hot(dev, fn):\n    return fn(dev)\n", "serving/fake_mod.py",
     []),
    ("hot_path_seam_allows_only_the_dispatch_transfer", "hot-path-sync",
     "import numpy as np\ndef _score_direct(self, x):\n    p = np.asarray(self._score2(x))\n"
     "    return np.asarray(p), p.tolist()\n", "router/router.py", [4, 4]),
    ("lock_lexical_inversion_flagged", "lock-order",
     LOCKS.format(f=NESTED_AB, g=NESTED_BA), "serving/fake_mod.py",
     lambda fs: len(fs) == 1 and "cycle" in fs[0].message),
    ("lock_consistent_order_passes", "lock-order",
     LOCKS.format(f=NESTED_AB, g=NESTED_AB), "serving/fake_mod.py", []),
    ("lock_multi_item_with_records_the_order", "lock-order",
     LOCKS.format(f="        with self._lock, self._mu:\n            pass\n", g=NESTED_BA),
     "serving/fake_mod.py", lambda fs: len(fs) == 1 and "cycle" in fs[0].message),
]


@pytest.mark.parametrize("rule,src,tail,expect", [c[1:] for c in SAME],
                         ids=[c[0] for c in SAME])
def test_both_linters_give_the_same_findings(rule, src, tail, expect):
    port, port_fs = run_rule(lint_core, rule, src, tail)
    ref, _ = run_rule(ref_core, rule, src, tail)
    assert port == ref
    if callable(expect):
        assert expect(port_fs)
    else:
        assert [line for _, line in port] == expect


# -- hot-path-sync: torch's syncs (the port's deviation) -----------------------

TORCH_SYNCS = [
    ("cpu", "    return t.cpu()\n"),
    ("numpy", "    return t.numpy()\n"),
    ("tolist", "    return t.tolist()\n"),
    ("item", "    return t.item()\n"),
    ("to_cpu", "    return t.to('cpu')\n"),
    ("to_device_kw", "    return t.to(device='cpu')\n"),
    ("cuda_synchronize", "    torch.cuda.synchronize()\n    return t\n"),
    ("cuda_synchronize_dev", "    torch.cuda.synchronize(t.device)\n    return t\n"),
    ("stream_synchronize", "    s.synchronize()\n    return t\n"),
    ("np_array", "    return np.array(t)\n"),
    ("float", "    return float(t)\n"),
]


@pytest.mark.parametrize("body", [b for _, b in TORCH_SYNCS], ids=[n for n, _ in TORCH_SYNCS])
def test_each_torch_sync_is_flagged_in_a_hot_path(body):
    src = ("import numpy as np\nimport torch\n# ccfd-lint: hot-path\n"
           "def hot(t, s):\n" + body + "def cold(t, s):\n" + body)
    port, _ = run_rule(lint_core, "hot-path-sync", src)
    assert port == [("hot-path-sync", 5)]


def test_the_sync_sets_deviate_by_name_only():
    """JAX's sync shapes are not the port's (and torch's are not the
    reference's); the shapes both name stay flagged by both."""
    jax_src = ("import jax\n# ccfd-lint: hot-path\ndef hot(a):\n"
               "    b = jax.device_get(a)\n    return a.block_until_ready()\n")
    assert run_rule(lint_core, "hot-path-sync", jax_src)[0] == []
    assert [ln for _, ln in run_rule(ref_core, "hot-path-sync", jax_src)[0]] == [4, 5]
    torch_src = ("import torch\n# ccfd-lint: hot-path\ndef hot(t):\n"
                 "    torch.cuda.synchronize()\n    return t.cpu()\n")
    assert [ln for _, ln in run_rule(lint_core, "hot-path-sync", torch_src)[0]] == [4, 5]
    assert run_rule(ref_core, "hot-path-sync", torch_src)[0] == []


def test_the_seam_refuses_a_synchronize_even_on_a_call():
    src = ("import torch\ndef _score_batch(self, x):\n"
           "    torch.cuda.synchronize(self._dev())\n    return self._score2(x)\n")
    assert run_rule(lint_core, "hot-path-sync", src, "router/router.py")[0] == [
        ("hot-path-sync", 3)]


def test_the_ports_hot_paths_are_marked_where_the_references_are():
    """The reference marks its kernel entry and the history store's
    prepare/commit; the port marks their counterparts (its kernel entry
    and the named-path launch that entry calls, which holds the launch's
    code)."""
    import ast

    def marked(path: Path) -> set[str]:
        ctx = lint_core.FileContext(str(path), path.read_text())
        return {fn.name for fn in ast.walk(ctx.tree)
                if isinstance(fn, ast.FunctionDef)
                and (fn.lineno - 1) in ctx.hot_path_lines}

    assert marked(REPO / "ccfd_tpu_torch" / "ops" / "fused_mlp.py") == {"fused_mlp_score",
                                                                         "launch"}
    assert marked(REPO / "ccfd_tpu_torch" / "serving" / "history.py") == {"prepare", "commit"}
    assert {"fused_mlp_score"} <= marked(REPO / "ccfd_tpu" / "ops" / "fused_mlp.py")


def test_metric_name_helper_is_the_references():
    for kind, name in (("counter", "x_total"), ("counter", "x"), ("gauge", "x_total"),
                       ("histogram", "x_seconds"), ("gauge", "proba_1"),
                       ("histogram", "router_batch_size"), ("histogram", "x")):
        assert metric_name_ok(kind, name) == ref_metric_name_ok(kind, name)
    assert metric_name_ok("counter", "x_total") is None
    assert metric_name_ok("gauge", "proba_1") is None


# -- suppression pragmas + baseline round trip ---------------------------------

SRC = ("import time\ndef work():\n    t0 = time.time()\n    return time.time() - t0\n")
PATH = "ccfd_tpu_torch/x.py"


def _lint(src, **kw):
    return lint_core.lint_sources({PATH: src}, rule_names=["monotonic-durations"], **kw)


def test_inline_pragma_with_justification_suppresses():
    src = SRC.replace("    return time.time() - t0\n",
                      "    # ccfd-lint: disable=monotonic-durations -- wall-clock by contract\n"
                      "    return time.time() - t0\n")
    report = _lint(src)
    assert report.findings == [] and len(report.suppressed) == 1 and report.exit_code == 0


def test_bare_pragma_is_itself_a_finding():
    src = SRC.replace("    return time.time() - t0\n",
                      "    return time.time() - t0  # ccfd-lint: disable=monotonic-durations\n")
    assert [f.rule for f in _lint(src).findings] == ["bare-pragma"]


def test_file_level_disable():
    assert _lint("# ccfd-lint: disable-file=monotonic-durations -- fixture\n" + SRC
                 ).findings == []


def test_pragma_inside_string_literal_is_inert():
    src = 'HELP = "# ccfd-lint: disable-file=monotonic-durations -- doc"\n' + SRC
    assert len(_lint(src).findings) == 1


def test_baseline_round_trip(tmp_path):
    report = _lint(SRC)
    assert report.exit_code == 1
    path = str(tmp_path / "baseline.json")
    lint_core.write_baseline(path, report.findings)
    again = _lint(SRC, baseline=lint_core.load_baseline(path))
    assert again.exit_code == 0 and len(again.baselined) == 1 and again.findings == []
    # the reference reads the port's baseline file the same way
    assert set(ref_core.load_baseline(path)) == set(lint_core.load_baseline(path))


def test_baseline_key_survives_line_drift_and_equals_the_references():
    report = _lint(SRC)
    drifted = _lint("import os\n\n\n" + SRC.replace("import time\n", "import time  # moved\n"))
    assert report.findings[0].key() == drifted.findings[0].key()
    assert report.findings[0].line != drifted.findings[0].line
    ref = ref_core.lint_sources({PATH: SRC}, rule_names=["monotonic-durations"])
    assert ref.findings[0].key() == report.findings[0].key()


def test_missing_baseline_reads_empty(tmp_path):
    assert lint_core.load_baseline(str(tmp_path / "nope.json")) == {}


def test_malformed_baseline_entry_raises_value_error(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"version": 1, "findings": [{"rule": "x"}]}))
    with pytest.raises(ValueError, match="key"):
        lint_core.load_baseline(str(p))


def test_nonexistent_lint_target_is_an_error(tmp_path):
    with pytest.raises(ValueError, match="matched no python files"):
        lint_core.run_lint(str(tmp_path), paths=["no/such/dir"])


def test_write_baseline_is_idempotent_over_grandfathered(tmp_path):
    path = str(tmp_path / "baseline.json")
    lint_core.write_baseline(path, _lint(SRC).findings)
    n1 = len(lint_core.load_baseline(path))
    lint_core.write_baseline(path, _lint(SRC, baseline=None).findings)
    assert len(lint_core.load_baseline(path)) == n1 == 1


def test_json_report_schema_is_the_references():
    report = lint_core.lint_sources({PATH: SRC})
    doc = json.loads(json.dumps(report.to_json()))
    ref = ref_core.lint_sources({"ccfd_tpu/x.py": SRC}).to_json()
    assert doc["version"] == lint_core.LINT_SCHEMA_VERSION == ref["version"]
    assert doc["tool"] == "ccfd-lint" and isinstance(doc["files_scanned"], int)
    assert {r["name"] for r in doc["rules"]} == {r["name"] for r in ref["rules"]} == {
        "durability-seam", "monotonic-durations", "counted-drops", "metric-naming",
        "breaker-outcome", "hot-path-sync", "lock-order"}
    for r in doc["rules"]:
        assert r["invariant"] and r["motivated_by"]
    for f in doc["findings"]:
        assert set(f) == {"rule", "path", "line", "col", "message", "snippet", "key"}
    assert set(doc["counts"]) == {"active", "suppressed", "baselined"} == set(ref["counts"])
    assert doc["exit"] == ref["exit"] == 1
    assert set(doc) == set(ref)


def test_the_ports_tree_is_lint_clean_against_its_own_empty_baseline():
    """The merge bar: ``ccfd_tpu_torch`` lints clean with its own EMPTY
    baseline (every grandfathered site is a justified inline pragma)."""
    assert lint_core.DEFAULT_BASELINE == str(
        REPO / "ccfd_tpu_torch" / "assets" / "lint_baseline.json")
    assert lint_core.load_baseline(lint_core.DEFAULT_BASELINE) == {}
    report = lint_core.run_lint(str(REPO))
    assert report.files_scanned > 100
    assert {f.path.split("/")[0] for f in report.suppressed} == {"ccfd_tpu_torch"}
    assert report.parse_errors == []
    assert report.findings == [], "\n".join(report.human_lines())


def test_the_lint_command_exits_as_the_references(tmp_path, capsys):
    from ccfd_tpu_torch.cli import main

    assert main(["lint"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert main(["lint", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["exit"] == 0
    bad = tmp_path / "ccfd_tpu_torch"
    bad.mkdir()
    (bad / "m.py").write_text(SRC)
    assert main(["lint", "--root", str(tmp_path), "--baseline",
                 str(tmp_path / "b.json")]) == 1
    assert main(["lint", "--rules", "nope"]) == 2
    assert main(["lint", "--write-baseline", "--rules", "lock-order"]) == 2
    assert main(["lint", "--root", str(tmp_path), "--baseline", str(tmp_path / "b.json"),
                 "--write-baseline"]) == 0
    assert main(["lint", "--root", str(tmp_path), "--baseline",
                 str(tmp_path / "b.json")]) == 0
    assert os.path.exists(tmp_path / "b.json")


# -- the runtime lock-order sanitizer ------------------------------------------


class TestLockcheckRuntime:
    def test_deliberate_inversion_raises(self):
        g = lockcheck.LockGraph(raise_on_cycle=True)
        a = g.wrap(lockcheck.raw_lock(), "a")
        b = g.wrap(lockcheck.raw_lock(), "b")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(lockcheck.LockOrderError):
                a.acquire()
            assert not a.locked()  # never left held behind the raise
        assert len(g.violations) == 1
        assert set(g.violations[0]["cycle"][:2]) <= {"a", "b"}
        with b:  # not one-shot: the repeat re-detects
            with pytest.raises(lockcheck.LockOrderError):
                a.acquire()
        assert len(g.violations) == 2

    def test_consistent_order_and_reentrancy_silent(self):
        g = lockcheck.LockGraph(raise_on_cycle=True)
        a = g.wrap(lockcheck.raw_lock(), "a")
        b = g.wrap(lockcheck.raw_lock(), "b")
        r = g.wrap(lockcheck.raw_rlock(), "r")
        for _ in range(3):
            with a:
                with b:
                    pass
        with r:
            with r:
                with a:
                    pass
        assert g.violations == []

    def test_inversion_across_threads_detected(self):
        g = lockcheck.LockGraph(raise_on_cycle=False)
        a = g.wrap(lockcheck.raw_lock(), "a")
        b = g.wrap(lockcheck.raw_lock(), "b")

        def t1():
            with a:
                with b:
                    pass

        th = threading.Thread(target=t1)
        th.start()
        th.join()
        with b:
            with a:  # opposite order, never concurrent: still flagged
                pass
        assert len(g.violations) == 1

    def test_condition_wait_keeps_bookkeeping_consistent(self):
        g = lockcheck.LockGraph(raise_on_cycle=True)
        cond = threading.Condition(g.wrap(lockcheck.raw_lock(), "cond-lock"))
        hit = []

        def waiter():
            with cond:
                cond.wait(timeout=5)
                hit.append(True)

        th = threading.Thread(target=waiter)
        th.start()
        for _ in range(100):
            with cond:
                cond.notify_all()
            if hit:
                break
            threading.Event().wait(0.01)
        th.join(timeout=5)
        assert hit and g.violations == []

    def test_install_uninstall_round_trip_scoped_to_the_port(self, monkeypatch):
        """Armed by CCFD_LOCKCHECK=1 (as the reference's); locks built from
        ``ccfd_tpu_torch/`` are checked, others get a real lock."""
        if lockcheck.installed():
            pytest.skip("globally armed: the global graph must not be torn down")
        monkeypatch.setenv("CCFD_LOCKCHECK", "1")
        assert lockcheck.armed_from_env()
        lockcheck.install()
        try:
            assert lockcheck.installed()
            assert not isinstance(threading.Lock(), lockcheck._CheckedLock)  # from tests/
            from ccfd_tpu_torch.metrics.prom import Registry

            reg = Registry()
            c = reg.counter("x_total", "x")
            c.inc()
            assert lockcheck.violations() == []
        finally:
            lockcheck.uninstall()
        assert not lockcheck.installed() and threading.Lock is lockcheck._REAL_LOCK
        monkeypatch.delenv("CCFD_LOCKCHECK")
        assert not lockcheck.armed_from_env()
