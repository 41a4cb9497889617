"""The port's test files leave no process-wide state behind.

A platform with tracing on calls ``slog.configure``, which stops the
``ccfd_tpu_torch`` logger's propagation, and a platform with the incident
plane on installs the storage quarantine's recorder hook
(``durability.set_recorder``). Under ``pytest -n N --dist loadfile`` a later
file in the same worker then sees no warnings in ``caplog`` and a recorder
of a torn-down platform. ``tests/torch_helpers.py::keep_port_logging``
restores both; every file that brings a platform up (``Platform(...)``,
the ``up`` command, ``replay --live``, whose minimal platform is one, or a
fleet member: ``FleetMember(...)`` or the ``fleet member`` command) must
carry it as an autouse fixture. A fixture scoped wider than a function
runs before that guard saves anything, so one that brings a platform up
wraps it in ``torch_helpers.port_process_state`` itself. Read by AST, so a
new file is held to it the day it is added.
"""

from __future__ import annotations

import ast
import logging
from pathlib import Path

import pytest

from tests import torch_helpers

TESTS = Path(__file__).resolve().parent


def _argv_commands(tree: ast.AST) -> set[str]:
    """The platform-raising commands named in list or tuple literals."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.List, ast.Tuple)):
            words = [e.value for e in node.elts
                     if isinstance(e, ast.Constant) and isinstance(e.value, str)]
            if "up" in words:
                out.add("up")
            if "replay" in words and "--live" in words:
                out.add("replay --live")
            if "fleet" in words and "member" in words:
                out.add("fleet member")
    return out


def _builds_platform(tree: ast.AST) -> list[str]:
    what = sorted(_argv_commands(tree))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
            if name in ("Platform", "FleetMember"):
                what.append(f"{name}(")
                break
    return what


def _has_guard(tree: ast.Module) -> bool:
    """A module-level ``pytest.fixture(autouse=True)(...keep_port_logging)``."""
    for node in tree.body:
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        outer = node.value
        inner = outer.func
        if not (isinstance(inner, ast.Call) and getattr(inner.func, "attr", None) == "fixture"):
            continue
        autouse = any(k.arg == "autouse" and isinstance(k.value, ast.Constant)
                      and k.value.value is True for k in inner.keywords)
        named = any(getattr(a, "attr", getattr(a, "id", None)) == "keep_port_logging"
                    for a in outer.args)
        if autouse and named:
            return True
    return False


def _port_test_files() -> list[Path]:
    """Every port test file but this one, whose own cases quote argv."""
    return sorted(p for p in TESTS.glob("test_torch_*.py") if p.name != Path(__file__).name)


def test_every_file_that_brings_a_platform_up_restores_the_process_state():
    files = _port_test_files()
    assert len(files) > 40
    raisers = {}
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        what = _builds_platform(tree)
        if what:
            raisers[path.name] = (what, _has_guard(tree))
    # the files known to raise platforms are seen as such
    for name in ("test_torch_platform.py", "test_torch_analytics.py",
                 "test_torch_lifecycle.py", "test_torch_replay.py"):
        assert name in raisers, name
    missing = {name: what for name, (what, guarded) in raisers.items() if not guarded}
    assert missing == {}, missing


@pytest.mark.parametrize("src,expect", [
    ("p = Platform(spec, device='cpu')", ["Platform("]),
    ("rc = cli.main(['up', '-f', cr])", ["up"]),
    ("rc = cli.main(('replay', '--dir', d, '--live'))", ["replay --live"]),
    ("rc = cli.main(['replay', '--dir', d])", []),
    ("x = ['upper', 'down']", []),
    ("m = FleetMember('a', Registry())", ["FleetMember("]),
    ("argv = [py, '-m', 'ccfd_tpu_torch', 'fleet', 'member', '--spec', s]",
     ["fleet member"]),
])
def test_the_scan_names_what_raises_a_platform(src, expect):
    assert _builds_platform(ast.parse(src)) == expect


def test_the_guard_is_recognised_only_when_autouse():
    on = ast.parse("_k = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)")
    off = ast.parse("_k = pytest.fixture()(torch_helpers.keep_port_logging)")
    other = ast.parse("_k = pytest.fixture(autouse=True)(torch_helpers.mlp_tree)")
    assert _has_guard(on) and not _has_guard(off) and not _has_guard(other)


def _wide_fixtures_without_guard(tree: ast.Module) -> list[str]:
    """Fixtures scoped wider than a function that bring a platform up
    outside ``port_process_state``: they run before the autouse guard saves
    anything, so the guard would restore the state they left."""
    out = []
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        wide = any(isinstance(d, ast.Call) and getattr(d.func, "attr", None) == "fixture"
                   and any(k.arg == "scope" and isinstance(k.value, ast.Constant)
                           and k.value.value != "function" for k in d.keywords)
                   for d in node.decorator_list)
        guarded = any(getattr(n, "attr", getattr(n, "id", None)) == "port_process_state"
                      for n in ast.walk(node))
        if wide and _builds_platform(node) and not guarded:
            out.append(node.name)
    return out


def test_no_wide_fixture_brings_a_platform_up_unguarded():
    missing = {}
    for path in _port_test_files():
        names = _wide_fixtures_without_guard(ast.parse(path.read_text(), filename=str(path)))
        if names:
            missing[path.name] = names
    assert missing == {}, missing


@pytest.mark.parametrize("src,expect", [
    ("@pytest.fixture(scope='module')\ndef f():\n    Platform(s).up()", ["f"]),
    ("@pytest.fixture(scope='module')\ndef f():\n"
     "    with torch_helpers.port_process_state():\n        Platform(s).up()", []),
    ("@pytest.fixture\ndef f():\n    Platform(s).up()", []),
    ("@pytest.fixture(scope='module')\ndef f():\n    return 1", []),
])
def test_the_wide_fixture_scan(src, expect):
    assert _wide_fixtures_without_guard(ast.parse(src)) == expect


def test_the_helper_restores_the_logger_and_the_recorder_hook():
    from ccfd_tpu_torch.observability import slog
    from ccfd_tpu_torch.runtime import durability

    log = logging.getLogger("ccfd_tpu_torch")
    before = (list(log.handlers), log.level, log.propagate, durability._recorder)
    gen = torch_helpers.keep_port_logging()
    next(gen)
    slog.configure("hygiene")
    durability.set_recorder(lambda trigger: None)
    assert log.propagate is False and durability._recorder is not None
    with pytest.raises(StopIteration):
        next(gen)
    assert (list(log.handlers), log.level, log.propagate, durability._recorder) == before
