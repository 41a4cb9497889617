"""The port's test files leave no process-wide state behind.

A platform with tracing on calls ``slog.configure``, which stops the
``ccfd_tpu_torch`` logger's propagation, and a platform with the incident
plane on installs the storage quarantine's recorder hook
(``durability.set_recorder``). Under ``pytest -n N --dist loadfile`` a later
file in the same worker then sees no warnings in ``caplog`` and a recorder
of a torn-down platform. ``tests/torch_helpers.py::keep_port_logging``
restores both; every file that brings a platform up (``Platform(...)``,
the ``up`` command, or ``replay --live``, whose minimal platform is one)
must carry it as an autouse fixture. Read by AST, so a new file is held
to it the day it is added.
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
    return out


def _builds_platform(tree: ast.AST) -> list[str]:
    what = sorted(_argv_commands(tree))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
            if name == "Platform":
                what.append("Platform(")
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
])
def test_the_scan_names_what_raises_a_platform(src, expect):
    assert _builds_platform(ast.parse(src)) == expect


def test_the_guard_is_recognised_only_when_autouse():
    on = ast.parse("_k = pytest.fixture(autouse=True)(torch_helpers.keep_port_logging)")
    off = ast.parse("_k = pytest.fixture()(torch_helpers.keep_port_logging)")
    other = ast.parse("_k = pytest.fixture(autouse=True)(torch_helpers.mlp_tree)")
    assert _has_guard(on) and not _has_guard(off) and not _has_guard(other)


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
