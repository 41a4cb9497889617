"""ccfd-lint engine: rule registry, pragmas, baseline, reports.

The port's copy of ccfd_tpu/analysis/core.py. Dependency-free (stdlib
``ast`` only): the lint gate runs before anything else and must not pay for,
or wedge on, accelerator imports. Rules are small classes registered by
name; each one encodes a single named invariant (see rules.py).

Suppression contract (mirrors the noqa idiom already in the tree):

    x = risky()  # ccfd-lint: disable=<rule>[,<rule>] -- justification

applies to that physical line; a pragma comment alone on a line applies
to the next line (for calls whose expression spans lines, put the pragma
on the line the call STARTS on). ``disable-file=<rule>`` anywhere in the
file suppresses the rule for the whole file. The ``-- justification``
text is part of the contract: a suppression without one is itself a
finding (``bare-pragma``), so every grandfathered site explains itself
in place.

The baseline file (the port's own, ``ccfd_tpu_torch/assets/lint_baseline.json``)
grandfathers findings by content-stable key (rule + path + normalized
source line) so line drift doesn't churn it. The merge bar is an EMPTY
baseline: fixes and justified inline pragmas are the steady state; the
baseline exists for incremental adoption and for the round-trip test.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Any, Callable, Iterable, Mapping

LINT_SCHEMA_VERSION = 1
# the package linted by default, and its baseline
DEFAULT_TARGET = "ccfd_tpu_torch"
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "assets", "lint_baseline.json")

_PRAGMA_RE = re.compile(
    r"#\s*ccfd-lint:\s*(disable(?:-file)?)=([\w,\-]+)(?:\s+--\s*(\S.*))?"
)
_HOT_PATH_RE = re.compile(r"#\s*ccfd-lint:\s*hot-path\b")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int  # 1-based
    col: int  # 0-based
    message: str
    snippet: str = ""

    def key(self) -> str:
        """Content-stable baseline identity: rule + path + the flagged
        source line with whitespace normalized (line NUMBERS drift with
        every edit above the site; the line's content does not)."""
        norm = " ".join(self.snippet.split())
        h = hashlib.sha256(norm.encode()).hexdigest()[:16]
        return f"{self.rule}:{self.path}:{h}"

    def to_dict(self) -> dict[str, Any]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
            "key": self.key(),
        }


class FileContext:
    """Parsed view of one source file handed to every rule: AST, raw
    lines, pragma maps. Built from (path, source) so tests lint virtual
    snippets without touching disk."""

    def __init__(self, path: str, source: str):
        self.path = path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> set of rule names disabled on that line
        self.disabled: dict[int, set[str]] = {}
        self.disabled_file: set[str] = set()
        # lines carrying a pragma with NO justification text
        self.bare_pragma_lines: list[int] = []
        self.hot_path_lines: set[int] = set()
        self._scan_pragmas()

    def _scan_pragmas(self) -> None:
        # tokenize, not a raw line scan: pragma-shaped text inside a
        # STRING literal (help text, a docstring documenting the syntax)
        # must never act as a live suppression
        import io
        import tokenize

        comments: list[tuple[int, int, str]] = []
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.source).readline):
                if tok.type == tokenize.COMMENT:
                    comments.append((tok.start[0], tok.start[1], tok.string))
        except (tokenize.TokenError, IndentationError):  # pragma: no cover
            return  # token-broken source; ast.parse already vets files
        for i, col, text in comments:
            if _HOT_PATH_RE.search(text):
                self.hot_path_lines.add(i)
            m = _PRAGMA_RE.search(text)
            if not m:
                continue
            kind, rules_csv, justification = m.groups()
            rules = {r.strip() for r in rules_csv.split(",") if r.strip()}
            if not justification:
                self.bare_pragma_lines.append(i)
            if kind == "disable-file":
                self.disabled_file |= rules
                continue
            # a pragma applies to its own line, and — when the line is
            # pure comment — to the following line as well
            self.disabled.setdefault(i, set()).update(rules)
            if i - 1 < len(self.lines) and not self.lines[i - 1][:col].strip():
                self.disabled.setdefault(i + 1, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.disabled_file:
            return True
        return rule in self.disabled.get(line, set())

    def snippet_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=rule, path=self.path, line=line, col=col,
                       message=message, snippet=self.snippet_at(line))


class Rule:
    """Base rule. ``scope`` is ``"file"`` (checked per FileContext) or
    ``"project"`` (handed every FileContext at once — the lock-order
    graph needs the whole tree)."""

    name = ""
    invariant = ""  # one-line statement of the invariant this encodes
    motivated_by = ""  # the review finding that motivated it
    scope = "file"

    def check(self, ctx: FileContext) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError

    def check_project(
        self, ctxs: list[FileContext]
    ) -> Iterable[Finding]:  # pragma: no cover - project rules override
        raise NotImplementedError


_REGISTRY: dict[str, type[Rule]] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator: add a rule to the global registry by name."""
    if not cls.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def registered_rules() -> dict[str, type[Rule]]:
    # rules.py registers on import; import lazily so core stays cycle-free
    from ccfd_tpu_torch.analysis import rules as _rules  # noqa: F401

    return dict(_REGISTRY)


# -- baseline ----------------------------------------------------------------


def load_baseline(path: str | None) -> dict[str, dict[str, Any]]:
    """Baseline file -> {finding key: entry}. Missing file reads as an
    empty baseline; a malformed one raises (a silently-ignored baseline
    would un-grandfather everything and fail the gate confusingly)."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != LINT_SCHEMA_VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version {doc.get('version')!r}")
    out: dict[str, dict[str, Any]] = {}
    for entry in doc.get("findings", []):
        key = entry.get("key") if isinstance(entry, dict) else None
        if not key:
            # ValueError, not KeyError: the CLI's malformed-baseline
            # handler prints a one-line diagnosis and exits 2
            raise ValueError(
                f"baseline {path}: entry without a 'key' field: {entry!r}")
        out[key] = entry
    return out


def write_baseline(path: str, findings: list[Finding]) -> dict[str, Any]:
    doc = {
        "version": LINT_SCHEMA_VERSION,
        "comment": (
            "grandfathered ccfd-lint findings; every entry needs a "
            "justification or a fix — the steady state is an empty list"
        ),
        "findings": [
            {**f.to_dict(), "justification": ""} for f in findings
        ],
    }
    with open(path, "w") as f:  # ccfd-lint: disable=durability-seam -- dev-tool output, reviewed and checked in like source, not a runtime artifact
        f.write(json.dumps(doc, indent=1, sort_keys=True))
        f.write("\n")
    return doc


# -- runner ------------------------------------------------------------------


@dataclasses.dataclass
class LintReport:
    findings: list[Finding]  # active (unsuppressed, unbaselined)
    suppressed: list[Finding]
    baselined: list[Finding]
    files_scanned: int
    parse_errors: list[str]

    @property
    def exit_code(self) -> int:
        return 1 if (self.findings or self.parse_errors) else 0

    def to_json(self) -> dict[str, Any]:
        """Strict-JSON report (schema asserted by tests/test_torch_lint.py)."""
        rules = registered_rules()
        return {
            "version": LINT_SCHEMA_VERSION,
            "tool": "ccfd-lint",
            "files_scanned": self.files_scanned,
            "rules": [
                {
                    "name": name,
                    "invariant": cls.invariant,
                    "motivated_by": cls.motivated_by,
                }
                for name, cls in sorted(rules.items())
            ],
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "baselined": [f.to_dict() for f in self.baselined],
            "parse_errors": list(self.parse_errors),
            "counts": {
                "active": len(self.findings),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
            },
            "exit": self.exit_code,
        }

    def human_lines(self) -> list[str]:
        out = [
            f"{f.path}:{f.line}:{f.col}: [{f.rule}] {f.message}"
            for f in self.findings
        ]
        out.extend(f"parse error: {e}" for e in self.parse_errors)
        tail = (
            f"ccfd-lint: {len(self.findings)} finding(s), "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.baselined)} baselined, "
            f"{self.files_scanned} file(s)"
        )
        out.append(tail)
        return out


def iter_py_files(root: str, paths: Iterable[str] | None = None) -> list[str]:
    """Source files to lint, repo-relative. Default scope is the
    ``ccfd_tpu_torch`` package: tools/ and tests/ have different
    conventions (they write interchange JSON everywhere, by design)."""
    rels: list[str] = []
    targets = list(paths) if paths else [DEFAULT_TARGET]
    for target in targets:
        full = os.path.join(root, target)
        found: list[str] = []
        if os.path.isfile(full) and full.endswith(".py"):
            found.append(os.path.relpath(full, root))
        else:
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        found.append(
                            os.path.relpath(os.path.join(dirpath, fn), root))
        if not found:
            # a typo'd target must FAIL the gate, not scan zero files and
            # report a clean tree — the silent-cap failure mode this tool
            # exists to refuse
            raise ValueError(
                f"lint target {target!r} matched no python files under "
                f"{root}")
        rels.extend(found)
    return sorted(set(r.replace(os.sep, "/") for r in rels))


def _check_bare_pragmas(ctx: FileContext) -> list[Finding]:
    """A suppression without a justification is itself a finding: the
    pragma contract is that every grandfathered site explains itself."""
    out = []
    for line in ctx.bare_pragma_lines:
        out.append(Finding(
            rule="bare-pragma", path=ctx.path, line=line, col=0,
            message=("suppression pragma without a justification; write "
                     "`# ccfd-lint: disable=<rule> -- <why>`"),
            snippet=ctx.snippet_at(line)))
    return out


def lint_sources(
    sources: Mapping[str, str],
    rule_names: Iterable[str] | None = None,
    baseline: Mapping[str, Any] | None = None,
) -> LintReport:
    """Lint in-memory {path: source} — the engine under both the CLI and
    the unit-test fixtures."""
    rules = registered_rules()
    if rule_names is not None:
        unknown = set(rule_names) - set(rules)
        if unknown:
            raise ValueError(f"unknown rule(s): {sorted(unknown)}")
        rules = {n: rules[n] for n in rule_names}
    baseline = baseline or {}

    ctxs: list[FileContext] = []
    parse_errors: list[str] = []
    for path, source in sorted(sources.items()):
        try:
            ctxs.append(FileContext(path, source))
        except SyntaxError as e:
            parse_errors.append(f"{path}: {e.msg} (line {e.lineno})")

    raw: list[Finding] = []
    for name, cls in sorted(rules.items()):
        rule = cls()
        if rule.scope == "project":
            raw.extend(rule.check_project(ctxs))
        else:
            for ctx in ctxs:
                raw.extend(rule.check(ctx))
    for ctx in ctxs:
        raw.extend(_check_bare_pragmas(ctx))

    by_path = {c.path: c for c in ctxs}
    active: list[Finding] = []
    suppressed: list[Finding] = []
    baselined: list[Finding] = []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        ctx = by_path.get(f.path)
        if ctx is not None and ctx.suppressed(f.rule, f.line):
            suppressed.append(f)
        elif f.key() in baseline:
            baselined.append(f)
        else:
            active.append(f)
    return LintReport(findings=active, suppressed=suppressed,
                      baselined=baselined, files_scanned=len(ctxs),
                      parse_errors=parse_errors)


def run_lint(
    root: str,
    paths: Iterable[str] | None = None,
    baseline_path: str | None = None,
    rule_names: Iterable[str] | None = None,
    read: Callable[[str], str] | None = None,
) -> LintReport:
    """Lint files under ``root`` (repo top). ``read`` is injectable for
    tests; defaults to the filesystem."""
    files = iter_py_files(root, paths)
    if read is None:
        def read(rel: str) -> str:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                return f.read()
    sources = {rel: read(rel) for rel in files}
    return lint_sources(sources, rule_names=rule_names,
                        baseline=load_baseline(baseline_path))
