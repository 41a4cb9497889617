"""Declarative decision rules: the reference's Drools rule base, batch-vectorized.

The port's copy of ccfd_tpu/router/rules.py (numpy only). A rule base is a
vectorized classifier over the micro-batch: every rule's LHS (a conjunction
of comparisons over the 30 transaction features and the model probability)
evaluates as one boolean mask over the whole (B,) batch; salience order +
first-match-wins assigns each row its action (the process to start).

Rule bases load from JSON (``CCFD_RULES``). ``default_rules()`` is the
reference's semantics: ``proba >= FRAUD_THRESHOLD -> fraud, else standard``.
``when_fn`` rules (code, programmatic only) cannot compile to the decision
plane's tensors (ops/fused_decision.py): a set holding one serves staged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES

PROBA_FIELD = "proba"
_OP_FUNCS = {
    ">": np.greater,
    ">=": np.greater_equal,
    "<": np.less,
    "<=": np.less_equal,
    "==": np.equal,
    "!=": np.not_equal,
}
_OPS = (*_OP_FUNCS, "between")


@dataclass(frozen=True)
class Condition:
    """One comparison: ``field op value`` over a feature column or ``proba``."""

    fld: str
    op: str
    value: Any

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}; known: {_OPS}")
        if self.fld != PROBA_FIELD and self.fld not in FEATURE_NAMES:
            raise ValueError(
                f"unknown field {self.fld!r}; expected {PROBA_FIELD!r} or a "
                f"feature name"
            )
        if self.op == "between":
            if (
                isinstance(self.value, (str, bytes))
                or not isinstance(self.value, Sequence)
                or len(self.value) != 2
                or any(isinstance(v, (str, bytes)) for v in self.value)
            ):
                raise ValueError("'between' needs value [lo, hi] (numeric)")
            for v in self.value:
                float(v)
        elif isinstance(self.value, (str, bytes)):
            raise ValueError(f"non-numeric value {self.value!r}")
        else:
            float(self.value)  # must be numeric

    def mask(self, x: np.ndarray, proba: np.ndarray) -> np.ndarray:
        col = (
            proba
            if self.fld == PROBA_FIELD
            else x[:, FEATURE_NAMES.index(self.fld)]
        )
        if self.op == "between":
            lo, hi = (col.dtype.type(v) for v in self.value)
            return (col >= lo) & (col <= hi)
        # cast the operand to the column dtype: comparing a float32 column
        # against a float64 literal would make ==/!= on non-dyadic values
        # (0.1, ...) silently never/always match
        v = col.dtype.type(self.value)
        return _OP_FUNCS[self.op](col, v)


@dataclass(frozen=True)
class Rule:
    """LHS = conjunction of conditions; RHS = start ``process`` with vars.

    ``when_fn`` (programmatic rule bases only — JSON cannot carry code):
    an arbitrary ``(x, proba) -> (B,) bool`` predicate AND-ed with the
    declarative conditions. The escape hatch for policies the Condition
    grammar cannot express — but it is host-only: a rule base with ANY
    ``when_fn`` cannot compile to the fused decision kernel's predicate
    tensors, and the whole set serves the staged path with one loud
    warning (ops/fused_decision.py compile_rules). Never a per-row split.
    """

    name: str
    process: str
    when: tuple[Condition, ...] = ()
    salience: int = 0
    set_vars: Mapping[str, Any] = field(default_factory=dict)
    when_fn: Any = None

    def __post_init__(self):
        if self.when_fn is not None and not callable(self.when_fn):
            raise ValueError(
                f"rule {self.name!r}: when_fn must be callable "
                f"(x, proba) -> bool mask, got {type(self.when_fn).__name__}"
            )

    def mask(self, x: np.ndarray, proba: np.ndarray) -> np.ndarray:
        m = np.ones(proba.shape[0], bool)
        for c in self.when:
            m &= c.mask(x, proba)
        if self.when_fn is not None:
            m &= np.asarray(self.when_fn(x, proba), bool)
        return m


class RuleSet:
    """Salience-ordered, first-match-wins rule base over a scored batch."""

    def __init__(self, rules: Sequence[Rule]):
        if not rules:
            raise ValueError("empty rule base")
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        # stable sort: equal salience keeps authoring order, like Drools
        self.rules: tuple[Rule, ...] = tuple(
            sorted(rules, key=lambda r: -r.salience)
        )
        if not any(not r.when for r in self.rules):
            raise ValueError(
                "no default rule (empty 'when'): some rows would match nothing"
            )

    def evaluate(self, x: np.ndarray, proba: np.ndarray) -> np.ndarray:
        """(B,30) features + (B,) probabilities -> (B,) rule indices.

        One boolean-mask pass per rule over the whole batch; a row takes the
        highest-salience rule whose conjunction holds.
        """
        proba = np.asarray(proba)
        assigned = np.full(proba.shape[0], -1, np.int64)
        for i, rule in enumerate(self.rules):
            m = rule.mask(x, proba) & (assigned < 0)
            assigned[m] = i
        return assigned  # always >=0: a default rule matches everything

    # -- serialization -----------------------------------------------------

    @staticmethod
    def from_obj(obj: Sequence[Mapping[str, Any]]) -> "RuleSet":
        rules = []
        for r in obj:
            rules.append(
                Rule(
                    name=str(r["name"]),
                    process=str(r["process"]),
                    when=tuple(
                        Condition(str(c["field"]), str(c["op"]), c["value"])
                        for c in r.get("when", ())
                    ),
                    salience=int(r.get("salience", 0)),
                    set_vars=dict(r.get("set_vars", {})),
                )
            )
        return RuleSet(rules)

    @staticmethod
    def from_file(path: str) -> "RuleSet":
        with open(path) as f:
            return RuleSet.from_obj(json.load(f))


def default_rules(fraud_threshold: float) -> RuleSet:
    """The reference's embedded Drools base (router.yaml:69-70): probability
    at or above FRAUD_THRESHOLD starts the fraud process, otherwise the
    standard process."""
    return RuleSet(
        [
            Rule(
                "fraud",
                process="fraud",
                when=(Condition(PROBA_FIELD, ">=", fraud_threshold),),
                salience=10,
            ),
            Rule("standard", process="standard"),
        ]
    )
