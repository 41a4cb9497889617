"""DMN-style decision tables.

The port's copy of ccfd_tpu/process/dmn.py. The fraud process evaluates a
DMN decision after the no-reply timer: low amount + low fraud probability
-> auto-approve, otherwise open an investigation user task. A small
first-match-wins decision table: rules are (condition-map, output),
conditions are per-input predicates built from compact specs like
``("<", 200.0)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

_OPS: dict[str, Callable[[Any, Any], bool]] = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
    "in": lambda v, t: v in t,
    "between": lambda v, t: t[0] <= v <= t[1],
}

Test = tuple[str, Any] | Callable[[Any], bool]


def _check(test: Test, value: Any) -> bool:
    if callable(test):
        return bool(test(value))
    op, operand = test
    return _OPS[op](value, operand)


@dataclass(frozen=True)
class Rule:
    when: Mapping[str, Test]  # input name -> unary test (all must hold)
    then: Any

    def matches(self, inputs: Mapping[str, Any]) -> bool:
        return all(_check(t, inputs[name]) for name, t in self.when.items())


@dataclass(frozen=True)
class DecisionTable:
    """First-match-wins (DMN hit policy FIRST) with an optional default."""

    name: str
    rules: Sequence[Rule]
    default: Any = None

    def evaluate(self, inputs: Mapping[str, Any]) -> Any:
        for rule in self.rules:
            if rule.matches(inputs):
                return rule.then
        return self.default
