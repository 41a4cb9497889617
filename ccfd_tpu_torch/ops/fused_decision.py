"""Decision program: score + threshold + rules in one device pass.

The port of ccfd_tpu/ops/fused_decision.py. The staged serving path
dispatches the model, copies (B,) probabilities back, then walks the rule
base in numpy (``RuleSet.evaluate``). Here the rule base itself compiles
into tensors, and the decision program takes the staged feature rows on
the device and returns routed verdicts: ``(proba, fired_rule_index)``
packed as one (B, 2) float32 tensor, so one device-to-host copy carries the
whole verdict.

Compilation (``compile_rules``, numpy, arrays bit-equal to the
reference's): every vectorizable ``Condition`` (``>/>=/</<=/==/!=/between``
over the 30 features or ``proba``) becomes one slot of a stacked predicate
tensor: an operand column index ``idx (R, C)``, an op code ``op (R, C)``
and bounds ``lo/hi (R, C)``. ``eval_plan`` evaluates it with torch ops on
the rows' device: one gather, an op-coded compare, an AND-reduce over each
rule's conjunction, and first-match-wins by ``argmax`` over the
salience-ordered match matrix cast to int32 (CUDA's ``argmax`` does not
take ``bool``; ``argmax`` returns the first maximal index). It is
``RuleSet.evaluate``'s first-match semantics bit for bit, because

- rules stay in ``RuleSet.rules`` order (salience-sorted, stable);
- every bound is pre-cast with ``np.float32``, the cast ``Condition.mask``
  applies, and lives in a float32 tensor: float32 is compared with float32,
  never with a Python float (which torch would compare in double);
- the gather moves values verbatim.

Rules with a custom ``when_fn`` cannot compile: ``compile_rules`` raises
``UnvectorizableRuleSet`` and the caller serves the whole set staged
(serving/fused.py). This is XLA in the reference, not Pallas, so it is
torch code here; it gets no hand-written kernel unless a measurement on the
card asks for one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES
from ccfd_tpu_torch.router.rules import PROBA_FIELD, RuleSet

# op codes for the stacked predicate tensor; OP_TRUE pads rules with fewer
# conditions than the widest one (and the default rule's empty conjunction)
OP_GT, OP_GE, OP_LT, OP_LE, OP_EQ, OP_NE, OP_BETWEEN, OP_TRUE = range(8)
_OP_CODES = {">": OP_GT, ">=": OP_GE, "<": OP_LT, "<=": OP_LE,
             "==": OP_EQ, "!=": OP_NE, "between": OP_BETWEEN}


class UnvectorizableRuleSet(ValueError):
    """The rule base holds a predicate that cannot compile to the stacked
    tensor form (a custom ``when_fn`` callable). The whole set must serve
    staged: semantics may not split within a batch."""


@dataclass(frozen=True, eq=False)
class RulePlan:
    """A RuleSet compiled to stacked predicate tensors (numpy).

    ``sel``  (R, C, F+1) float32 one-hot column selector (slot F = proba)
    ``idx``  (R, C) int32 operand column index (= argmax of ``sel``)
    ``op``   (R, C) int32 op codes (OP_TRUE = padding / empty conjunction)
    ``lo``   (R, C) float32 lower/scalar bound, pre-cast like the host path
    ``hi``   (R, C) float32 upper bound (``between`` only; else == lo)
    ``processes`` / ``names``: per-rule RHS bookkeeping
    ``needs_features``: some condition reads a feature column, so the
    decision dispatch must carry the float32 rows
    """

    sel: np.ndarray
    idx: np.ndarray
    op: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    processes: tuple[str, ...]
    names: tuple[str, ...]
    needs_features: bool
    rules: Any  # the source RuleSet: identity-checked at the route seam

    @property
    def n_rules(self) -> int:
        return self.sel.shape[0]

    def tensors(self, device: "str | torch.device") -> dict[str, torch.Tensor]:
        """``idx`` (int64), ``op`` (int32), ``lo`` and ``hi`` (float32) on
        ``device``, each (1, R, C) to broadcast over the batch."""
        return {
            "idx": torch.from_numpy(self.idx.astype(np.int64)).to(device)[None],
            "op": torch.from_numpy(self.op).to(device)[None],
            "lo": torch.from_numpy(self.lo).to(device)[None],
            "hi": torch.from_numpy(self.hi).to(device)[None],
        }


def compile_rules(rules: RuleSet,
                  feature_names: Sequence[str] = FEATURE_NAMES) -> RulePlan:
    """RuleSet -> RulePlan, or raise :class:`UnvectorizableRuleSet`: one
    rule that cannot compile forces the staged path for the whole set,
    decided at compile time."""
    n_feat = len(feature_names)
    for r in rules.rules:
        if getattr(r, "when_fn", None) is not None:
            raise UnvectorizableRuleSet(
                f"rule {r.name!r} carries a custom when_fn callable; "
                f"callables cannot compile to the stacked predicate "
                f"tensor — the whole rule set serves staged")
    n_rules = len(rules.rules)
    width = max(1, max(len(r.when) for r in rules.rules))
    sel = np.zeros((n_rules, width, n_feat + 1), np.float32)
    idx = np.zeros((n_rules, width), np.int32)  # padding gathers col 0;
    op = np.full((n_rules, width), OP_TRUE, np.int32)  # OP_TRUE masks it
    lo = np.zeros((n_rules, width), np.float32)
    hi = np.zeros((n_rules, width), np.float32)
    needs_features = False
    for i, rule in enumerate(rules.rules):
        for j, cond in enumerate(rule.when):
            if cond.fld == PROBA_FIELD:
                col = n_feat
            else:
                col = feature_names.index(cond.fld)
                needs_features = True
            sel[i, j, col] = 1.0
            idx[i, j] = col
            op[i, j] = _OP_CODES[cond.op]
            # the SAME cast Condition.mask applies on float32 columns
            if cond.op == "between":
                lo[i, j] = np.float32(cond.value[0])
                hi[i, j] = np.float32(cond.value[1])
            else:
                lo[i, j] = np.float32(cond.value)
                hi[i, j] = lo[i, j]
    return RulePlan(sel=sel, idx=idx, op=op, lo=lo, hi=hi,
                    processes=tuple(r.process for r in rules.rules),
                    names=tuple(r.name for r in rules.rules),
                    needs_features=needs_features, rules=rules)


def eval_plan(plan: RulePlan, x: torch.Tensor, proba: torch.Tensor,
              tensors: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """(B, F) float32 rows + (B,) float32 proba -> (B,) int64 fired index,
    on their device. ``tensors`` is ``plan.tensors(device)``, made once by
    the caller (made here when absent)."""
    t = plan.tensors(x.device) if tensors is None else tensors
    xf = x.float()
    pf = proba.float()
    n_feat = xf.shape[1]
    idx = t["idx"]  # (1, R, C); slot n_feat = proba
    feat = xf[:, idx[0].clamp(0, n_feat - 1)]  # (B, R, C)
    vals = torch.where(idx == n_feat, pf[:, None, None], feat)
    op, lo, hi = t["op"], t["lo"], t["hi"]
    pred = torch.ones_like(vals, dtype=torch.bool)  # OP_TRUE padding
    for code, hit in ((OP_GT, vals > lo), (OP_GE, vals >= lo), (OP_LT, vals < lo),
                      (OP_LE, vals <= lo), (OP_EQ, vals == lo), (OP_NE, vals != lo),
                      (OP_BETWEEN, (vals >= lo) & (vals <= hi))):
        pred = torch.where(op == code, hit, pred)
    matches = pred.all(dim=2)  # (B, R)
    # first True wins: argmax over an integer copy (not bool, which CUDA's
    # argmax refuses) returns the first maximal index
    return torch.argmax(matches.to(torch.int32), dim=1)


def build_decision_fn(forward: Callable[[Any, torch.Tensor], torch.Tensor],
                      plan: RulePlan) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Staged rows -> packed routed verdicts: ``decide(params, x)`` runs
    ``forward(params, x)`` (whatever the serving path dispatches: kernel B1,
    B2, or the plain graph) and the rules on the same device, and returns
    (B, 2) float32: column 0 the probability (the staged forward's bits),
    column 1 the fired rule index (small integers are exact in float32)."""
    per_device: dict[torch.device, dict[str, torch.Tensor]] = {}

    def decide(params: Any, x: torch.Tensor) -> torch.Tensor:
        t = per_device.get(x.device)
        if t is None:
            t = per_device[x.device] = plan.tensors(x.device)
        proba = forward(params, x).float()
        fired = eval_plan(plan, x, proba, t)
        return torch.stack([proba, fired.float()], dim=1)

    return decide


__all__ = [
    "RulePlan", "UnvectorizableRuleSet", "compile_rules", "eval_plan",
    "build_decision_fn",
]
