"""Prediction service for user-task auto-triage (jBPM's SeldonPredictionService).

The port's copy of ccfd_tpu/process/prediction.py. jBPM calls a model to
predict the outcome of an investigation user task; confidence >=
CONFIDENCE_THRESHOLD closes the task automatically, below it the prediction
is pre-filled for the human. ``ScorerPredictionService`` scores the task's
transaction features through a scorer callable (the port's ``Scorer.score``,
so on the card each prediction is one launch of the served kernel) and maps
the probability to (outcome, confidence), with confidence the margin
``max(p, 1 - p)``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np

from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES

if TYPE_CHECKING:  # pragma: no cover
    from ccfd_tpu_torch.process.engine import Task


def task_features(task: "Task") -> np.ndarray:
    """(1, 30) feature row from the task's transaction variables."""
    tx = task.vars.get("transaction", task.vars)
    return np.asarray(
        [[float(tx.get(name, 0.0)) for name in FEATURE_NAMES]], dtype=np.float32)


class ScorerPredictionService:
    """Backs the prediction hook with a scorer callable (np (B,30) -> np (B,))."""

    def __init__(self, score_fn: Callable[[np.ndarray], np.ndarray]):
        self._score = score_fn

    def predict(self, task: "Task") -> tuple[bool, float]:
        proba = float(np.asarray(self._score(task_features(task)))[0])
        is_fraud = proba >= 0.5
        confidence = max(proba, 1.0 - proba)
        return is_fraud, confidence
