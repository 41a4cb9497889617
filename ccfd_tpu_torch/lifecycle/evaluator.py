"""Challenger evaluation: delayed human labels + shadow score distributions.

The port's copy of ccfd_tpu/lifecycle/evaluator.py (numpy; the PSI is the
port's ``analytics/engine.py::psi``).

Two evidence streams feed a candidate's verdict:

- **Labels** (the fraud process's resolution stream on ``cfg.labels_topic``
  — process/fraud.py ``record``): each labeled transaction is re-scored by
  BOTH the champion (host forward) and the challenger (double-buffered
  challenger slot), giving paired (y, p_champion, p_challenger) samples on
  exactly the same rows. From these: AUC (rank/Mann-Whitney with average
  ranks) and precision@k — the ranking-quality gates.
- **Shadow pairs** (ShadowTap's paired records on the shadow topic): the
  champion-vs-challenger score-distribution comparison over live traffic —
  per-model alert rates against ``FRAUD_THRESHOLD`` (their delta is the
  "how many more investigations would this model open" operational gate)
  and score-distribution PSI reusing :func:`ccfd_tpu_torch.analytics.engine.psi`
  on fixed ``[0, 1]`` histograms.

The evaluator is single-candidate: ``begin(version)`` resets the
accumulators; records carrying any other version are dropped as stale.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from ccfd_tpu_torch.analytics.engine import psi
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.data.ccfd import FEATURE_NAMES

DEFAULT_SCORE_BINS = 32


def auc_score(y: np.ndarray, p: np.ndarray) -> float:
    """NaN-tolerant rank AUC: :func:`ccfd_tpu_torch.utils.metrics_math.roc_auc`
    (midrank Mann-Whitney) with "not judgeable yet" — empty input or one
    class only — reported as NaN instead of raising, which is what the
    guardrail checks key on (a NaN gate neither passes nor breaches)."""
    from ccfd_tpu_torch.utils.metrics_math import roc_auc

    y = np.asarray(y, np.float64)
    if len(y) == 0 or y.sum() == 0 or y.sum() == len(y):
        return float("nan")
    return roc_auc(y > 0.5, np.asarray(p, np.float64))


def precision_at_k(y: np.ndarray, p: np.ndarray, k: int) -> float:
    """Fraction of true frauds in the k highest-scored rows — the
    investigator-queue quality metric (k = the queue capacity)."""
    y = np.asarray(y, np.float64)
    p = np.asarray(p, np.float64)
    if len(y) == 0:
        return float("nan")
    k = max(1, min(int(k), len(y)))
    top = np.argsort(p, kind="mergesort")[::-1][:k]
    return float(y[top].mean())


class EvalSnapshot(NamedTuple):
    version: int | None
    n_labels: int
    n_shadow_rows: int
    auc_champion: float
    auc_challenger: float
    precision_champion: float
    precision_challenger: float
    alert_rate_champion: float
    alert_rate_challenger: float
    alert_rate_delta: float
    score_psi: float

    def to_dict(self) -> dict[str, Any]:
        """JSON-safe dict: non-finite floats (not-judgeable-yet gates)
        become null — these land in the persisted audit trail and the
        ``lifecycle --json`` export, which strict parsers must accept."""
        import math

        out: dict[str, Any] = {}
        for k, v in self._asdict().items():
            if v is None or isinstance(v, int):
                out[k] = v
            else:
                f = float(v)
                out[k] = f if math.isfinite(f) else None
        return out


class ShadowEvaluator:
    def __init__(
        self,
        cfg: Config,
        broker: Any,
        scorer: Any,
        registry: Any = None,
        nbins: int = DEFAULT_SCORE_BINS,
        k_frac: float = 0.05,
        max_labels: int = 50_000,
    ):
        self.cfg = cfg
        self.scorer = scorer
        self.nbins = int(nbins)
        self.k_frac = float(k_frac)
        # label-accumulator bound: a candidate parked in SHADOW (traffic
        # too thin to ever fill its gates) must not grow the paired lists
        # forever; oldest labels age out together so the pairing holds
        self.max_labels = int(max_labels)
        self._labels_consumer = broker.consumer(
            "lifecycle-eval", (cfg.labels_topic,)
        )
        self._shadow_consumer = broker.consumer(
            "lifecycle-shadow", (cfg.shadow_topic,)
        )
        self._version: int | None = None
        self._edges = np.linspace(0.0, 1.0, self.nbins + 1)
        self._reset_accumulators()
        self._g_labels = self._g_auc = self._g_psi = self._g_delta = None
        if registry is not None:
            self._g_labels = registry.gauge(
                "ccfd_lifecycle_eval_labels",
                "labels joined against the current candidate",
            )
            self._g_rows = registry.gauge(
                "ccfd_lifecycle_eval_shadow_rows",
                "shadow-pair rows folded into the candidate's distributions",
            )
            self._g_auc = registry.gauge(
                "ccfd_lifecycle_auc",
                "label AUC by model (champion vs current challenger)",
            )
            self._g_psi = registry.gauge(
                "ccfd_lifecycle_score_psi",
                "champion-vs-challenger score-distribution PSI over live "
                "shadow traffic",
            )
            self._g_delta = registry.gauge(
                "ccfd_lifecycle_alert_rate_delta",
                "challenger minus champion alert rate at FRAUD_THRESHOLD",
            )

    def _reset_accumulators(self) -> None:
        self._y: list[float] = []
        self._p_champ: list[float] = []
        self._p_chall: list[float] = []
        self._hist_champ = np.zeros(self.nbins, np.float64)
        self._hist_chall = np.zeros(self.nbins, np.float64)
        self._alerts_champ = 0
        self._alerts_chall = 0
        self._shadow_rows = 0
        self._set_mark()

    def _set_mark(self) -> None:
        self._mark_n = len(getattr(self, "_y", ()))
        self._mark_hist_champ = np.array(
            getattr(self, "_hist_champ", np.zeros(self.nbins)), np.float64)
        self._mark_hist_chall = np.array(
            getattr(self, "_hist_chall", np.zeros(self.nbins)), np.float64)
        self._mark_alerts_champ = getattr(self, "_alerts_champ", 0)
        self._mark_alerts_chall = getattr(self, "_alerts_chall", 0)
        self._mark_rows = getattr(self, "_shadow_rows", 0)

    def mark(self) -> None:
        """Start an evidence WINDOW at the current accumulators. The
        controller marks at canary entry so canary guardrails judge what
        happened DURING the canary — a regression that only appears under
        canary serving must not be diluted away by a long green shadow
        history (``snapshot_window``)."""
        self._set_mark()

    # -- candidate lifecycle ----------------------------------------------
    def begin(self, version: int) -> None:
        self._version = int(version)
        self._reset_accumulators()

    def end(self) -> None:
        self._version = None
        self._reset_accumulators()

    @property
    def version(self) -> int | None:
        return self._version

    # cheap gate counters: the controller polls these every tick and only
    # pays for a full snapshot (rank sorts over the whole history) once
    # the verdict thresholds are actually reachable
    @property
    def n_labels(self) -> int:
        return len(self._y)

    @property
    def n_shadow_rows(self) -> int:
        return self._shadow_rows

    # -- ingestion ---------------------------------------------------------
    def poll(self, max_records: int = 4096) -> int:
        """Consume both streams once; returns records folded in. Both
        consumers drain even with no candidate active so a new candidate
        starts from the live head instead of a stale backlog."""
        folded = 0
        shadow = self._shadow_consumer.poll(max_records, 0.0)
        labels = self._labels_consumer.poll(max_records, 0.0)
        if self._version is None:
            return 0
        for rec in shadow:
            msg = rec.value or {}
            if msg.get("version") != self._version:
                continue
            champ = np.asarray(msg.get("champion", ()), np.float64)
            chall = np.asarray(msg.get("challenger", ()), np.float64)
            if champ.shape != chall.shape or champ.size == 0:
                continue
            self._hist_champ += np.histogram(
                np.clip(champ, 0.0, 1.0), bins=self._edges)[0]
            self._hist_chall += np.histogram(
                np.clip(chall, 0.0, 1.0), bins=self._edges)[0]
            thr = self.cfg.fraud_threshold
            self._alerts_champ += int((champ >= thr).sum())
            self._alerts_chall += int((chall >= thr).sum())
            self._shadow_rows += int(champ.size)
            folded += 1
        rows, ys = [], []
        for rec in labels:
            msg = rec.value or {}
            tx = msg.get("transaction") or {}
            try:
                row = [float(tx.get(n, 0.0) or 0.0) for n in FEATURE_NAMES]
                y = float(msg.get("label", 0))
            except (TypeError, ValueError):
                continue
            rows.append(row)
            ys.append(y)
        if rows:
            x = np.asarray(rows, np.float32)
            try:
                p_champ = np.asarray(self.scorer.host_score(x), np.float64)
                p_chall = np.asarray(
                    self.scorer.challenger_score(x), np.float64)
            except Exception:  # noqa: BLE001 - challenger mid-teardown:
                # drop this poll's labels rather than desync the pairing
                return folded
            self._y.extend(ys)
            self._p_champ.extend(p_champ.tolist())
            self._p_chall.extend(p_chall.tolist())
            overflow = len(self._y) - self.max_labels
            if overflow > 0:  # age out oldest, keeping the pairing intact
                del self._y[:overflow]
                del self._p_champ[:overflow]
                del self._p_chall[:overflow]
                self._mark_n = max(0, self._mark_n - overflow)
            folded += len(rows)
        if self._g_labels is not None:
            # evidence-count gauges refresh cheaply every poll; the
            # expensive AUC/PSI gauges refresh on full snapshots only
            self._g_labels.set(len(self._y))
            self._g_rows.set(self._shadow_rows)
        return folded

    # -- verdict inputs ----------------------------------------------------
    def _compute(self, y, pc, pn, hist_champ, hist_chall,
                 alerts_champ, alerts_chall, n_shadow) -> EvalSnapshot:
        y = np.asarray(y, np.float64)
        pc = np.asarray(pc, np.float64)
        pn = np.asarray(pn, np.float64)
        k = max(1, int(round(self.k_frac * len(y)))) if len(y) else 1
        alert_c = alerts_champ / n_shadow if n_shadow else float("nan")
        alert_n = alerts_chall / n_shadow if n_shadow else float("nan")
        score_psi = (
            float(psi(hist_chall, hist_champ)) if n_shadow else float("nan")
        )
        return EvalSnapshot(
            version=self._version,
            n_labels=len(y),
            n_shadow_rows=n_shadow,
            auc_champion=auc_score(y, pc),
            auc_challenger=auc_score(y, pn),
            precision_champion=precision_at_k(y, pc, k),
            precision_challenger=precision_at_k(y, pn, k),
            alert_rate_champion=alert_c,
            alert_rate_challenger=alert_n,
            alert_rate_delta=(alert_n - alert_c if n_shadow else float("nan")),
            score_psi=score_psi,
        )

    def snapshot_window(self) -> EvalSnapshot:
        """Metrics over the evidence since the last :meth:`mark` only."""
        return self._compute(
            self._y[self._mark_n:],
            self._p_champ[self._mark_n:],
            self._p_chall[self._mark_n:],
            self._hist_champ - self._mark_hist_champ,
            self._hist_chall - self._mark_hist_chall,
            self._alerts_champ - self._mark_alerts_champ,
            self._alerts_chall - self._mark_alerts_chall,
            self._shadow_rows - self._mark_rows,
        )

    def snapshot(self) -> EvalSnapshot:
        snap = self._compute(
            self._y, self._p_champ, self._p_chall,
            self._hist_champ, self._hist_chall,
            self._alerts_champ, self._alerts_chall, self._shadow_rows,
        )
        if self._g_labels is not None:
            self._g_labels.set(snap.n_labels)
            self._g_rows.set(snap.n_shadow_rows)
            if np.isfinite(snap.auc_champion):
                self._g_auc.set(snap.auc_champion,
                                labels={"model": "champion"})
            if np.isfinite(snap.auc_challenger):
                self._g_auc.set(snap.auc_challenger,
                                labels={"model": "challenger"})
            if np.isfinite(snap.score_psi):
                self._g_psi.set(snap.score_psi)
            if np.isfinite(snap.alert_rate_delta):
                self._g_delta.set(snap.alert_rate_delta)
        return snap

    def close(self) -> None:
        self._labels_consumer.close()
        self._shadow_consumer.close()
