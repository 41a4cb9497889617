"""FleetLedgerTap: per-transaction route dispositions onto a bus topic.

The port's copy of ccfd_tpu/fleet/ledger.py. The fleet's conservation
proof ("no drop, no double-route" across a hard member kill) cannot stand
on scraped counters alone: a SIGKILLed member takes its counters with it.
What survives the kill is the BUS, the one shared component, so each
member publishes a compact ledger entry per routed transaction to a fleet
topic (``fleet.ledger``), stamped with the member id and the consumer-group
epoch the batch was polled under. The kill drill (tools/torch_fleet_drill.py)
replays the ledger and checks the law with
:func:`ccfd_tpu_torch.fleet.protocol.check_ledger_conservation`:

* every produced tx has >= 1 disposition (no drop: a member killed
  mid-batch leaves its offsets uncommitted, so the batch redelivers);
* no tx is disposed twice under ONE epoch (no double-route: the bus's
  epoch fence refuses the dead member's in-flight commit);
* cross-epoch duplicates are counted as at-least-once redeliveries.

The tap sits in the router's audit seam (the operator installs it as the
router's ``audit`` when the fleet component is up): ``record_batch`` is
called at the route seam with exactly the rows that started a process,
BEFORE the batch's offsets commit, so a kill between route and commit
yields a redelivery (counted), never a gap. It forwards to an inner
:class:`~ccfd_tpu_torch.observability.audit.AuditLog` when the provenance
plane is armed, so fleet mode stacks on top of the per-decision audit
trail, never replaces it.

Publishing is best-effort like every observability writer: a bus edge
failure counts (``fleet_ledger_publish_errors_total``) and routing never
stalls. The entries it would have published are then missing from the
ledger; the drill reads that as a drop, which is the honest verdict when
the accounting evidence itself was lost.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Mapping

log = logging.getLogger(__name__)

LEDGER_TOPIC = "fleet.ledger"


class FleetLedgerTap:
    """Audit-shaped tap publishing one ledger entry per routed row.

    Duck-types the router's audit surface (``record_batch``); everything
    else the operator wires on the inner AuditLog directly. ``epoch_fn``
    is set by the operator AFTER the router exists (it reads the epoch the
    batch being recorded was polled under, ``Router.batch_epoch``: the
    reference reads the tx consumer's current epoch, which a pipelined
    loop may already have moved past the batch's); until then entries
    carry ``epoch=None``,
    which the conservation checker treats as one more distinct epoch —
    conservative: it can only turn a real same-epoch double-route into
    a reported one, never hide one.
    """

    def __init__(
        self,
        broker: Any,
        member: str,
        topic: str = LEDGER_TOPIC,
        inner: Any = None,
        epoch_fn: Callable[[], int | None] | None = None,
        registry: Any = None,
    ):
        self.broker = broker
        self.member = str(member)
        self.topic = topic
        self.inner = inner
        self.epoch_fn = epoch_fn
        self._c_entries = self._c_err = None
        if registry is not None:
            self._c_entries = registry.counter(
                "fleet_ledger_entries_total",
                "route dispositions published to the fleet ledger topic",
            )
            self._c_err = registry.counter(
                "fleet_ledger_publish_errors_total",
                "ledger batches lost to bus-edge failures (best-effort "
                "writer: routing never stalls on the ledger)",
            )

    def record_batch(
        self,
        rows: list[dict],
        *,
        tier: str = "device",
        cause: str | None = None,
        events: tuple | list = (),
        worker: int | None = None,
        trace_id: str | None = None,
        threshold: float | None = None,
    ) -> None:
        if self.inner is not None:
            # the provenance plane's own error handling applies inside
            self.inner.record_batch(
                rows, tier=tier, cause=cause, events=events, worker=worker,
                trace_id=trace_id, threshold=threshold,
            )
        if not rows:
            return
        epoch = None
        if self.epoch_fn is not None:
            try:
                epoch = self.epoch_fn()
            except Exception:  # noqa: BLE001 - epoch is advisory; None is
                # the conservative stamp (see class docstring)
                if self._c_err is not None:
                    self._c_err.inc(labels={"stage": "epoch"})
        entries = [
            {"tx": r.get("tx"), "uid": r.get("uid"), "tier": tier}
            for r in rows
        ]
        try:
            self.broker.produce(
                self.topic,
                {"member": self.member, "epoch": epoch, "entries": entries},
                key=self.member,
            )
            if self._c_entries is not None:
                self._c_entries.inc(len(entries))
        except Exception:  # noqa: BLE001 - best-effort writer (docstring):
            # the loss is counted and the drill reads the gap as a drop
            if self._c_err is not None:
                self._c_err.inc(labels={"stage": "produce"})
            log.warning("fleet ledger publish failed (%d entries)",
                        len(entries), exc_info=True)


def flatten_ledger(records: list[Any]) -> list[dict[str, Any]]:
    """Explode polled ledger bus records into per-tx entries for
    :func:`ccfd_tpu_torch.fleet.protocol.check_ledger_conservation` — each
    entry re-carries its batch's ``member``/``epoch`` stamps."""
    out: list[dict[str, Any]] = []
    for rec in records:
        v = rec.value if hasattr(rec, "value") else rec
        if not isinstance(v, Mapping):
            continue
        member, epoch = v.get("member"), v.get("epoch")
        for e in v.get("entries", ()):
            out.append({"tx": e.get("tx"), "uid": e.get("uid"),
                        "tier": e.get("tier"), "member": member,
                        "epoch": epoch})
    return out
