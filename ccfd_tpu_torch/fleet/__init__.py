"""Fleet plane: N operator processes over ONE shared bus.

The port's copy of ccfd_tpu/fleet/. Horizontal scaling for the serving
pipeline, the reference system's k8s replicas-over-Kafka story, built from
parts the port already has: the networked bus (bus/server.py) carries
partition ownership via consumer groups with an epoch fence, each member is
a full ``platform.operator`` process (on one card, N processes share it),
and the fleet layer adds membership (heartbeat gossip), fleet-wide
admission rescale, champion-parity quarantine, and a supervisor that
kills, fences and respawns members.

    protocol.py    pure membership/assignment/parity functions
    member.py      FleetMember: heartbeat server + gossip loop + gauges
    supervisor.py  FleetSupervisor: spawn/kill/fence/respawn member procs
    ledger.py      FleetLedgerTap: per-tx route dispositions to a bus
                   topic, the durable fleet accounting ledger
"""

from ccfd_tpu_torch.fleet.protocol import (  # noqa: F401
    check_disjoint_ownership,
    check_fingerprint_parity,
    elect_aggregator,
    live_members,
    plan_partition_assignment,
)
