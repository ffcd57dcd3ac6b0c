"""The process-separated serving fleet: counterpart of ``pipe_tpu/fleet``.

The coordination plane for N serve-engine replicas, split from the
transport that reaches them:

* :mod:`.control` -- the transport-agnostic control plane.
  :class:`~.control.FleetController` owns placement, the
  HEALTHY->SUSPECT->WEDGED->DRAINING->RETIRED health machine, retry
  budgets and the exactly-once delivery ledger, speaking to replicas only
  through the :class:`~.control.ReplicaTransport` interface.
  :class:`~.control.InProcessTransport` ticks an engine serially or on a
  tick thread of its own (``async_tick=True``).
* :mod:`.proc` -- :class:`~.proc.ProcessReplicaTransport`: each replica a
  real OS process (``python -m pipe_tpu_torch.fleet.proc``) owning its own
  engine, captured graphs and KV pool on its device, speaking a
  length-prefixed msgpack/JSON wire protocol with heartbeats that carry
  the health signals across the process boundary.
* :mod:`.journal` -- the fsync'd request journal a restarted controller
  recovers from (``FleetController.from_journal``).
* :mod:`.disagg` -- prefill/decode role-split fleets.
* :mod:`.topology` -- device-range plans per replica, and the carve of a
  world of ranks into per-replica meshes.

``serve/router.py``'s :class:`~..serve.router.Router` is a thin shim over
this package.
"""

from .control import (DRAINING, HEALTHY, RETIRED, SUSPECT, WEDGED,
                      FleetController, InProcessTransport, Replica,
                      ReplicaHealth, ReplicaTransport, RouterPolicy,
                      TransportError)
from .disagg import DisaggController, RoleSuggestion, suggest_roles
from .journal import JournalState, RequestJournal
from .proc import (FleetSpawnError, ProcessReplicaTransport, ReplicaSpec,
                   check_spawn_capability)
from .topology import (carve_replica_meshes, carve_role_meshes,
                       replica_device_plan, role_device_plan)

__all__ = ["FleetController", "DisaggController", "ReplicaTransport",
           "InProcessTransport", "Replica", "ReplicaHealth", "RouterPolicy",
           "TransportError", "RoleSuggestion", "suggest_roles",
           "RequestJournal", "JournalState",
           "ProcessReplicaTransport", "ReplicaSpec", "FleetSpawnError",
           "check_spawn_capability", "carve_replica_meshes",
           "carve_role_meshes", "replica_device_plan", "role_device_plan",
           "HEALTHY", "SUSPECT", "WEDGED", "DRAINING", "RETIRED"]
