"""Replica spawn plans: carve the device list into fleets.

Counterpart of ``pipe_tpu/fleet/topology.py``. Each replica owns a
contiguous, process-aligned slice of the device list: replica *i* owns
devices ``[i*per, (i+1)*per)``, so a replica either fits inside one process
or owns whole processes, never a fractional share of two.

:func:`replica_device_plan` and :func:`role_device_plan` are the pure
planning half (validation and index ranges); without ``n_devices`` they read
``torch.cuda.device_count()``. :func:`carve_replica_meshes` and
:func:`carve_role_meshes` carve the initialized world of
``runtime/distributed.py`` the same way, its global ranks in place of
``pipe_tpu``'s device list: replica *i*'s grid is ``pipeline_grid`` of its
shape, offset by its ``start``, as ``pipe_tpu``'s ``global_pipeline_mesh``
lays out its slice of devices. Every rank of the world calls them (making a
group is collective over the default group, ROADMAP.md C.19) and gets the
list in the plan's order: its own replica's entry is a working
``parallel.mesh.Mesh``, the others ``RemoteMesh`` records of shape and ranks
(C.23).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

__all__ = ["ReplicaDevices", "RoleReplicaDevices", "replica_device_plan",
           "role_device_plan", "carve_replica_meshes", "carve_role_meshes"]

_ROLES = ("prefill", "decode", "mixed")


def _device_count() -> int:
    import torch
    return torch.cuda.device_count()


@dataclasses.dataclass(frozen=True)
class ReplicaDevices:
    """One replica's slice of the device grid: global-list index range
    ``[start, stop)`` plus the (n_stages, n_data) mesh shape it will be
    folded into."""

    index: int
    start: int
    stop: int
    n_stages: int
    n_data: int

    @property
    def n_devices(self) -> int:
        return self.stop - self.start


def replica_device_plan(n_replicas: int, n_stages: int,
                        n_data: Optional[int] = None, *,
                        n_devices: Optional[int] = None,
                        devices_per_process: Optional[int] = None
                        ) -> List[ReplicaDevices]:
    """Split ``n_devices`` into ``n_replicas`` contiguous
    ``n_stages x n_data`` sub-meshes; raises ``ValueError`` with the
    arithmetic spelled out when the grid doesn't divide.

    ``devices_per_process`` (when known) adds the process-alignment
    check: each replica's share must be a multiple OR a divisor of one
    process's device count, so no replica takes a fractional share of
    two processes.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_devices is None:
        n_devices = _device_count()
    if n_devices % n_replicas:
        raise ValueError(
            f"{n_devices} devices do not split over {n_replicas} "
            f"replicas ({n_devices} % {n_replicas} != 0)")
    per = n_devices // n_replicas
    if per % n_stages:
        raise ValueError(
            f"each replica's {per} devices do not fold into "
            f"n_stages={n_stages} ({per} % {n_stages} != 0)")
    data = per // n_stages if n_data is None else n_data
    if n_stages * data != per:
        raise ValueError(
            f"replica mesh {n_stages}x{data} needs {n_stages * data} "
            f"devices but each replica owns {per}")
    if devices_per_process is not None and devices_per_process > 0:
        if per % devices_per_process and devices_per_process % per:
            raise ValueError(
                f"replica share of {per} devices straddles the process "
                f"boundary ({devices_per_process} devices/process): a "
                f"replica must own whole processes or fit inside one")
    return [ReplicaDevices(index=i, start=i * per, stop=(i + 1) * per,
                           n_stages=n_stages, n_data=data)
            for i in range(n_replicas)]


@dataclasses.dataclass(frozen=True)
class RoleReplicaDevices(ReplicaDevices):
    """One role-specialized replica's slice of the grid. Unlike the
    symmetric plan, role plans are asymmetric by design: a prefill
    replica typically takes a wide data axis (large-batch chunked
    prefill is throughput-bound), a decode replica a deep slot count on
    fewer devices (the resident loop is latency-bound), so
    shares differ per replica."""

    role: str = "mixed"


def role_device_plan(specs: Sequence, *,
                     n_devices: Optional[int] = None,
                     devices_per_process: Optional[int] = None
                     ) -> List[RoleReplicaDevices]:
    """Carve the device grid into role-asymmetric contiguous sub-meshes.

    ``specs`` is one entry per replica: ``(role, n_stages, n_data)``
    tuples or ``{"role", "n_stages", "n_data"}`` dicts, in placement
    order. Each replica owns exactly ``n_stages * n_data`` devices —
    shares may differ between replicas (that is the point) — and the
    plan must consume the grid exactly: ``sum(shares) == n_devices``.

    Process alignment is the same discipline as the symmetric plan but
    checked per-slice, because unequal shares can misalign even when
    every share individually divides the process size: a replica either
    fits inside one process (its slice does not cross a process
    boundary) or owns whole processes (starts on a boundary and spans a
    multiple of ``devices_per_process``).
    """
    if not specs:
        raise ValueError("role_device_plan needs at least one replica spec")
    norm: List[tuple] = []
    for i, spec in enumerate(specs):
        if isinstance(spec, dict):
            role = spec.get("role", "mixed")
            ns, nd = spec.get("n_stages", 1), spec.get("n_data", 1)
        else:
            role, ns, nd = spec
        if role not in _ROLES:
            raise ValueError(
                f"replica {i}: role must be one of {_ROLES}, got {role!r}")
        ns, nd = int(ns), int(nd)
        if ns < 1 or nd < 1:
            raise ValueError(
                f"replica {i}: mesh shape {ns}x{nd} is not positive")
        norm.append((str(role), ns, nd))
    need = sum(ns * nd for _, ns, nd in norm)
    if n_devices is None:
        n_devices = _device_count()
    if need != n_devices:
        raise ValueError(
            f"role plan wants {need} devices (sum of n_stages*n_data "
            f"over {len(norm)} replicas: "
            f"{[ns * nd for _, ns, nd in norm]}) but the grid has "
            f"{n_devices}")
    plan: List[RoleReplicaDevices] = []
    start = 0
    dpp = devices_per_process
    for i, (role, ns, nd) in enumerate(norm):
        per = ns * nd
        if dpp is not None and dpp > 0:
            if per >= dpp:
                if per % dpp or start % dpp:
                    raise ValueError(
                        f"replica {i} ({role}) owns {per} devices from "
                        f"index {start}: a multi-process replica must "
                        f"start on a process boundary and span whole "
                        f"processes ({dpp} devices/process)")
            elif start // dpp != (start + per - 1) // dpp:
                raise ValueError(
                    f"replica {i} ({role}) owns devices [{start}, "
                    f"{start + per}) which straddle the process boundary "
                    f"at {((start // dpp) + 1) * dpp} ({dpp} "
                    f"devices/process): a sub-process replica must fit "
                    f"inside one process")
        plan.append(RoleReplicaDevices(index=i, start=start,
                                       stop=start + per, n_stages=ns,
                                       n_data=nd, role=role))
        start += per
    return plan


def _carve_grids(plan, ranks: Sequence[int], stage_across: bool) -> list:
    """Each plan entry's ``[n_stages, n_data]`` grid of global ranks:
    ``pipeline_grid`` of its shape over ``ranks[start:stop]``, as
    ``pipe_tpu``'s ``global_pipeline_mesh`` lays out its slice of
    devices."""
    import numpy as np

    from ..runtime.distributed import pipeline_grid
    ranks = np.asarray(ranks)
    return [ranks[rd.start + pipeline_grid(rd.n_stages, rd.n_data,
                                           stage_across)] for rd in plan]


def _carve(plan, ranks: Sequence[int], stage_across: bool) -> list:
    from ..parallel.mesh import carve_meshes
    return carve_meshes(_carve_grids(plan, ranks, stage_across))


def _world_ranks(devices: Optional[Sequence[int]]) -> List[int]:
    if devices is not None:
        return [int(r) for r in devices]
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "the carve needs an initialized world: "
            "runtime.distributed.initialize (or launch) first")
    return list(range(dist.get_world_size()))


def carve_role_meshes(specs: Sequence, *,
                      devices: Optional[Sequence[int]] = None,
                      stage_across: bool = False) -> list:
    """One ``(stage, data)`` mesh per role-specialized replica, carved
    contiguously per :func:`role_device_plan` over the world's ranks
    (``devices``: the global ranks to carve, default every rank):
    index-aligned with the plan, this rank's replica a working ``Mesh`` and
    the others ``RemoteMesh`` records. Every rank of the world calls it."""
    ranks = _world_ranks(devices)
    plan = role_device_plan(specs, n_devices=len(ranks))
    return _carve(plan, ranks, stage_across)


def carve_replica_meshes(n_replicas: int, n_stages: int,
                         n_data: Optional[int] = None, *,
                         devices: Optional[Sequence[int]] = None,
                         stage_across: bool = False) -> list:
    """One ``(stage, data)`` mesh per replica, carved contiguously from the
    world's ranks (``devices``: the global ranks to carve, default every
    rank) as :func:`replica_device_plan` plans them: index-aligned with the
    plan, this rank's replica a working ``Mesh`` and the others
    ``RemoteMesh`` records. Every rank of the world calls it."""
    ranks = _world_ranks(devices)
    plan = replica_device_plan(n_replicas, n_stages, n_data,
                               n_devices=len(ranks))
    return _carve(plan, ranks, stage_across)
