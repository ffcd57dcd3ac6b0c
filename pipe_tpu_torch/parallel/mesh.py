"""The ``(stage, data)`` world of ``torch.distributed`` ranks.

Counterpart of ``pipe_tpu/parallel/mesh.py``. In JAX a mesh is devices in
one program; here it is processes, one per mesh position, and the mesh is
this rank's view of them: its ``(stage, data)`` coordinates, the global
rank of every position (``grid``, laid out as JAX's
``np.asarray(devices).reshape(n_stages, n_data)``: stage outer, then data),
its stage-ring neighbours, and the process groups it talks over. The
pipeline of data index ``j`` is the column ``grid[:, j]`` (``column_group``),
the data replicas of stage ``i`` the row ``grid[i, :]`` (``data_group``).
Every group is made by every rank, in the same order, with the world's
timeout.

The mesh also moves tensors, in torch's idiom: per-cycle point-to-point
exchanges with ``dist.batch_isend_irecv`` (every receive posted before any
send), ``all_reduce`` and ``all_gather``; for the ring decoders
(``inference/pipelined.py``, ``serve/ring.py``) a shift by one over the
stage ring (:meth:`Mesh.ring_shift`) and a small broadcast of a host plan
(:meth:`Mesh.broadcast_plan`). After elastic training loses a stage,
:func:`survivor_mesh` is the mesh over the ranks left: its grid leaves out
the dead stage's row, and its "world" is the survivors' group, so that
nothing waits on a retired rank. The backend is the caller's
(``runtime/distributed.py``): over ``nccl`` CUDA tensors go as they are;
over ``gloo`` a CUDA tensor is staged through a pinned host buffer,
explicitly, and the staged bytes are counted in :attr:`Mesh.stats` beside
the bytes and host seconds of every exchange and collective. The context
and model axes (sequence and tensor parallelism) are not ported (ROADMAP.md
A.10).
"""

from __future__ import annotations

import dataclasses
import time
from datetime import timedelta
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "survivor_mesh", "localize", "STAGE_AXIS",
           "DATA_AXIS", "CONTEXT_AXIS", "MODEL_AXIS", "mesh_grid"]

STAGE_AXIS = "stage"
DATA_AXIS = "data"
CONTEXT_AXIS = "context"
MODEL_AXIS = "model"

def mesh_grid(n_stages: int, n_data: int) -> np.ndarray:
    """Global rank of each ``(stage, data)`` position: JAX's
    ``np.asarray(devices).reshape(n_stages, n_data)`` over ranks."""
    return np.arange(n_stages * n_data).reshape(n_stages, n_data)


@dataclasses.dataclass
class TransportStats:
    """What the mesh moved since :meth:`Mesh.reset_stats`: bytes and calls
    of the point-to-point exchanges (payload and layout headers) and of the
    collectives, the host seconds spent in each (staging copies included),
    and the bytes staged through pinned host memory (device to host plus
    host to device)."""

    p2p_bytes: int = 0
    p2p_messages: int = 0
    p2p_s: float = 0.0
    header_bytes: int = 0
    collective_bytes: int = 0
    collectives: int = 0
    collective_s: float = 0.0
    staged_bytes: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Mesh:
    """This rank's view of the ``(stage, data)`` world (module docstring).
    Made by :func:`make_mesh`."""

    def __init__(self, n_stages: int, n_data: int, *, device: torch.device,
                 timeout: timedelta, grid: Optional[np.ndarray] = None,
                 world_group=None):
        self.n_stages = n_stages
        self.n_data = n_data
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = device
        self.grid = (mesh_grid(n_stages, n_data) if grid is None
                     else np.asarray(grid))
        self.stage, self.data = (int(a[0]) for a in
                                 np.nonzero(self.grid == self.rank))
        # the group of every rank of the mesh (None: the default group) and
        # the rank that writes for the mesh (checkpoints, TensorBoard)
        self.world_group = world_group
        self.lead = int(self.grid[0, 0])
        columns, rows = _make_groups(self.grid, timeout)
        self.column_group = columns[self.data]
        self.data_group = rows[self.stage]
        self.prev = self.rank_of((self.stage - 1) % n_stages)
        self.next = self.rank_of((self.stage + 1) % n_stages)
        # gloo moves host tensors: CUDA tensors are staged explicitly
        self.staged = self.backend == "gloo" and device.type == "cuda"
        self.stats = TransportStats()
        self._pinned: Dict[Tuple[str, int], torch.Tensor] = {}

    def __repr__(self) -> str:
        return (f"Mesh(stage={self.stage}/{self.n_stages}, "
                f"data={self.data}/{self.n_data}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")

    def rank_of(self, stage: int, data: Optional[int] = None) -> int:
        """Global rank of position ``(stage, data)`` (this rank's data
        index by default)."""
        return int(self.grid[stage, self.data if data is None else data])

    def reset_stats(self) -> None:
        self.stats = TransportStats()

    # --- staging ---

    def _host(self, t: torch.Tensor, key: Tuple[str, int]) -> torch.Tensor:
        """A pinned host buffer of ``t``'s size and dtype, reused per
        ``key`` (an exchange waits for every transfer before it returns, so
        a buffer is free again at the next use of its key)."""
        nbytes = t.numel() * t.element_size()
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self._pinned[key] = buf
        return buf[:nbytes].view(t.dtype).view(t.shape)

    def _out(self, t: torch.Tensor, key: Tuple[str, int]) -> torch.Tensor:
        """The tensor the backend sends: ``t``, or its pinned host copy."""
        if not (self.staged and t.is_cuda):
            return t
        host = self._host(t, key)
        host.copy_(t)
        self.stats.staged_bytes += t.numel() * t.element_size()
        return host

    def _into(self, host: torch.Tensor, dst: torch.Tensor) -> None:
        if host is not dst:
            dst.copy_(host)
            self.stats.staged_bytes += dst.numel() * dst.element_size()

    def _landing(self, t: torch.Tensor, key: Tuple[str, int]) -> torch.Tensor:
        """Where the backend receives into for ``t``: ``t`` itself, or a
        pinned host buffer of its size."""
        if not (self.staged and t.is_cuda):
            return t
        return self._host(t, key)

    # --- point to point ---

    def exchange(self, sends: Dict[int, torch.Tensor],
                 recv_from: Iterable[int], *, dtype=torch.int32,
                 tag: int = 0) -> Dict[int, torch.Tensor]:
        """One cycle's messages: ``sends[peer]`` (a flat tensor on the
        mesh's device) to each peer, and one flat tensor from each peer of
        ``recv_from``, returned on the device. Each message goes as a layout
        header (its length) and its payload, every receive posted before
        any send, each round waited for in full."""
        recv_from = sorted(set(recv_from))
        if not sends and not recv_from:
            return {}
        t0 = time.perf_counter()
        # round 1: lengths (host int64, or device for nccl)
        hdev = self.device if self.backend == "nccl" else torch.device("cpu")
        h_in = {p: torch.zeros(1, dtype=torch.int64, device=hdev)
                for p in recv_from}
        h_out = {p: torch.tensor([t.numel()], dtype=torch.int64, device=hdev)
                 for p, t in sends.items()}
        self._p2p(h_in, h_out, tag)
        self.stats.header_bytes += 8 * (len(h_in) + len(h_out))
        # round 2: payloads
        got = {p: torch.empty(int(h_in[p].item()), dtype=dtype,
                              device=self.device) for p in recv_from}
        land = {p: self._landing(t, ("recv", p)) for p, t in got.items()}
        out = {p: self._out(t.contiguous(), ("send", p))
               for p, t in sends.items()}
        self._p2p(land, out, tag + 1)
        for p in recv_from:
            self._into(land[p], got[p])
        self.stats.p2p_messages += len(out) + len(land)
        self.stats.p2p_bytes += sum(t.numel() * t.element_size()
                                    for t in (*out.values(), *land.values()))
        self.stats.p2p_s += time.perf_counter() - t0
        return got

    @staticmethod
    def _p2p(recvs: Dict[int, torch.Tensor], sends: Dict[int, torch.Tensor],
             tag: int) -> None:
        ops = [dist.P2POp(dist.irecv, t, p, tag=tag)
               for p, t in sorted(recvs.items())]
        ops += [dist.P2POp(dist.isend, t, p, tag=tag)
                for p, t in sorted(sends.items())]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    # --- the stage ring ---

    def ring_shift(self, send: Optional[Sequence[torch.Tensor]] = None,
                   recv: Optional[Sequence[torch.Tensor]] = None, *,
                   tag: int = 0) -> None:
        """One hop round this pipeline's stage ring: the tensors of ``send``
        go to the next stage (stage n-1's over the wrap edge to stage 0)
        and the previous stage's land in ``recv``, buffers of the shapes and
        dtypes the caller's program fixes, written in place. Either may be
        None: no message that way this hop. A ring message's length is fixed
        by its program, so no length header goes first; every rank must
        agree with its neighbours on which messages a hop carries. CUDA
        tensors are staged as :meth:`exchange` stages them. Counted in
        :attr:`stats` as point-to-point messages. One stage: the ring is a
        loop, and ``send`` is copied into ``recv``."""
        send, recv = list(send or ()), list(recv or ())
        if not send and not recv:
            return
        t0 = time.perf_counter()
        if self.next == self.rank:
            for src, dst in zip(send, recv):
                dst.copy_(src)
            return
        land = [self._landing(t, ("ring_recv", k)) for k, t in
                enumerate(recv)]
        out = [self._out(t.contiguous(), ("ring_send", k)) for k, t in
               enumerate(send)]
        ops = [dist.P2POp(dist.irecv, t, self.prev, tag=tag + k)
               for k, t in enumerate(land)]
        ops += [dist.P2POp(dist.isend, t, self.next, tag=tag + k)
                for k, t in enumerate(out)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for host, dst in zip(land, recv):
            self._into(host, dst)
        self.stats.p2p_messages += len(out) + len(land)
        self.stats.p2p_bytes += sum(t.numel() * t.element_size()
                                    for t in (*out, *land))
        self.stats.p2p_s += time.perf_counter() - t0

    def broadcast_plan(self, words: Optional[np.ndarray], n: int,
                       stage: int = 0) -> np.ndarray:
        """A host plan of ``n`` int64 words from stage ``stage`` (``words``
        there, None on the others) to every rank of this pipeline, as
        numpy: one broadcast of a length the caller's protocol fixes. The
        ring's driving rank tells the others each call this way."""
        if self.n_stages == 1:
            return np.asarray(words, np.int64)
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        buf = torch.zeros(n, dtype=torch.int64, device=dev)
        if words is not None:
            w = np.asarray(words, np.int64).reshape(-1)
            if w.size > n:
                raise ValueError(f"a plan of {w.size} words does not fit "
                                 f"the {n} the protocol fixes")
            buf[:w.size] = torch.from_numpy(w).to(dev)
        t0 = time.perf_counter()
        dist.broadcast(buf, src=self.rank_of(stage), group=self.column_group)
        self.stats.collectives += 1
        self.stats.collective_bytes += 8 * n
        self.stats.collective_s += time.perf_counter() - t0
        return buf.cpu().numpy()

    # --- collectives ---

    def _group(self, over: str):
        if over == DATA_AXIS:
            return self.data_group, self.n_data
        if over == STAGE_AXIS:
            return self.column_group, self.n_stages
        if over == "world":
            return self.world_group, self.n_stages * self.n_data
        raise ValueError(f"no mesh axis {over!r}")

    def all_reduce(self, t: torch.Tensor, over: str = DATA_AXIS) -> None:
        """Sum ``t`` in place over the data group (``over="data"``), this
        rank's pipeline (``"stage"``) or the ``"world"``."""
        group, size = self._group(over)
        if size == 1:
            return
        t0 = time.perf_counter()
        buf = self._out(t, ("reduce", 0))
        dist.all_reduce(buf, group=group)
        self._into(buf, t)
        self.stats.collectives += 1
        self.stats.collective_bytes += t.numel() * t.element_size()
        self.stats.collective_s += time.perf_counter() - t0

    def all_gather(self, t: torch.Tensor, over: str = DATA_AXIS, *,
                   to_device: bool = True) -> List[torch.Tensor]:
        """Every member's ``t`` (one shape on all), in group order. With
        ``to_device=False`` staged results stay in their pinned host
        buffers (valid until the next gather), for a caller that copies
        them onward piece by piece."""
        group, size = self._group(over)
        if size == 1:
            return [t]
        t0 = time.perf_counter()
        src = self._out(t.contiguous(), ("gather", -1))
        if self.staged and t.is_cuda:
            outs = [self._host(t, ("gather", k)) for k in range(size)]
        else:
            outs = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(outs, src, group=group)
        if self.staged and t.is_cuda and to_device:
            outs = [o.to(t.device) for o in outs]
            self.stats.staged_bytes += size * t.numel() * t.element_size()
        self.stats.collectives += 1
        self.stats.collective_bytes += size * t.numel() * t.element_size()
        self.stats.collective_s += time.perf_counter() - t0
        return outs

    def broadcast_from(self, t: Optional[torch.Tensor], stage: int
                       ) -> torch.Tensor:
        """The tensor that stage ``stage`` of this rank's pipeline holds,
        on every rank of the pipeline (the others pass None)."""
        src = self.rank_of(stage)
        if self.n_stages == 1:
            return t
        meta = [None if t is None else (tuple(t.shape), t.dtype)]
        dist.broadcast_object_list(meta, src=src, group=self.column_group)
        shape, dtype = meta[0]
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=self.device)
        t0 = time.perf_counter()
        buf = (self._out(t.contiguous(), ("bcast", 0)) if self.rank == src
               else self._landing(t, ("bcast", 0)))
        dist.broadcast(buf, src=src, group=self.column_group)
        if self.rank != src:
            self._into(buf, t)
        self.stats.collectives += 1
        self.stats.collective_bytes += t.numel() * t.element_size()
        self.stats.collective_s += time.perf_counter() - t0
        return t

    def gather_outputs(self, outs: Optional[Tuple[torch.Tensor, ...]]
                       ) -> Tuple[torch.Tensor, ...]:
        """The last stage's outputs ``[m, rows / n_data, ...]`` (a tuple;
        None on the other stages) as the whole batch's ``[m, rows, ...]`` on
        every rank of this pipeline: gathered over the data group at the
        last stage, then broadcast down the pipeline."""
        last = self.n_stages - 1
        if self.stage == last:
            outs = tuple(torch.cat(self.all_gather(o.contiguous(), DATA_AXIS),
                                   dim=1) for o in outs)
        if self.n_stages == 1:
            return outs
        meta = [None if outs is None else len(outs)]
        dist.broadcast_object_list(meta, src=self.rank_of(last),
                                   group=self.column_group)
        return tuple(self.broadcast_from(
            None if outs is None else outs[k], last) for k in range(meta[0]))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the data group (a batch statistic; its
        backward sums the cotangents the same way), as JAX's ``psum`` over
        ``DATA_AXIS``."""
        if self.n_data == 1:
            return t
        return _PSum.apply(t, self)


class _PSum(torch.autograd.Function):
    """``all_reduce`` over the data group, forward and backward (the
    adjoint of a replicated sum is the sum of the cotangents)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        out = t.detach().clone()
        mesh.all_reduce(out, DATA_AXIS)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone()
        ctx.mesh.all_reduce(g, DATA_AXIS)
        return g, None


def _make_groups(grid: np.ndarray, timeout: timedelta):
    """One group per data column (a pipeline) and per stage row (the data
    replicas of a stage) of ``grid``. ``dist.new_group`` is collective over
    the default group: every rank of the world makes every group, in the
    same order, whether it is a member or not."""
    columns = [dist.new_group([int(r) for r in grid[:, j]], timeout=timeout)
               for j in range(grid.shape[1])]
    rows = [dist.new_group([int(r) for r in grid[i, :]], timeout=timeout)
            for i in range(grid.shape[0])]
    return columns, rows


def survivor_mesh(mesh: Mesh, lost_stage: int) -> Optional[Mesh]:
    """The mesh over the ranks that survive the loss of stage
    ``lost_stage``: ``mesh``'s grid without that stage's row (every data
    replica of the dead stage goes, as ``pipe_tpu`` drops the mesh row),
    stages renumbered, its "world" the survivors' own group. Every rank of
    the default group calls it, the dead stage's ranks too: they take part
    in making the groups without joining them, then get None and retire.
    A mesh made this way never touches the default group again."""
    from ..runtime import distributed as rd

    if mesh.world_group is not None:
        raise RuntimeError(
            "survivor_mesh of a survivor mesh: the ranks retired by the "
            "first loss no longer take part in making groups (ROADMAP.md "
            "C.19)")
    timeout = rd.world_timeout()
    grid = np.delete(mesh.grid, lost_stage, axis=0)
    world = dist.new_group(sorted(int(r) for r in grid.reshape(-1)),
                           timeout=timeout)
    if mesh.stage == lost_stage:
        _make_groups(grid, timeout)              # a member of none of them
        return None
    return Mesh(grid.shape[0], grid.shape[1], device=mesh.device,
                timeout=timeout, grid=grid, world_group=world)


_MESHES: Dict[Tuple[int, int], Mesh] = {}


def make_mesh(n_stages: int, n_data: Optional[int] = None, *,
              n_context: Optional[int] = None,
              n_model: Optional[int] = None,
              device=None, grid: Optional[np.ndarray] = None) -> Mesh:
    """This rank's :class:`Mesh` over the initialized world
    (``runtime.distributed.initialize``), ``n_stages`` x ``n_data`` ranks;
    ``n_data=None`` takes every rank left (``world // n_stages``), as JAX
    takes every device left. Stage is the outer axis, as in JAX. One mesh
    per shape is made per process (its groups with it) and returned again.
    ``device``: this rank's (default: the one ``initialize`` chose);
    ``grid``: another placement of the ranks (``[n_stages, n_data]`` global
    ranks; ``runtime.distributed.global_pipeline_mesh``)."""
    for name, n, item in (("n_context", n_context, "A.10, the context axis"),
                          ("n_model", n_model,
                           "A.10, tensor-parallel stage params")):
        if n is not None:
            raise NotImplementedError(
                f"make_mesh({name}={n}) is not ported to pipe_tpu_torch yet "
                f"(ROADMAP.md: {item})")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized world: "
            "runtime.distributed.initialize (or launch) first")
    world = dist.get_world_size()
    if n_stages <= 0:
        raise ValueError("n_stages must be positive")
    if world % n_stages:
        raise ValueError(f"{world} ranks not divisible by "
                         f"n_stages={n_stages}")
    if n_data is None:
        n_data = world // n_stages
    if n_stages * n_data != world:
        raise ValueError(
            f"mesh {n_stages}x{n_data} needs {n_stages * n_data} ranks, the "
            f"world has {world}")
    if grid is None:
        grid = mesh_grid(n_stages, n_data)
    key = (n_stages, n_data, np.asarray(grid).tobytes())
    mesh = _MESHES.get(key)
    if mesh is None:
        from ..runtime import distributed as rd
        mesh = Mesh(n_stages, n_data,
                    device=torch.device(device) if device is not None
                    else rd.rank_device(),
                    timeout=rd.world_timeout(), grid=grid)
        _MESHES[key] = mesh
    return mesh


def localize(module: torch.nn.Module, keep: Iterable[torch.nn.Module],
             device) -> torch.nn.Module:
    """Hold only what this rank runs: every parameter and buffer of
    ``module`` outside the ``keep`` modules goes to the ``meta`` device
    (shape and dtype kept, storage freed), the ``keep`` modules to
    ``device``. In place; returns ``module``."""
    kept = {id(t) for m in keep for t in (*m.parameters(), *m.buffers())}
    with torch.no_grad():
        for mod in module.modules():
            for name, p in list(mod._parameters.items()):
                if p is None:
                    continue
                if id(p) in kept:
                    if p.device != torch.device(device):
                        mod._parameters[name] = torch.nn.Parameter(
                            p.to(device), requires_grad=p.requires_grad)
                elif p.device.type != "meta":
                    mod._parameters[name] = torch.nn.Parameter(
                        p.to("meta"), requires_grad=p.requires_grad)
            for name, b in list(mod._buffers.items()):
                if b is None:
                    continue
                mod._buffers[name] = b.to(device if id(b) in kept else "meta")
    return module
