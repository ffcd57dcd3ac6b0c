"""The ``(stage, data[, context][, model])`` world of ``torch.distributed``
ranks.

Counterpart of ``pipe_tpu/parallel/mesh.py``. In JAX a mesh is devices in
one program; here it is processes, one per mesh position, and the mesh is
this rank's view of them: its ``(stage, data)`` coordinates, the global
rank of every position (``grid``, laid out as JAX's
``np.asarray(devices).reshape(n_stages, n_data)``: stage outer, then data),
its stage-ring neighbours, and the process groups it talks over. The
pipeline of data index ``j`` is the column ``grid[:, j]`` (``column_group``),
the data replicas of stage ``i`` the row ``grid[i, :]`` (``data_group``).
With a context axis (``make_mesh(n_context=)``, sequence parallelism) the
grid is ``[n_stages, n_data, n_context]``, context innermost as in JAX:
this rank also has a ``context`` index, a pipeline runs down each
``(data, context)`` column ``grid[:, j, c]``, the data group is
``grid[i, :, c]``, the context line ``grid[i, j, :]`` (``context_group``)
and the stage's whole ``(data, context)`` plane ``grid[i, :, :]``
(``plane_group``, where replicated gradients are summed). With a model
axis (``make_mesh(n_model=)``, tensor parallelism) the grid gains a last,
innermost dim, as JAX lays it out: ``[n_stages, n_data[, n_context],
n_model]``. This rank has a ``model`` index, every group above is taken at
its model index (a pipeline runs down ``grid[:, j, (c,) k]``, the plane is
``grid[i, :, (:,) k]``), and the model line ``grid[i, j, (c,) :]``
(``model_group``) carries the tensor-parallel blocks' all-reduces
(``ops/tp_layers.py``): gradients are never summed over it, as JAX's
``_grad_reduce_axes`` leaves the model axis out. Every group is made by
every rank, in the same order, with the world's timeout.

The mesh also moves tensors, in torch's idiom: per-cycle point-to-point
exchanges with ``dist.batch_isend_irecv`` (every receive posted before any
send), waited for in full (:meth:`Mesh.exchange`) or posted now and waited
for later (:meth:`Mesh.post`, :meth:`Mesh.wait`: the table executor's
overlapped transport, whose payload lengths both ends know),
``all_reduce`` (a sum or a max) and ``all_gather``; over the context
line a shift by one round the context ring (:meth:`Mesh.context_shift`,
JAX's ``ppermute``) and a tiled all-to-all (:meth:`Mesh.all_to_all`), with
their autograd forms :func:`context_shift` and :func:`all_to_all` and the
mean :func:`context_pmean`; for the ring decoders
(``inference/pipelined.py``, ``serve/ring.py``) a shift by one over the
stage ring (:meth:`Mesh.ring_shift`) and a small broadcast of a host plan
(:meth:`Mesh.broadcast_plan`). After elastic training loses a stage,
:func:`survivor_mesh` is the mesh over the ranks left: its grid leaves out
the dead stage's row, and its "world" is the survivors' group, so that
nothing waits on a retired rank. :func:`carve_meshes` makes one mesh per
disjoint sub-grid of the world (the fleet's replica carve): this rank's
entry is a working mesh whose "world" is its sub-grid's group, the others
a :class:`RemoteMesh` (shape and ranks only). The backend is the caller's
(``runtime/distributed.py``): over ``nccl`` CUDA tensors go as they are;
over ``gloo`` a CUDA tensor is staged through a pinned host buffer,
explicitly, and the staged bytes are counted in :attr:`Mesh.stats` beside
the bytes and host seconds of every exchange and collective.
"""

from __future__ import annotations

import dataclasses
import time
from datetime import timedelta
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "RemoteMesh", "make_mesh", "carve_meshes",
           "survivor_mesh", "localize", "STAGE_AXIS", "DATA_AXIS",
           "CONTEXT_AXIS", "MODEL_AXIS", "mesh_grid", "context_shift",
           "all_to_all", "context_pmean", "PartitionSpec", "param_tree",
           "tree_structure", "flat_specs", "shard_params",
           "gather_model_shards"]

STAGE_AXIS = "stage"
DATA_AXIS = "data"
CONTEXT_AXIS = "context"
MODEL_AXIS = "model"

def mesh_grid(n_stages: int, n_data: int,
              n_context: Optional[int] = None,
              n_model: Optional[int] = None) -> np.ndarray:
    """Global rank of each ``(stage, data)`` position: JAX's
    ``np.asarray(devices).reshape(n_stages, n_data)`` over ranks; with
    ``n_context`` each ``(stage, data, context)`` position, context
    innermost, and with ``n_model`` a last, innermost model dim."""
    shape = ((n_stages, n_data)
             + ((n_context,) if n_context is not None else ())
             + ((n_model,) if n_model is not None else ()))
    return np.arange(int(np.prod(shape))).reshape(shape)


def _grid4(grid: np.ndarray, n_context: Optional[int],
           n_model: Optional[int]) -> np.ndarray:
    """``grid`` as ``[stage, data, context, model]``, a size-1 dim for each
    axis the mesh lacks."""
    S, D = grid.shape[:2]
    return grid.reshape(S, D, n_context or 1, n_model or 1)


@dataclasses.dataclass
class TransportStats:
    """What the mesh moved since :meth:`Mesh.reset_stats`: bytes and calls
    of the point-to-point exchanges (payload and layout headers) and of the
    collectives, the host seconds spent in each (staging copies included),
    and the bytes staged through pinned host memory (device to host plus
    host to device). ``wait_s`` is the host seconds blocked in
    :meth:`Mesh.wait` on posted messages, which ``p2p_s`` leaves out (it
    holds the posting and the landing copies). The ``model_*`` fields count
    the collectives over the model line alone (the tensor-parallel blocks'
    all-reduces), which ``collectives`` counts too."""

    p2p_bytes: int = 0
    p2p_messages: int = 0
    p2p_s: float = 0.0
    wait_s: float = 0.0
    header_bytes: int = 0
    collective_bytes: int = 0
    collectives: int = 0
    collective_s: float = 0.0
    staged_bytes: int = 0
    model_collectives: int = 0
    model_bytes: int = 0
    model_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Mesh:
    """This rank's view of the ``(stage, data[, context][, model])`` world
    (module docstring). Made by :func:`make_mesh`."""

    def __init__(self, n_stages: int, n_data: int, *, device: torch.device,
                 timeout: timedelta, grid: Optional[np.ndarray] = None,
                 world_group=None, n_context: Optional[int] = None,
                 n_model: Optional[int] = None):
        self.n_stages = n_stages
        self.n_data = n_data
        # None: no context (model) axis; else its size
        self.n_context = n_context
        self.n_model = n_model
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = device
        self.grid = (mesh_grid(n_stages, n_data, n_context, n_model)
                     if grid is None else np.asarray(grid))
        # the grid as [stage, data, context, model], size 1 for a missing axis
        self._g4 = _grid4(self.grid, n_context, n_model)
        self.stage, self.data, self.context, self.model = (
            int(a[0]) for a in np.nonzero(self._g4 == self.rank))
        # the group of every rank of the mesh (None: the default group) and
        # the rank that writes for the mesh (checkpoints, TensorBoard)
        self.world_group = world_group
        self.lead = int(self.grid.flat[0])
        groups = _make_groups(self.grid, timeout, n_context, n_model)
        i, j, c, k = self.stage, self.data, self.context, self.model
        C, M = self.context_size, self.model_size
        self.column_group = groups["columns"][(j * C + c) * M + k]
        self.data_group = groups["rows"][(i * C + c) * M + k]
        self.context_group = self.plane_group = self.model_group = None
        if n_context is not None:
            self.context_group = groups["lines"][(i * n_data + j) * M + k]
            self.plane_group = groups["planes"][i * M + k]
        if n_model is not None:
            self.model_group = groups["models"][(i * n_data + j) * C + c]
        self.prev = self.rank_of((self.stage - 1) % n_stages)
        self.next = self.rank_of((self.stage + 1) % n_stages)
        # gloo moves host tensors: CUDA tensors are staged explicitly
        self.staged = self.backend == "gloo" and device.type == "cuda"
        self.stats = TransportStats()
        self._pinned: Dict[tuple, torch.Tensor] = {}
        # posted messages: the staging parity of the next post, and per
        # parity the event after which its landing buffers are free again
        self._parity = 0
        self._landed: Dict[int, Any] = {}

    def __repr__(self) -> str:
        ctx = ("" if self.n_context is None
               else f"context={self.context}/{self.n_context}, ")
        mod = ("" if self.n_model is None
               else f"model={self.model}/{self.n_model}, ")
        return (f"Mesh(stage={self.stage}/{self.n_stages}, "
                f"data={self.data}/{self.n_data}, {ctx}{mod}rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh's axes, as JAX's ``Mesh.axis_names``."""
        return ((STAGE_AXIS, DATA_AXIS)
                + ((CONTEXT_AXIS,) if self.n_context is not None else ())
                + ((MODEL_AXIS,) if self.n_model is not None else ()))

    @property
    def context_size(self) -> int:
        """The context axis' size (1 without the axis)."""
        return self.n_context or 1

    @property
    def model_size(self) -> int:
        """The model axis' size (1 without the axis)."""
        return self.n_model or 1

    def rank_of(self, stage: int, data: Optional[int] = None,
                context: Optional[int] = None,
                model: Optional[int] = None) -> int:
        """Global rank of position ``(stage, data[, context][, model])``
        (this rank's data, context and model indices by default)."""
        return int(self._g4[stage, self.data if data is None else data,
                            self.context if context is None else context,
                            self.model if model is None else model])

    def reset_stats(self) -> None:
        self.stats = TransportStats()

    # --- staging ---

    def _host(self, t: torch.Tensor, key: tuple) -> torch.Tensor:
        """A pinned host buffer of ``t``'s size and dtype, reused per
        ``key`` (an exchange waits for every transfer before it returns, so
        a buffer is free again at the next use of its key; posted messages
        alternate between two keys, :meth:`post`)."""
        nbytes = t.numel() * t.element_size()
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self._pinned[key] = buf
        return buf[:nbytes].view(t.dtype).view(t.shape)

    def _out(self, t: torch.Tensor, key: tuple) -> torch.Tensor:
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

    def _landing(self, t: torch.Tensor, key: tuple) -> torch.Tensor:
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
             tag: int, wait: bool = True) -> list:
        ops = [dist.P2POp(dist.irecv, t, p, tag=tag)
               for p, t in sorted(recvs.items())]
        ops += [dist.P2POp(dist.isend, t, p, tag=tag)
                for p, t in sorted(sends.items())]
        works = dist.batch_isend_irecv(ops) if ops else []
        if wait:
            for work in works:
                work.wait()
        return works

    def post(self, sends: Dict[int, torch.Tensor], recvs: Dict[int, int], *,
             dtype=torch.int32, tag: int = 0) -> "Posted":
        """Start one cycle's messages and return at once: ``sends[peer]``
        (a flat tensor on the mesh's device) to each peer, and from each
        peer of ``recvs`` a message of ``recvs[peer]`` elements, a length
        both ends know, so no header goes first. Staged messages alternate
        between two sets of pinned buffers, so the buffers of a message
        still in flight, or still being copied to the device, are never
        rewritten. :meth:`wait` completes them."""
        t0 = time.perf_counter()
        parity, self._parity = self._parity, self._parity ^ 1
        landed = self._landed.pop(parity, None)
        if landed is not None:
            landed.synchronize()     # the last copies out of these buffers
        got = {p: torch.empty(int(n), dtype=dtype, device=self.device)
               for p, n in sorted(recvs.items())}
        land = {p: self._landing(t, ("post_recv", p, parity))
                for p, t in got.items()}
        out = {p: self._out(t.contiguous(), ("post_send", p, parity))
               for p, t in sends.items()}
        works = self._p2p(land, out, tag, wait=False)
        self.stats.p2p_messages += len(out) + len(land)
        self.stats.p2p_bytes += sum(t.numel() * t.element_size()
                                    for t in (*out.values(), *land.values()))
        self.stats.p2p_s += time.perf_counter() - t0
        return Posted(works, got, land, parity)

    def wait(self, posted: "Posted") -> Dict[int, torch.Tensor]:
        """Complete what :meth:`post` started: every receive and send
        waited for (the seconds counted in ``stats.wait_s``), and each
        received message landed on the device (``{peer: tensor}``)."""
        t0 = time.perf_counter()
        for work in posted.works:
            work.wait()
        t1 = time.perf_counter()
        self.stats.wait_s += t1 - t0
        staged = False
        for p, dst in posted.got.items():
            host = posted.land[p]
            if host is not dst:
                dst.copy_(host, non_blocking=True)
                self.stats.staged_bytes += dst.numel() * dst.element_size()
                staged = True
        if staged:
            event = torch.cuda.Event()
            event.record()
            self._landed[posted.parity] = event
        self.stats.p2p_s += time.perf_counter() - t1
        return posted.got

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

    def _group(self, over):
        """The group and size of ``over``: an axis name, ``"world"``, or
        ``("data", "context")``, the stage's plane at this rank's model
        index (its data group without a context axis)."""
        if isinstance(over, tuple):      # the stage's plane
            if set(over) != {DATA_AXIS, CONTEXT_AXIS}:
                raise ValueError(f"no mesh axes {over!r}")
            if self.n_context is None:
                return self.data_group, self.n_data
            return self.plane_group, self.n_data * self.n_context
        if over == DATA_AXIS:
            return self.data_group, self.n_data
        if over == STAGE_AXIS:
            return self.column_group, self.n_stages
        if over == CONTEXT_AXIS:
            if self.n_context is None:
                raise ValueError(f"mesh has no {CONTEXT_AXIS!r} axis")
            return self.context_group, self.n_context
        if over == MODEL_AXIS:
            if self.n_model is None:
                raise ValueError(f"mesh has no {MODEL_AXIS!r} axis")
            return self.model_group, self.n_model
        if over == "world":
            return self.world_group, int(self.grid.size)
        raise ValueError(f"no mesh axis {over!r}")

    def group_size(self, over) -> int:
        """How many ranks :meth:`all_reduce` over ``over`` spans."""
        return self._group(over)[1]

    def all_reduce(self, t: torch.Tensor, over=DATA_AXIS,
                   op: str = "sum") -> None:
        """Sum ``t`` in place (``op="max"``: its maximum) over the data
        group (``over="data"``), this rank's pipeline (``"stage"``), its
        context line (``"context"``), its model line (``"model"``), its
        stage's plane (``("data", "context")``) or the ``"world"``."""
        group, size = self._group(over)
        if size == 1:
            return
        t0 = time.perf_counter()
        buf = self._out(t, ("reduce", 0))
        dist.all_reduce(buf, op=_OPS[op], group=group)
        self._into(buf, t)
        self._count(over, t.numel() * t.element_size(), t0)

    # --- the context line ---

    def context_shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """JAX's ``ppermute`` by ``step`` round the context ring: ``t`` goes
        to context index ``c + step`` and the tensor of ``c - step``
        (``step`` is +1 or -1; one shape and dtype on every rank) comes
        back, on the device. CUDA tensors are staged as :meth:`exchange`
        stages them; counted as point-to-point messages."""
        n = self.context_size
        if n == 1:
            return t.clone()
        t0 = time.perf_counter()
        dst = self.rank_of(self.stage, context=(self.context + step) % n)
        src = self.rank_of(self.stage, context=(self.context - step) % n)
        got = torch.empty_like(t)
        land = self._landing(got, ("ctx_recv", 0))
        out = self._out(t.contiguous(), ("ctx_send", 0))
        ops = [dist.P2POp(dist.irecv, land, src, group=self.context_group),
               dist.P2POp(dist.isend, out, dst, group=self.context_group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self._into(land, got)
        self.stats.p2p_messages += 2
        self.stats.p2p_bytes += 2 * t.numel() * t.element_size()
        self.stats.p2p_s += time.perf_counter() - t0
        return got

    def all_to_all(self, t: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """JAX's tiled ``all_to_all`` over the context line: ``t`` splits
        into ``n_context`` blocks along ``split_axis``, block ``j`` goes to
        context index ``j``, and the blocks received are joined along
        ``concat_axis`` in context order. One ``all_to_all_single`` (staged
        for CUDA tensors under gloo)."""
        n = self.context_size
        if n == 1:
            return t
        if t.shape[split_axis] % n:
            raise ValueError(
                f"all_to_all: dim {split_axis} of {tuple(t.shape)} does not "
                f"split over {n} context ranks")
        t0 = time.perf_counter()
        send = torch.stack(t.chunk(n, split_axis)).contiguous()
        got = torch.empty_like(send)
        land = self._landing(got, ("a2a_recv", 0))
        dist.all_to_all_single(land, self._out(send, ("a2a_send", 0)),
                               group=self.context_group)
        self._into(land, got)
        self.stats.collectives += 1
        self.stats.collective_bytes += 2 * t.numel() * t.element_size()
        self.stats.collective_s += time.perf_counter() - t0
        return torch.cat(got.unbind(0), dim=concat_axis)

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
        self._count(over, size * t.numel() * t.element_size(), t0)
        return outs

    def _count(self, over, nbytes: int, t0: float) -> None:
        """One collective over ``over`` of ``nbytes``, begun at ``t0``."""
        dt = time.perf_counter() - t0
        self.stats.collectives += 1
        self.stats.collective_bytes += nbytes
        self.stats.collective_s += dt
        if over == MODEL_AXIS:
            self.stats.model_collectives += 1
            self.stats.model_bytes += nbytes
            self.stats.model_s += dt

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


@dataclasses.dataclass
class Posted:
    """Messages :meth:`Mesh.post` started: the backend's work handles, the
    device tensors they land in, the buffers they arrive in (pinned host
    buffers when staged, else the device tensors) and the staging parity."""

    works: list
    got: Dict[int, torch.Tensor]
    land: Dict[int, torch.Tensor]
    parity: int


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class _ContextShift(torch.autograd.Function):
    """:meth:`Mesh.context_shift` of several tensors in one message; the
    adjoint shifts the cotangents the other way (JAX's ``ppermute``
    transpose)."""

    @staticmethod
    def forward(ctx, mesh, step, *ts):
        ctx.mesh, ctx.step = mesh, step
        return _split_flat(mesh.context_shift(_flat(ts), step), ts)

    @staticmethod
    def backward(ctx, *gs):
        back = ctx.mesh.context_shift(_flat(gs), -ctx.step)
        return (None, None, *_split_flat(back, gs))


def _flat(ts) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts]) if len(ts) > 1 \
        else ts[0].contiguous()


def _split_flat(flat: torch.Tensor, like) -> tuple:
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return tuple(out)


def context_shift(mesh: Optional["Mesh"], *ts: torch.Tensor,
                  step: int = 1) -> tuple:
    """The tensors ``ts`` (one dtype) shifted by ``step`` round the context
    ring, differentiably: the cotangents go back the other way. Without a
    context axis the ring is a loop and ``ts`` come back as they are."""
    if mesh is None or mesh.context_size == 1:
        return ts
    return _ContextShift.apply(mesh, step, *ts)


class _AllToAll(torch.autograd.Function):
    """:meth:`Mesh.all_to_all`; its adjoint is the reverse all-to-all
    (``split_axis`` and ``concat_axis`` swapped), as JAX transposes it."""

    @staticmethod
    def forward(ctx, t, mesh, split_axis, concat_axis):
        ctx.mesh, ctx.axes = mesh, (split_axis, concat_axis)
        return mesh.all_to_all(t, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (ctx.mesh.all_to_all(g.contiguous(), concat_axis, split_axis),
                None, None, None)


def all_to_all(mesh: Optional["Mesh"], t: torch.Tensor, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Differentiable tiled all-to-all over the context line
    (:meth:`Mesh.all_to_all`); the identity without a context axis."""
    if mesh is None or mesh.context_size == 1:
        return t
    return _AllToAll.apply(t, mesh, split_axis, concat_axis)


class _ContextMean(torch.autograd.Function):
    """The mean over the context line of a value that every rank then holds
    alike; its adjoint divides the (replicated) cotangent by the line's
    size without moving it, as JAX's ``pmean`` transposes under
    ``shard_map`` without replication checks."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.n = mesh.context_size
        out = t.detach().clone()
        mesh.all_reduce(out, CONTEXT_AXIS)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def context_pmean(mesh: Optional["Mesh"], t: torch.Tensor) -> torch.Tensor:
    """JAX's ``pmean`` over the context axis (a per-row loss over the global
    sequence); the identity without a context axis."""
    if mesh is None or mesh.context_size == 1:
        return t
    return _ContextMean.apply(t, mesh)


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


def _make_groups(grid: np.ndarray, timeout: timedelta,
                 n_context: Optional[int] = None,
                 n_model: Optional[int] = None) -> Dict[str, list]:
    """The groups of ``grid``, each list in row-major order over the
    positions it is indexed by: one per pipeline (``"columns"``, the stage
    column at each ``(data, context, model)``), per stage's data replicas
    (``"rows"``, at each ``(stage, context, model)``); with a context axis
    per context line (``"lines"``, at each ``(stage, data, model)``) and per
    stage's ``(data, context)`` plane (``"planes"``, at each ``(stage,
    model)``); with a model axis per model line (``"models"``, at each
    ``(stage, data, context)``). ``dist.new_group`` is collective over the
    default group: every rank of the world makes every group, in the same
    order, whether it is a member or not."""
    def make(ranks):
        return dist.new_group([int(r) for r in np.asarray(ranks).reshape(-1)],
                              timeout=timeout)

    g = _grid4(grid, n_context, n_model)
    S, D, C, M = g.shape
    out = {"columns": [make(g[:, j, c, k]) for j in range(D)
                       for c in range(C) for k in range(M)],
           "rows": [make(g[i, :, c, k]) for i in range(S)
                    for c in range(C) for k in range(M)]}
    if n_context is not None:
        out["lines"] = [make(g[i, j, :, k]) for i in range(S)
                        for j in range(D) for k in range(M)]
        out["planes"] = [make(g[i, :, :, k]) for i in range(S)
                         for k in range(M)]
    if n_model is not None:
        out["models"] = [make(g[i, j, c, :]) for i in range(S)
                         for j in range(D) for c in range(C)]
    return out


def survivor_mesh(mesh: Mesh, lost_stage: int) -> Optional[Mesh]:
    """The mesh over the ranks that survive the loss of stage
    ``lost_stage``: ``mesh``'s grid without that stage's row (every data
    replica of the dead stage goes, as ``pipe_tpu`` drops the mesh row),
    stages renumbered, its "world" the survivors' own group. Every rank of
    the default group calls it, the dead stage's ranks too: they take part
    in making the groups without joining them, then get None and retire.
    A mesh made this way never touches the default group again."""
    from ..runtime import distributed as rd

    if mesh.n_context is not None or mesh.n_model is not None:
        raise NotImplementedError(
            "survivor_mesh takes a (stage, data) mesh; pipe_tpu's elastic "
            "training has no context or model axis to carry over")
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


@dataclasses.dataclass(frozen=True)
class RemoteMesh:
    """A mesh of :func:`carve_meshes` that this rank is not part of: its
    shape and the global ranks of its positions; it moves nothing."""

    n_stages: int
    n_data: int
    grid: np.ndarray


def carve_meshes(grids: Sequence[np.ndarray], *, device=None) -> list:
    """One mesh per grid of global ranks (``[n_stages, n_data]`` each,
    disjoint sub-grids of the initialized world), in order: this rank's
    own entry is a :class:`Mesh` whose "world" is its grid's group, every
    other entry a :class:`RemoteMesh`. ``dist.new_group`` is collective
    over the default group, so every rank of the world calls this with the
    same grids and makes every mesh's groups, in the same order, whether it
    is a member or not (ROADMAP.md C.19)."""
    from ..runtime import distributed as rd

    if not dist.is_initialized():
        raise RuntimeError(
            "carve_meshes needs an initialized world: "
            "runtime.distributed.initialize (or launch) first")
    grids = [np.asarray(g) for g in grids]
    if any(g.ndim != 2 for g in grids):
        raise ValueError(
            "carve_meshes takes [n_stages, n_data] grids; pipe_tpu's replica "
            "carve has no context or model axis")
    ranks = [int(r) for g in grids for r in g.reshape(-1)]
    world = dist.get_world_size()
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                for r in ranks):
        raise ValueError(f"the grids must hold distinct ranks of the "
                         f"world's {world}, got {ranks}")
    timeout = rd.world_timeout()
    me = dist.get_rank()
    out: list = []
    for grid in grids:
        group = dist.new_group(sorted(int(r) for r in grid.reshape(-1)),
                               timeout=timeout)
        if me in grid:
            out.append(Mesh(grid.shape[0], grid.shape[1],
                            device=torch.device(device) if device is not None
                            else rd.rank_device(),
                            timeout=timeout, grid=grid, world_group=group))
        else:
            _make_groups(grid, timeout)          # a member of none of them
            out.append(RemoteMesh(grid.shape[0], grid.shape[1], grid))
    return out


_MESHES: Dict[tuple, Mesh] = {}


def make_mesh(n_stages: int, n_data: Optional[int] = None, *,
              n_context: Optional[int] = None,
              n_model: Optional[int] = None,
              device=None, grid: Optional[np.ndarray] = None) -> Mesh:
    """This rank's :class:`Mesh` over the initialized world
    (``runtime.distributed.initialize``), ``n_stages`` x ``n_data`` ranks,
    x ``n_context`` with a context axis and x ``n_model`` with a model axis
    (innermost, in that order, as JAX lays them out); ``n_data=None`` takes
    every rank left (``world // (n_stages * n_context * n_model)``), as JAX
    takes every device left. Stage is the outer axis, as in JAX. One mesh
    per shape is made per process (its groups with it) and returned again.
    ``device``: this rank's (default: the one ``initialize`` chose);
    ``grid``: another placement of the ranks (``[n_stages, n_data]`` global
    ranks; ``runtime.distributed.global_pipeline_mesh``)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized world: "
            "runtime.distributed.initialize (or launch) first")
    world = dist.get_world_size()
    if n_stages <= 0:
        raise ValueError("n_stages must be positive")
    if n_context is not None and n_context <= 0:
        raise ValueError("n_context must be positive (or None for no axis)")
    if n_model is not None and n_model <= 0:
        raise ValueError("n_model must be positive (or None for no axis)")
    ctx, tp = n_context or 1, n_model or 1
    inner = n_stages * ctx * tp
    if world % inner:
        what = ("n_stages" + ("*n_context" if n_context else "")
                + ("*n_model" if n_model else ""))
        raise ValueError(f"{world} ranks not divisible by {what}={inner}")
    if n_data is None:
        n_data = world // inner
    if n_data * inner != world:
        shape = (f"{n_stages}x{n_data}" + (f"x{ctx}" if n_context else "")
                 + (f"x{tp}" if n_model else ""))
        raise ValueError(
            f"mesh {shape} needs {n_data * inner} ranks, the world has "
            f"{world}")
    if grid is None:
        grid = mesh_grid(n_stages, n_data, n_context, n_model)
    elif n_context is not None or n_model is not None:
        raise ValueError("make_mesh(grid=) places a (stage, data) mesh only")
    key = (n_stages, n_data, n_context, n_model, np.asarray(grid).tobytes())
    mesh = _MESHES.get(key)
    if mesh is None:
        from ..runtime import distributed as rd
        mesh = Mesh(n_stages, n_data,
                    device=torch.device(device) if device is not None
                    else rd.rank_device(),
                    timeout=rd.world_timeout(), grid=grid,
                    n_context=n_context, n_model=n_model)
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


class PartitionSpec(tuple):
    """A parameter's layout over the mesh, as JAX's ``PartitionSpec``: one
    entry per dim, the name of the axis the dim is sharded over, or None
    where it is whole (``PartitionSpec()``: replicated)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def dim_of(self, axis: str) -> Optional[int]:
        """The dim sharded over ``axis``, or None."""
        return self.index(axis) if axis in self else None


def param_tree(module: torch.nn.Module) -> dict:
    """``module``'s parameters as a nested dict by their dotted names
    (``ln1.scale`` under ``["ln1"]["scale"]``), as JAX's param trees."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


def tree_structure(tree) -> Any:
    """The structure of a nested dict/list tree with its leaves as ``*``
    (``PartitionSpec`` and tensors alike are leaves; a tuple is a list)."""
    if isinstance(tree, dict):
        return {k: tree_structure(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return [tree_structure(v) for v in tree]
    return "*"


def flat_specs(tree, prefix: str = "") -> Dict[str, "PartitionSpec"]:
    """``{dotted leaf name: spec}`` of one module's nested spec tree (the
    names ``param_tree`` nests)."""
    if isinstance(tree, dict):
        out: Dict[str, PartitionSpec] = {}
        for k, v in tree.items():
            out.update(flat_specs(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def shard_params(module: torch.nn.Module, specs: dict, mesh) -> List[str]:
    """Slice each parameter of ``module`` named in ``specs`` (``{dotted
    name: PartitionSpec}``) to this rank's block of its dim sharded over
    the model axis, in place (a new ``nn.Parameter`` of the block; a
    parameter on the ``meta`` device is left). A parameter already cut to
    this rank's block is left as it is; one cut for another model line
    raises. Returns the names it cut. Without a model axis nothing is cut."""
    n = getattr(mesh, "n_model", None)
    if not n:
        return []
    cut = []
    for name, spec in specs.items():
        dim = spec.dim_of(MODEL_AXIS)
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        p = mod._parameters[leaf]
        if p.device.type == "meta":
            continue
        mark = getattr(p, "_model_shard", None)
        if mark == (mesh.model, n):
            continue
        if mark is not None:
            raise ValueError(
                f"{name} holds model shard {mark[0]} of {mark[1]}; this "
                f"rank's is {mesh.model} of {n}")
        if p.shape[dim] % n:
            raise ValueError(f"dim {dim} of {name} {tuple(p.shape)} does "
                             f"not shard over {n} model ranks")
        per = p.shape[dim] // n
        block = p.detach().narrow(dim, mesh.model * per, per).clone()
        new = torch.nn.Parameter(block, requires_grad=p.requires_grad)
        new._model_shard = (mesh.model, n)
        mod._parameters[leaf] = new
        cut.append(name)
    return cut


def gather_model_shards(mesh, named: Dict[str, torch.Tensor],
                        specs: Dict[str, "PartitionSpec"]
                        ) -> Dict[str, torch.Tensor]:
    """``named`` (a rank's tensors by parameter name: its parameters or
    their gradients) with every tensor sharded over the model axis
    (``specs``) gathered over this rank's model line into the whole leaf,
    the blocks in model order; the others as they are. Every rank of the
    line calls it with the same names."""
    out = dict(named)
    for name in sorted(named):
        spec = specs.get(name)
        dim = None if spec is None else spec.dim_of(MODEL_AXIS)
        if dim is None or mesh.model_size == 1:
            continue
        t = named[name].contiguous()
        out[name] = torch.cat(mesh.all_gather(t, MODEL_AXIS), dim=dim)
    return out

