"""The world of ranks: initialize it, build its mesh, place the batch, launch.

Counterpart of ``pipe_tpu/runtime/distributed.py``. JAX runs one program
over every device of every host; torch runs one process per mesh position,
joined by ``torch.distributed``:

* :func:`initialize` is ``dist.init_process_group`` with the backend, rank,
  world size, rendezvous and ``timeout`` said explicitly (or read from
  ``torchrun``'s environment), and the rank's device. ``"nccl"`` needs a card
  per rank and raises, naming NCCL's refusal, when ranks would share one;
  ``"gloo"`` takes CUDA tensors through pinned host buffers
  (``parallel/mesh.py``). Nothing switches the backend or the device for
  the caller.
* :func:`global_pipeline_mesh` is the ``(stage, data)`` mesh over the world;
  :func:`host_local_batch` this rank's rows of a global batch;
  :func:`process_summary` a line for logs.
* :func:`launch` runs ``fn`` on a world of processes spawned here
  (``torch.multiprocessing``, rendezvous through a ``FileStore``), and
  :class:`World` keeps such a world alive for many calls. Before the
  spawn, on the card, the kernels are built once in the launching process:
  the ranks then load them. The parent waits for its ranks with a deadline,
  and ends every one of them if any raises or the deadline passes.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "rank_device", "world_timeout",
           "pipeline_grid", "global_pipeline_mesh", "host_local_batch",
           "process_summary", "launch", "World", "WorldError"]

_STATE = {"device": None, "timeout": timedelta(minutes=10)}


class WorldError(RuntimeError):
    """A rank raised, or the world missed its deadline; the message holds
    the rank's traceback."""


def initialize(backend: str = "gloo", *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None,
               timeout: float = 600.0, device="cuda") -> None:
    """Join the world (idempotent): ``dist.init_process_group(backend,
    init_method, rank, world_size, timeout)``. Without ``rank`` and
    ``world_size`` they come from ``torchrun``'s ``RANK`` and ``WORLD_SIZE``
    (``init_method`` then defaults to ``env://``). ``device``: ``"cpu"``, or
    ``"cuda"`` for card ``LOCAL_RANK % device_count`` (``cuda:N`` pins one).
    ``"nccl"`` needs a card per rank of the host and raises when ranks would
    share one."""
    if dist.is_initialized():
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if rank is None or world_size is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError(
                "initialize needs rank and world_size (or torchrun's RANK "
                "and WORLD_SIZE)")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if init_method is None:
        raise ValueError("initialize needs an init_method (file:// or "
                         "tcp://localhost:PORT) when rank is given")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pipe_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        count = torch.cuda.device_count()
        if backend == "nccl" and world_size > count:
            raise RuntimeError(
                f"backend 'nccl' needs a card per rank: {world_size} ranks "
                f"on {count} card(s) would share one, which NCCL refuses "
                f"(\"Duplicate GPU detected\"); use backend='gloo'")
        if dev.index is None:
            dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("backend 'nccl' moves CUDA tensors; the CPU "
                         "needs 'gloo'")
    _STATE["device"] = dev
    _STATE["timeout"] = timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=_STATE["timeout"])


def is_initialized() -> bool:
    return dist.is_initialized()


def rank_device() -> torch.device:
    """The device :func:`initialize` chose for this rank."""
    if _STATE["device"] is None:
        raise RuntimeError("initialize() first")
    return _STATE["device"]


def world_timeout() -> timedelta:
    """The timeout every group of the world is made with."""
    return _STATE["timeout"]


def pipeline_grid(n_stages: int, n_data: int,
                  stage_across: bool = False) -> np.ndarray:
    """``pipe_tpu``'s placement of :func:`global_pipeline_mesh` over ranks:
    ``[n_stages, n_data]`` global ranks, stage the fastest-varying (a
    pipeline on consecutive ranks, within a host), or with
    ``stage_across`` stage-major (a pipeline across hosts)."""
    ranks = np.arange(n_stages * n_data)
    if stage_across:
        return ranks.reshape(n_stages, n_data)
    return ranks.reshape(n_data, n_stages).T


def global_pipeline_mesh(n_stages: int, n_data: Optional[int] = None, *,
                         stage_across: bool = False):
    """The ``(stage, data)`` mesh over the whole world, placed as
    ``pipe_tpu``'s (:func:`pipeline_grid`): the ranks of one pipeline are
    consecutive, so its hops stay on a host's links while only the gradient
    all-reduce crosses hosts."""
    from ..parallel.mesh import make_mesh
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_stages
    return make_mesh(n_stages, n_data,
                     grid=pipeline_grid(n_stages, n_data, stage_across))


def host_local_batch(mesh, batch, axis: int = 1):
    """This rank's rows of a global batch: along ``axis`` (1: the rows of
    ``[m, rows, ...]`` micro-batches; 0 for a flat ``[rows, ...]`` batch),
    block ``mesh.data`` of ``mesh.n_data``, as JAX's ``P(None, data)``
    sharding splits them. A dict is split leaf by leaf."""
    if isinstance(batch, dict):
        return {k: host_local_batch(mesh, v, axis) for k, v in batch.items()}
    rows = batch.shape[axis]
    if rows % mesh.n_data:
        raise ValueError(f"{rows} rows do not split over {mesh.n_data} data "
                         f"ranks")
    per = rows // mesh.n_data
    index = [slice(None)] * batch.ndim
    index[axis] = slice(mesh.data * per, (mesh.data + 1) * per)
    return batch[tuple(index)]


def process_summary() -> str:
    """One line for logs: this rank, the world, the backend, the device."""
    if not dist.is_initialized():
        return "process 0/1 | not distributed"
    return (f"process {dist.get_rank()}/{dist.get_world_size()} | backend "
            f"{dist.get_backend()} | device {rank_device()}")


# --- spawning a world ---

def _serve(rank: int, world: int, init_method: str, backend: str,
           device: str, timeout: float, threads: int, tasks, results):
    """A rank's process: join the world, then run each task it is sent."""
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(backend, rank=rank, world_size=world,
                   init_method=init_method, timeout=timeout, device=device)
        results.put((rank, "ready", time.time()))
    except Exception:                        # noqa: BLE001 -- reported
        results.put((rank, "err", traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, "ok", fn(*args)))
        except Exception:                    # noqa: BLE001 -- reported
            results.put((rank, "err", traceback.format_exc()))
            return
    dist.destroy_process_group()


class World:
    """``n`` ranks spawned once and kept for many :meth:`run` calls.

    ``device`` and ``backend`` go to each rank's :func:`initialize`;
    ``timeout`` is the world's group timeout (a rank stuck in a collective
    raises after it), ``threads`` each rank's ``torch.set_num_threads`` (0:
    torch's default). The world is a context manager; :meth:`close` ends
    it. A rank that raises, or a run past its deadline, ends the whole
    world and raises :class:`WorldError`; the next :meth:`run` spawns a new
    one. On the card the kernels are built before the first spawn."""

    def __init__(self, n: int, *, device="cuda", backend: str = "gloo",
                 timeout: float = 600.0, threads: int = 0,
                 store_dir: Optional[str] = None):
        from ..utils.platform import resolve_device
        resolve_device(device)          # no card: raise here, not in a rank
        self.n = n
        self.device = str(device)
        self.backend = backend
        self.timeout = timeout
        self.threads = threads
        self.store_dir = store_dir
        self.procs: List[Any] = []
        self.spawn_to_ready_s: Optional[float] = None
        self._spawns = 0
        self._own_dir: Optional[str] = None

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _spawn(self) -> None:
        import torch.multiprocessing as mp
        if torch.device(self.device).type == "cuda":
            from .. import _build
            _build.build_all()                # once, before the ranks load
        ctx = mp.get_context("spawn")
        if self.store_dir is None and self._own_dir is None:
            self._own_dir = tempfile.mkdtemp(prefix="pipe_tpu_world_")
        root = self.store_dir or self._own_dir
        os.makedirs(root, exist_ok=True)
        self._spawns += 1
        store = os.path.join(root, f"store_{os.getpid()}_{self._spawns}")
        self.tasks = [ctx.Queue() for _ in range(self.n)]
        self.results = ctx.Queue()
        t0 = time.perf_counter()
        self.procs = [ctx.Process(
            target=_serve, daemon=True,
            args=(r, self.n, f"file://{store}", self.backend, self.device,
                  self.timeout, self.threads, self.tasks[r], self.results))
            for r in range(self.n)]
        for p in self.procs:
            p.start()
        self._collect("ready", self.timeout)
        self.spawn_to_ready_s = time.perf_counter() - t0

    def _collect(self, want: str, deadline_s: float) -> List[Any]:
        out: List[Any] = [None] * self.n
        left = set(range(self.n))
        end = time.monotonic() + deadline_s
        while left:
            try:
                rank, kind, value = self.results.get(
                    timeout=max(0.05, min(1.0, end - time.monotonic())))
            except queue.Empty:
                dead = [r for r in left if not self.procs[r].is_alive()]
                if dead or time.monotonic() > end:
                    self.close()
                    raise WorldError(
                        f"rank(s) {dead or sorted(left)} "
                        f"{'died' if dead else 'missed the deadline'} "
                        f"({deadline_s:.0f} s) while the world waited for "
                        f"{want!r}")
                continue
            if kind == "err":
                self.close()
                raise WorldError(f"rank {rank} raised:\n{value}")
            out[rank] = value
            left.discard(rank)
        return out

    def run(self, fn: Callable, *args, timeout: Optional[float] = None
            ) -> List[Any]:
        """``fn(*args)`` on every rank (``fn`` a module-level function the
        ranks can import); the ranks' results in rank order."""
        if not self.procs:
            self._spawn()
        for q in self.tasks:
            q.put((fn, args))
        return self._collect("ok", timeout or self.timeout)

    def close(self) -> None:
        """End every rank: a stop message, a short wait, then kill."""
        procs, self.procs = self.procs, []
        for q, p in zip(getattr(self, "tasks", []), procs):
            if p.is_alive():
                try:
                    q.put(None)
                except (OSError, ValueError):
                    pass
        end = time.monotonic() + 5.0
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        if self._own_dir is not None and not self.procs:
            shutil.rmtree(self._own_dir, ignore_errors=True)
            self._own_dir = None


def launch(fn: Callable, world: int, *args, device="cuda",
           backend: str = "gloo", timeout: float = 600.0,
           threads: int = 0) -> List[Any]:
    """Run ``fn(*args)`` once on ``world`` spawned ranks and return their
    results (rank order); the ranks end with it."""
    with World(world, device=device, backend=backend, timeout=timeout,
               threads=threads) as w:
        return w.run(fn, *args)


def rows_of(mesh, total: int) -> Sequence[int]:
    """``(offset, total)``: this rank's rows of a micro-batch of ``total``
    rows (``StageCtx.rows``)."""
    per = total // mesh.n_data
    return (mesh.data * per, total)

