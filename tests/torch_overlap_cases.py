"""What the ranks of tests/test_torch_overlap.py's gloo world run.

Each function runs on every rank of a 4-rank world of CPU ranks
(``pipe_tpu_torch.runtime.World``) and returns numpy results for the test
process. This module imports neither JAX nor ``pipe_tpu``: the ranks never
load them.
"""

import warnings

import numpy as np
import torch
from torch import nn

import pipe_tpu_torch as pt
from pipe_tpu_torch.core.schedule import InterleavedOneFOneBSchedule
from pipe_tpu_torch.fleet import topology
from pipe_tpu_torch.ops.layers import Linear
from pipe_tpu_torch.parallel.mesh import (Mesh, RemoteMesh, localize,
                                          make_mesh)
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline, SkipLanes

# (overlap_transport, phase_compile) of the three walks held to each other
TRANSPORTS = ((False, False), (True, False), (None, True))


class Toy(nn.Module):
    """``tanh(h @ w + b)`` per virtual stage from numpy weights; with lanes,
    each lane's value boards at its source (the stage's output) and is added
    at its destination (tests/test_overlap_transport.py's stage body)."""

    def __init__(self, params, pairs=(), device="cpu"):
        super().__init__()
        self.stages = nn.ModuleList()
        for p in params:
            stage = nn.Module()
            stage.w = nn.Parameter(torch.tensor(p["w"], device=device))
            stage.b = nn.Parameter(torch.tensor(p["b"], device=device))
            self.stages.append(stage)
        self.pairs = tuple(pairs)

    def stage_fn(self, s, h, ctx, pops=None):
        st = torch.tanh(h @ self.stages[s].w + self.stages[s].b)
        if not self.pairs:
            return st
        for l, (src, dst) in enumerate(self.pairs):
            if s == dst:
                st = st + pops[l]
        return st, tuple(st if s == src else None
                         for (src, dst) in self.pairs)

    @staticmethod
    def pre_fn(x_mb, ctx):
        return x_mb["x"]

    @staticmethod
    def post_fn(h, x_mb, ctx):
        return ((h - x_mb["tgt"]) ** 2).mean(-1)


def toy_pipeline(case, params, *, mesh=None, overlap=None, phase=None):
    """The port's executor of a transparency case ``(id, schedule, d, m,
    mode, pairs, v, data, policy)``: ``(pipeline, toy)``."""
    _, schedule, d, _, mode, pairs, v, _, policy = case
    device = mesh.device if isinstance(mesh, Mesh) else "cpu"
    toy = Toy(params, pairs, device)
    if isinstance(mesh, Mesh):            # this rank holds its stages only
        localize(toy, [toy.stages[s] for s in range(v * d)
                       if s % d == mesh.stage], device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = ScheduledPipeline(
            toy.stage_fn, toy.pre_fn, toy.post_fn, n_stages=d, module=toy,
            checkpoint=mode,
            schedule=(InterleavedOneFOneBSchedule(interleave=v) if v > 1
                      else schedule),
            device=device, skip_lanes=SkipLanes(pairs, ()) if pairs else None,
            remat_policy="dots_saveable" if policy else None,
            overlap_transport=overlap, phase_compile=phase, mesh=mesh)
    return pipe, toy


def toy_step(pipe, x, tgt):
    """One step: ``(loss, {name: grad})`` as numpy."""
    m, rows = x.shape[:2]
    loss, grads = pipe.loss_and_grad(
        {"x": torch.from_numpy(x), "tgt": torch.from_numpy(tgt)},
        torch.ones(m, rows), seed=9)
    return float(loss), {k: g.detach().cpu().numpy().copy()
                         for k, g in grads.items()}


def world_transports(case, params, x, tgt):
    """On every rank: the case's step serialized, overlapped and
    phase-compiled over a ``(d, data)`` mesh, twice each (the second step
    crosses every boundary on the one-round path), with each walk's memory
    plan, slot peaks and the seconds waited on posted messages."""
    _, _, d, m, _, _, _, data, _ = case
    mesh = make_mesh(d, data)
    out = []
    for overlap, phase in TRANSPORTS:
        pipe, toy = toy_pipeline(case, params, mesh=mesh, overlap=overlap,
                                 phase=phase)
        mesh.reset_stats()
        steps = []
        for _ in range(2):
            toy.zero_grad(set_to_none=True)
            steps.append(toy_step(pipe, x, tgt))
        out.append(dict(steps=steps, plan=pipe.memory_plan(m),
                        slots=dict(pipe.last_slots),
                        wait_s=mesh.stats.wait_s,
                        p2p_messages=mesh.stats.p2p_messages,
                        header_bytes=mesh.stats.header_bytes))
    return dict(stage=mesh.stage, data=mesh.data, runs=out,
                auto=(toy_pipeline(case, params, mesh=mesh)[0]
                      ._overlap_enabled(),
                      toy_pipeline(case, params, mesh=mesh)[0]
                      ._phase_program(m) is not None))


def pipe_phase(x, y):
    """``Pipe(mesh=make_mesh(2, 2), phase_compile=...)`` over four Linear
    layers under 1f1b: ``(loss, packed grads)`` with the phase-compiled
    walk and with the interpreted one."""
    mesh = make_mesh(2, 2)
    out = []
    for phase in (True, False):
        gen = torch.Generator().manual_seed(0)
        seq = pt.Sequential([Linear(x.shape[-1], x.shape[-1], device="cpu",
                                    generator=gen) for _ in range(4)])
        pipe = pt.Pipe(seq, chunks=4, n_stages=2, checkpoint="never",
                       schedule="1f1b", mesh=mesh, phase_compile=phase)
        loss, grads = pipe.loss_and_grad(
            torch.from_numpy(x), targets=torch.from_numpy(y),
            loss_fn=lambda out, tgt: ((out - tgt) ** 2).mean(-1))
        out.append((float(loss), {k: g.detach().numpy().copy()
                                  for k, g in grads.items()},
                    pipe.memory_plan()["transport"]))
    return out


def carve():
    """The fleet's carve over the 4-rank world: 2 replicas of 2 stages, and
    a prefill replica of 1 x 2 beside a decode replica of 2 x 1. Per carve:
    each entry's grid, which entry is this rank's (a working ``Mesh``) and
    the others' types, and a sum of the rank ids over the own replica's
    world group and its stage group."""
    out = []
    for meshes in (topology.carve_replica_meshes(2, 2),
                   topology.carve_role_meshes([("prefill", 1, 2),
                                               ("decode", 2, 1)])):
        own = [k for k, mm in enumerate(meshes) if isinstance(mm, Mesh)]
        mine = meshes[own[0]]
        total = torch.tensor([float(mine.rank)])
        mine.all_reduce(total, "world")
        column = torch.tensor([float(mine.rank)])
        mine.all_reduce(column, "stage")
        out.append(dict(grids=[np.asarray(mm.grid).tolist()
                               for mm in meshes], own=own,
                        remote=[isinstance(mm, RemoteMesh)
                                for mm in meshes],
                        world_sum=float(total), stage_sum=float(column),
                        shape=(mine.n_stages, mine.n_data)))
    return out
