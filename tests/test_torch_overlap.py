"""pipe_tpu_torch's overlapped transport and phase-compiled walk
(``ScheduledPipeline(overlap_transport=, phase_compile=)``) against its
serialized, interpreted walk and against ``pipe_tpu``'s executor.

* One device: the 10 cases of tests/test_overlap_transport.py's
  ``TRANSPARENCY_CASES`` (every schedule family, the three checkpoint modes,
  ``dots_saveable``, multi-hop and 0-hop skip lanes, data rows), the
  overlapped and the phase-compiled walk bit for bit the serialized one;
  ``memory_plan`` (``transport``, ``grad_park_slots``, ``cycles``, the skip
  parks, ``phase_*``) equal to ``pipe_tpu``'s for each case and transport.
* The tri-states' auto rule; ``pipe_tpu``'s phase verdicts; the loud
  rejection (interleaved v2 at d 2, m 16 warns, counts and trains bit for
  bit); the counters and gauges.
* One 4-rank gloo world of CPU ranks (``tests/torch_overlap_cases.py``, no
  JAX): ``1f1b-except_last``, ``zb-h1-never``, ``interleaved-v2``,
  ``lane-3hop-1f1b`` over 4 stages and ``ppxdp`` over 2 x 2, each walk bit
  for bit the serialized one (two steps: the second crosses every boundary
  on the one-round path), and against ``pipe_tpu``'s overlapped step within
  fp32 1e-6 of max(1, max|g|); ``Pipe(mesh=, phase_compile=True)`` bitwise
  its interpreted twin; the fleet's carve into working meshes.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_overlap_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.schedule import InterleavedOneFOneBSchedule as JInter
from pipe_tpu.parallel.interleaved import (stack_interleaved_params,
                                           unstack_interleaved_params)
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.scheduled import SkipLanes as JLanes
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch.obs.telemetry import MetricsRegistry, set_registry
from pipe_tpu_torch.runtime import World

WIDTH = 8
ROWS = 4               # rows per data shard, as tests/test_overlap_transport.py
TOL_JAX = 1e-6         # of max(1, max|g|), fp32

# (id, schedule, d, m, mode, pairs, v, data, policy): pipe_tpu's
# TRANSPARENCY_CASES (tests/test_overlap_transport.py:107-121)
TRANSPARENCY_CASES = [
    ("gpipe-always", "gpipe", 4, 8, "always", (), 1, 1, False),
    ("1f1b-never", "1f1b", 4, 8, "never", (), 1, 1, False),
    ("1f1b-except_last", "1f1b", 4, 8, "except_last", (), 1, 1, False),
    ("1f1b-policy-remat", "1f1b", 4, 8, "except_last", (), 1, 1, True),
    ("interleaved-v2", "interleaved-1f1b", 4, 8, "except_last",
     (), 2, 1, False),
    ("zb-h1-never", "zb-h1", 4, 8, "never", (), 1, 1, False),
    ("lane-3hop-1f1b", "1f1b", 4, 8, "except_last", ((0, 3),), 1, 1, False),
    ("lanes-dual-never", "1f1b", 4, 8, "never",
     ((0, 2), (1, 3)), 1, 1, False),
    ("lane-0hop-v2", "interleaved-1f1b", 4, 8, "except_last",
     ((0, 4),), 2, 1, False),
    ("ppxdp-4x2", "1f1b", 4, 8, "except_last", (), 1, 2, False),
]
BY_ID = {c[0]: c for c in TRANSPARENCY_CASES}
# the world's cases: 4 stages, and 2 stages x 2 data
WORLD_CASES = [BY_ID["1f1b-except_last"], BY_ID["zb-h1-never"],
               BY_ID["interleaved-v2"], BY_ID["lane-3hop-1f1b"],
               ("ppxdp", "1f1b", 2, 8, "except_last", (), 1, 2, False)]


def make_inputs(case, seed=0):
    """numpy weights per virtual stage and the batch ``[m, rows, WIDTH]``."""
    _, _, d, m, _, _, v, data, _ = case
    rng = np.random.default_rng(seed)
    params = [{"w": (rng.standard_normal((WIDTH, WIDTH)) * 0.3)
               .astype(np.float32),
               "b": (rng.standard_normal(WIDTH) * 0.1).astype(np.float32)}
              for _ in range(v * d)]
    x = rng.standard_normal((m, ROWS * data, WIDTH)).astype(np.float32)
    tgt = rng.standard_normal((m, ROWS * data, WIDTH)).astype(np.float32)
    return params, x, tgt


def jax_pipeline(case, **kw):
    _, schedule, d, _, mode, pairs, v, data, policy = case
    sched = JInter(interleave=v) if v > 1 else schedule
    lanes = (JLanes(pairs=tuple(pairs), specs=tuple(
        jax.ShapeDtypeStruct((ROWS, WIDTH), jnp.float32) for _ in pairs))
        if pairs else None)

    def lane_stage(p, h, ctx, pops):
        st = jnp.tanh(h @ p["w"] + p["b"])
        for (src, dst), pop in zip(pairs, pops):
            st = st + jnp.where(jnp.asarray(ctx.stage == dst), pop, 0.0)
        return st, tuple(jnp.where(jnp.asarray(ctx.stage == src), st,
                                   jnp.zeros((ROWS, WIDTH), jnp.float32))
                         for (src, dst) in pairs)

    def plain_stage(p, h, ctx):
        return jnp.tanh(h @ p["w"] + p["b"])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JPipeline(
            jmake_mesh(d, data, devices=jax.devices()[:d * data]),
            lane_stage if pairs else plain_stage,
            pre_fn=lambda p, x_mb, ctx: x_mb["x"],
            post_fn=lambda p, h, x_mb, ctx: jnp.mean((h - x_mb["tgt"]) ** 2,
                                                     axis=-1),
            checkpoint=mode, schedule=sched, skip_lanes=lanes,
            remat_policy=(jax.checkpoint_policies.dots_saveable if policy
                          else None), **kw)


def jax_overlapped_step(case, params, x, tgt):
    """``pipe_tpu``'s overlapped step: ``(loss, [per virtual stage {w, b}
    gradient])`` as numpy."""
    _, _, d, m, _, _, v, _, _ = case
    pipe = jax_pipeline(case, overlap_transport=True)
    stacked = (stack_interleaved_params(params, d) if v > 1
               else stack_stage_params(params))
    w = jnp.ones(x.shape[:2], jnp.float32)
    xs = {"x": jnp.asarray(x), "tgt": jnp.asarray(tgt)}
    loss, (gs, _, _) = jax.jit(lambda sp, xx, ww: pipe.loss_and_grad(
        sp, {}, {}, xx, ww, key=jax.random.key(9)))(stacked, xs, w)
    gs = jax.tree_util.tree_map(np.asarray, gs)
    per = (unstack_interleaved_params(gs, d) if v > 1
           else [jax.tree_util.tree_map(lambda a: a[s], gs)
                 for s in range(d)])
    return float(loss), per


def _bitwise(a, b):
    assert a[0] == b[0]
    assert sorted(a[1]) == sorted(b[1])
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k], err_msg=k)


# --- one device ---------------------------------------------------------------

@pytest.mark.parametrize("case", TRANSPARENCY_CASES,
                         ids=[c[0] for c in TRANSPARENCY_CASES])
def test_one_device_walks_are_the_serialized_walk(case):
    """Overlapped and phase-compiled walks on one device (the shifted and
    aligned tables with their parks, as ``pipe_tpu``'s forced CPU mesh runs
    them), bit for bit the serialized walk; each memory plan equal to
    ``pipe_tpu``'s for the same case and transport."""
    params, x, tgt = make_inputs(case)
    m = case[3]
    base = None
    for overlap, phase in cases.TRANSPORTS:
        pipe, _ = cases.toy_pipeline(case, params, overlap=overlap,
                                     phase=phase)
        got = cases.toy_step(pipe, x, tgt)
        if base is None:
            base = got
        _bitwise(got, base)
        jplan = jax_pipeline(case, overlap_transport=overlap,
                             phase_compile=phase).memory_plan(m)
        assert pipe.memory_plan(m) == jplan
    assert pipe.memory_plan(m)["transport"] == "phase-compiled"


def test_auto_rule_is_pipe_tpus():
    """``None``: on for a mesh of CUDA ranks of more than one stage, off
    without a mesh (a CPU mesh's auto-off is held in the world below) and
    at one stage, where ``True`` is off too; ``True`` walks the shifted
    tables on one device."""
    case = BY_ID["1f1b-never"]
    params, _, _ = make_inputs(case)
    card = types.SimpleNamespace(n_stages=4, device=torch.device("cuda"))
    plain, _ = cases.toy_pipeline(case, params)
    on_card, _ = cases.toy_pipeline(case, params, mesh=card)
    forced, _ = cases.toy_pipeline(case, params, overlap=True)
    off, _ = cases.toy_pipeline(case, params, mesh=card, overlap=False,
                                phase=False)
    assert (plain._overlap_enabled(), plain._phase_program(8)) == (False,
                                                                   None)
    assert on_card._overlap_enabled()
    assert on_card.memory_plan(8)["transport"] == "phase-compiled"
    assert forced.memory_plan(8)["transport"] == "overlapped"
    assert off.memory_plan(8)["transport"] == "serialized"
    one = ("one", "1f1b", 1, 4, "never", (), 1, 1, False)
    single, _ = cases.toy_pipeline(one, make_inputs(one)[0], overlap=True,
                                   phase=True)
    assert not single._overlap_enabled() and single._phase_program(4) is None
    assert single.memory_plan(4)["transport"] == "serialized"


@pytest.mark.parametrize("schedule,d,m,v", [
    ("gpipe", 4, 8, 1), ("1f1b", 4, 8, 1), ("zb-h1", 4, 8, 1),
    ("interleaved-1f1b", 4, 8, 2), ("interleaved-1f1b", 2, 16, 2)])
def test_phase_verdicts_are_pipe_tpus(schedule, d, m, v):
    """The compiler's verdict per table: accepted or not, its reason, the
    program's segments and cycles, as ``pipe_tpu``'s executor holds it."""
    case = ("v", schedule, d, m, "never", (), v, 1, False)
    pipe, _ = cases.toy_pipeline(case, make_inputs(case)[0], phase=True)
    jpipe = jax_pipeline(case, phase_compile=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the rejected table's
        got, want = pipe._phase_verdict(m), jpipe._phase_verdict(m)
    assert (got.accepted, got.reason) == (want.accepted, want.reason)
    if want.accepted:
        def segs(prog):
            return [(g.kind, g.t0, g.t1, g.period, tuple(g.codes))
                    for g in prog.segments]
        assert segs(got.program) == segs(want.program)
        np.testing.assert_array_equal(got.program.op, want.program.op)


def test_rejected_table_warns_counts_and_trains():
    """``phase_compile=True`` on a table the compiler rejects (interleaved
    v2 at d 2, m 16): ``pipe_tpu``'s warning naming the reason, the
    ``scheduled.phase.rejected`` counter, the active gauge 0, and a step bit
    for bit the interpreted walk's."""
    case = ("rej", "interleaved-1f1b", 2, 16, "never", (), 2, 1, False)
    params, x, tgt = make_inputs(case)
    reg = MetricsRegistry(enabled=True)
    prev = set_registry(reg)
    try:
        pipe, _ = cases.toy_pipeline(case, params, phase=True)
        with pytest.warns(UserWarning, match="rejected"):
            got = cases.toy_step(pipe, x, tgt)
        assert reg.counter("scheduled.phase.rejected").value >= 1
        assert reg.gauge("scheduled.phase.active").value == 0
    finally:
        set_registry(prev)
    ref, _ = cases.toy_pipeline(case, params, phase=False)
    _bitwise(got, cases.toy_step(ref, x, tgt))


def test_accepted_table_counts_and_gauges():
    case = BY_ID["1f1b-never"]
    params, x, tgt = make_inputs(case)
    reg = MetricsRegistry(enabled=True)
    prev = set_registry(reg)
    try:
        pipe, _ = cases.toy_pipeline(case, params, phase=True)
        cases.toy_step(pipe, x, tgt)
        plan = pipe.memory_plan(8)
        assert reg.counter("scheduled.phase.compiled").value >= 1
        assert reg.gauge("scheduled.phase.active").value == 1
        assert reg.gauge("scheduled.transport.overlap").value == 1
        assert reg.gauge("scheduled.phase.scan_cycles").value == \
            plan["phase_scan_cycles"] > 0
        assert plan["phase_unrolled_cycles"] + plan["phase_scan_cycles"] \
            == pipe._phase_program(8).cycles == plan["cycles"]
        assert reg.gauge("scheduled.cycles").value == plan["cycles"]
    finally:
        set_registry(prev)


# --- a world of 4 CPU ranks ---------------------------------------------------

@pytest.fixture(scope="module")
def world():
    with World(4, device="cpu", threads=1, timeout=300.0) as w:
        yield w


@pytest.mark.parametrize("case", WORLD_CASES, ids=[c[0] for c in WORLD_CASES])
def test_world_walks_match_serialized_and_pipe_tpu(world, case):
    params, x, tgt = make_inputs(case)
    _, _, d, m, _, _, v, data, _ = case
    ranks = world.run(cases.world_transports, case, params, x, tgt)
    jloss, jgrads = jax_overlapped_step(case, params, x, tgt)
    jplans = [jax_pipeline(case, overlap_transport=o,
                           phase_compile=p).memory_plan(m)
              for o, p in cases.TRANSPORTS]
    for r in ranks:
        base = r["runs"][0]
        assert not r["auto"][0] and not r["auto"][1]   # CPU ranks: auto off
        for run, jplan in zip(r["runs"], jplans):
            for step in (0, 1):
                _bitwise(run["steps"][step], base["steps"][step])
            assert run["plan"] == jplan
        overlapped = r["runs"][1]
        assert overlapped["wait_s"] > 0 and base["wait_s"] == 0.0
        loss, grads = base["steps"][0]
        assert loss == pytest.approx(jloss, rel=TOL_JAX)
        stages = [g * d + r["stage"] for g in range(v)]
        assert sorted(grads) == sorted(f"stages.{s}.{n}" for s in stages
                                       for n in ("w", "b"))
        for s in stages:
            for n in ("w", "b"):
                want = jgrads[s][n]
                err = np.abs(grads[f"stages.{s}.{n}"] - want).max()
                assert err <= TOL_JAX * max(1.0, np.abs(want).max()), (s, n)


def test_world_pipe_phase_compile_is_bitwise(world):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, WIDTH)).astype(np.float32)
    y = rng.standard_normal((16, WIDTH)).astype(np.float32)
    for (lp, gp, tp), (li, gi, ti) in world.run(cases.pipe_phase, x, y):
        assert (tp, ti) == ("phase-compiled", "serialized")
        _bitwise((lp, gp), (li, gi))


def test_world_carve_gives_working_meshes(world):
    """Each rank's own replica is a working mesh (its world and stage
    groups sum its replica's ranks), the others ``RemoteMesh`` records, and
    the grids are ``pipe_tpu``'s carve of 4 devices."""
    devices = jax.devices()[:4]
    ids = np.vectorize(lambda dev: dev.id)
    from pipe_tpu.fleet import topology as jtopo
    want = [[ids(m.devices).tolist() for m in jtopo.carve_replica_meshes(
                2, 2, devices=devices)],
            [ids(m.devices).tolist() for m in jtopo.carve_role_meshes(
                [("prefill", 1, 2), ("decode", 2, 1)], devices=devices)]]
    for rank, carves in enumerate(world.run(cases.carve)):
        for got, grids in zip(carves, want):
            assert got["grids"] == grids
            (k,) = got["own"]
            assert got["remote"] == [j != k for j in range(len(grids))]
            grid = np.asarray(grids[k])
            assert rank in grid
            assert got["world_sum"] == float(grid.sum())
            col = [c for c in range(grid.shape[1]) if rank in grid[:, c]][0]
            assert got["stage_sum"] == float(grid[:, col].sum())
            assert got["shape"] == grid.shape
