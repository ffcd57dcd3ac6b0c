"""pipe_tpu_torch's core/schedule.py against pipe_tpu's: every registered
schedule's op tables, slot counts, cycles and bubble, the comm-shifted
tables, the phase compiler's segments and the elastic re-plan, as integers
equal at every geometry the JAX schedule tests use; each verifier raises the
same exception type on the same corrupted table. Numpy only on both sides.
"""

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core import schedule as jsched
from pipe_tpu.obs import zb_model as jzb
from pipe_tpu_torch.core import schedule as tsched
from pipe_tpu_torch.core import memplan as tmem
from pipe_tpu_torch.obs import zb_model as tzb

# (m, n): tests/test_schedule.py, test_scheduled.py and test_zb_tables.py
GEOMS = sorted({(m, n) for m in (1, 2, 5, 8) for n in (1, 2, 4)}
               | {(4, 2), (8, 4), (4, 4), (16, 4), (2, 4), (8, 8), (4, 1),
                  (3, 3), (1, 2), (8, 1), (16, 8), (8, 2), (12, 6), (3, 2)})
# (m, d, v): tests/test_interleaved.py (d, v, chunks) and its m=8, d=4
INTERLEAVED = [(4, 2, 2), (2, 2, 3), (4, 4, 2), (2, 1, 4), (8, 8, 1),
               (8, 4, 2), (2, 4, 2)]
NAMES = ["gpipe", "1f1b", "interleaved", "interleaved-1f1b", "zb-h1", "zb-h2"]


def _outcome(fn):
    """``("ok", value)`` or ``("raise", exception type name)``."""
    try:
        return "ok", fn()
    except Exception as e:             # the type is what is compared
        return "raise", type(e).__name__


def _same(a, b):
    assert a[0] == b[0], (a, b)
    if a[0] == "raise":
        assert a[1] == b[1]
        return
    va, vb = a[1], b[1]
    if isinstance(va, tuple) and va and isinstance(va[0], np.ndarray):
        assert len(va) == len(vb)
        for x, y in zip(va, vb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    else:
        assert va == vb


def _schedules(name, v=None):
    kw = {}
    if v is not None:
        kw = {"interleave": v} if name == "interleaved-1f1b" else {"v": v}
    return tsched.get_schedule(name, **kw), jsched.get_schedule(name, **kw)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("m,n", GEOMS)
def test_tables_slots_and_cycles_equal(name, m, n):
    t, j = _schedules(name)
    for fn in ("op_tables", "stash_slots", "wstash_slots", "cycles",
               "num_cycles", "bubble"):
        _same(_outcome(lambda: getattr(t, fn)(m, n)),
              _outcome(lambda: getattr(j, fn)(m, n)))
    assert t.splits_backward == j.splits_backward and t.v == j.v
    assert t.name == j.name


@pytest.mark.parametrize("m,d,v", INTERLEAVED)
def test_interleaved_tables_equal(m, d, v):
    for name in ("interleaved", "interleaved-1f1b"):
        t, j = _schedules(name, v)
        for fn in ("op_tables", "stash_slots", "wstash_slots", "num_cycles",
                   "bubble", "cycles"):
            _same(_outcome(lambda: getattr(t, fn)(m, d)),
                  _outcome(lambda: getattr(j, fn)(m, d)))
    t, j = _schedules("interleaved", v)
    assert t.device_bubble(m, d) == j.device_bubble(m, d)
    assert t.virtual_stages(d) == j.virtual_stages(d)


def test_table_only_schedules_refuse_cycles_with_pipe_tpus_message():
    for name in ("interleaved-1f1b", "zb-h1", "zb-h2"):
        with pytest.raises(NotImplementedError) as terr:
            tsched.get_schedule(name).cycles(4, 2)
        with pytest.raises(NotImplementedError) as jerr:
            jsched.get_schedule(name).cycles(4, 2)
        assert str(terr.value) == str(jerr.value)


def test_get_schedule_registry_matches():
    assert sorted(tsched._SCHEDULES) == sorted(jsched._SCHEDULES) == \
        sorted(NAMES)
    with pytest.raises(ValueError) as terr:
        tsched.get_schedule("nope")
    with pytest.raises(ValueError) as jerr:
        jsched.get_schedule("nope")
    assert str(terr.value) == str(jerr.value)


def _tables(mod, name, m, n, v=None):
    kw = {} if v is None else {"interleave": v}
    tables = mod.get_schedule(name, **kw).op_tables(m, n)
    return tables if len(tables) == 3 else (*tables, None)


@pytest.mark.parametrize("name,m,n,v", [
    ("gpipe", 4, 2, None), ("1f1b", 8, 4, None), ("1f1b", 2, 4, None),
    ("zb-h1", 8, 4, None), ("zb-h2", 16, 4, None), ("zb-h1", 12, 6, None),
    ("interleaved-1f1b", 8, 4, 2), ("interleaved-1f1b", 4, 2, 2)])
def test_shifted_tables_and_phase_segments_equal(name, m, n, v):
    vv = v or 1
    got, want = {}, {}
    for mod, out in ((tsched, got), (jsched, want)):
        op, mbi, grp = _tables(mod, name, m, n, v)
        out["shift"] = mod.shift_comm_tables(op, mbi, grp, m=m, d=n, v=vv)
        verdict = mod.compile_phases(op, mbi, grp, m=m, d=n, v=vv)
        out["accepted"] = verdict.accepted
        out["reason"] = verdict.reason
        if verdict.accepted:
            prog = verdict.program
            out["program"] = (prog.op, prog.mbi, prog.grp)
            out["segments"] = [dataclass_tuple(s) for s in prog.segments]
            out["policy"] = (prog.policy, prog.cycle_codes, prog.dense,
                             prog.unrolled_cycles, prog.scan_cycles)
        shifted = out["shift"]
        mod.verify_shifted_op_tables(
            *shifted[:2], shifted[2] if v else None, m=m, d=n, v=vv,
            splits_backward=mod.get_schedule(name).splits_backward)
    assert got.keys() == want.keys()
    for k in got:
        a, b = got[k], want[k]
        if isinstance(a, tuple) and isinstance(a[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a == b, k


def dataclass_tuple(seg):
    return (seg.kind, seg.t0, seg.t1, seg.period, seg.codes, seg.cycles,
            seg.iters)


@pytest.mark.parametrize("m,n", [(8, 4), (16, 4), (12, 6)])
def test_zb_capacities_and_verifier_agree(m, n):
    for name in ("zb-h1", "zb-h2"):
        op, mbi = tsched.get_schedule(name).op_tables(m, n)
        assert tsched.zb_joint_capacity(op, mbi, m, n) == \
            jsched.zb_joint_capacity(op, mbi, m, n)
        t, j = _schedules(name)
        tsched.verify_op_tables(op, mbi, m, n,
                                stash_slots=t.stash_slots(m, n),
                                wstash_slots=t.wstash_slots(m, n))
    times = (op[:, 0] == tsched.FWD).nonzero()[0]
    assert tsched.overlap_fifo_capacity(times, times + 3) == \
        jsched.overlap_fifo_capacity(times, times + 3)


def _corruptions(m=8, n=4):
    """(verifier name, args, kwargs) on tables broken in known ways."""
    gp, gm = tsched.get_schedule("gpipe").op_tables(m, n)
    zp, zm = tsched.get_schedule("zb-h1").op_tables(m, n)
    ip, im, ig = tsched.get_schedule("interleaved-1f1b").op_tables(m, n)
    swapped = gp.copy()
    t_b = np.argwhere(gp[:, n - 1] == tsched.BWD)[0, 0]
    swapped[[0, t_b], n - 1] = swapped[[t_b, 0], n - 1]
    dropped_w = zp.copy()
    dropped_w[np.argwhere(zp == tsched.WGRAD)[0][0],
              np.argwhere(zp == tsched.WGRAD)[0][1]] = tsched.IDLE
    moved = ig.copy()
    moved[np.argwhere(ip == tsched.BWD)[0][0],
          np.argwhere(ip == tsched.BWD)[0][1]] ^= 1
    return [
        ("verify_op_tables", (gp, gm, m, n), {"stash_slots": 2}),
        ("verify_op_tables", (swapped, gm, m, n), {}),
        ("verify_op_tables", (dropped_w, zm, m, n), {}),
        ("verify_zb_op_tables", (zp, zm, m, n), {"stash_slots": 1}),
        ("verify_zb_op_tables", (zp, zm, m, n),
         {"stash_slots": 5, "wstash_slots": 0}),
        ("verify_op_tables", (gp, gm, m, n), {"comm_shift": 2}),
        ("verify_interleaved_op_tables", (ip, im, moved, m, n, 2), {}),
        ("verify_shifted_op_tables", (zp, zm), {"m": m, "d": n,
                                                "splits_backward": True}),
    ]


@pytest.mark.parametrize("case", range(8))
def test_verifiers_raise_the_same_type_on_corrupted_tables(case):
    fn, args, kw = _corruptions()[case]
    with pytest.raises(Exception) as terr:
        getattr(tsched, fn)(*args, **kw)
    with pytest.raises(Exception) as jerr:
        getattr(jsched, fn)(*args, **kw)
    assert terr.type is AssertionError and jerr.type is AssertionError
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("schedule,n,lost", [("1f1b", 4, 1), ("zb-h1", 4, 0),
                                             ("gpipe", 3, 2)])
def test_replan_stage_loss_matches(schedule, n, lost):
    t = tsched.replan_stage_loss(8, n, lost, schedule=schedule,
                                 balance=[2] * n)
    j = jsched.replan_stage_loss(8, n, lost, schedule=schedule,
                                 balance=[2] * n)
    assert (t.n_stages, t.balance) == (j.n_stages, j.balance)
    np.testing.assert_array_equal(t.op, j.op)
    np.testing.assert_array_equal(t.mbi, j.mbi)
    assert (t.phase.accepted, t.phase.reason) == \
        (j.phase.accepted, j.phase.reason)
    for bad in ((8, 1, 0), (8, 3, 3)):
        with pytest.raises(ValueError):
            tsched.replan_stage_loss(*bad)
    with pytest.raises(ValueError):
        tsched.replan_stage_loss(8, 3, 0, schedule="interleaved-1f1b")


@pytest.mark.parametrize("checkpoint", ["always", "except_last", "never"])
@pytest.mark.parametrize("v,split,overlap", [(1, False, False),
                                             (2, True, True)])
def test_memplan_matches(checkpoint, v, split, overlap):
    from pipe_tpu.core import memplan as jmem
    kw = dict(v=v, stash_slots=3, wstash_slots=2, checkpoint=checkpoint,
              has_remat_policy=split, split_stage=split, overlap=overlap,
              grad_park_slots=1)
    tp = tmem.activation_slot_plan(tmem.MemoryPlanInputs(**kw))
    assert tp == jmem.activation_slot_plan(jmem.MemoryPlanInputs(**kw))
    assert tmem.estimate_memory(tp, act_bytes=7, param_bytes=11) == \
        jmem.estimate_memory(tp, act_bytes=7, param_bytes=11)
    with pytest.raises(ValueError):
        tmem.MemoryPlanInputs(v=1, stash_slots=1, checkpoint="sometimes")


@pytest.mark.parametrize("m,n", [(4, 2), (8, 4), (16, 4)])
def test_zb_model_matches(m, n):
    assert tzb.analytic_bubbles(m, n) == jzb.analytic_bubbles(m, n)
    for sigma in (1.0, 1.41, 2.0):
        assert tzb.crossover(m, n, sigma) == jzb.crossover(m, n, sigma)
    costs = dict(f=1.0, sigma=1.3, o=0.1)
    for mode in ("serialized", "parallel"):
        assert tzb.predict(m, n, tzb.OpCosts(**costs), mode) == \
            jzb.predict(m, n, jzb.OpCosts(**costs), mode)
