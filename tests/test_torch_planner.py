"""pipe_tpu_torch's balance and planner (``core/balance.py``,
``core/planner.py``) against pipe_tpu's: the bottleneck split (a known
optimum and brute force), the profilers, ``stage_costs``/``balance_cost``,
``predict_wall``, ``search`` ranking the same plans JSON for JSON over
uniform and heterogeneous profiles, the calibration refusal, the ``Plan``
JSON, and the front doors: ``Pipe(plan=...)`` and ``Trainer(plan=...)``
resolve as pipe_tpu's do, with the same conflict errors, and ``"auto"``
prices ``serialized`` on one device (ROADMAP.md C.9), which pipe_tpu also
picks on the CPU, so the plans are equal there.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core import balance as jbal
from pipe_tpu.core import planner as jplan
from pipe_tpu.core.schedule import get_schedule as jget_schedule
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.ops import layers as jl
from pipe_tpu.train import loop as jloop
from pipe_tpu_torch import Pipe
from pipe_tpu_torch.core import balance as tbal
from pipe_tpu_torch.core import planner as tplan
from pipe_tpu_torch.core.partition import BalanceError
from pipe_tpu_torch.core.schedule import get_schedule
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.ops.layers import Lambda, Linear, Sequential
from pipe_tpu_torch.train import loop as tloop

ALL_SCHEDULES = ("gpipe", "1f1b", "interleaved-1f1b", "zb-h1", "zb-h2")


# --- balance -----------------------------------------------------------------

def test_bottleneck_split_known_optimum():
    for costs, n in (([1, 1, 8, 1, 1], 2), ([1] * 8, 4), ([100, 1, 1, 1], 2)):
        assert tbal._bottleneck_split(costs, n) == \
            jbal._bottleneck_split(costs, n)
    assert tbal._bottleneck_split([100, 1, 1, 1], 2) == [1, 3]
    with pytest.raises(BalanceError):
        tbal._bottleneck_split([1.0], 2)


@pytest.mark.parametrize("seed", range(4))
def test_bottleneck_split_is_optimal_vs_bruteforce(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        costs = rng.uniform(0.1, 10, size=7).tolist()
        got = tbal._bottleneck_split(costs, 3)
        assert got == jbal._bottleneck_split(costs, 3)
        best = min(tbal.balance_cost([i, j, 7 - i - j], costs)
                   for i in range(1, 6) for j in range(1, 7 - i))
        assert tbal.balance_cost(got, costs) == pytest.approx(best, rel=1e-9)


def test_stage_costs_and_balance_cost_match_pipe_tpu():
    costs = [1.0, 2.0, 3.0, 4.0, 0.5]
    for bal in ([1, 4], [2, 2, 1], [5]):
        assert tbal.stage_costs(bal, costs) == jbal.stage_costs(bal, costs)
        assert tbal.balance_cost(bal, costs) == jbal.balance_cost(bal, costs)
        assert tbal.balance_cost(bal, costs, per_stage=True) == \
            jbal.balance_cost(bal, costs, per_stage=True)
    with pytest.raises(BalanceError):
        tbal.stage_costs([1, 1], costs)


def _big_small():
    t = Sequential([Linear(256, 256, device="cpu"), Lambda(torch.relu),
                    Linear(256, 8, device="cpu"), Lambda(torch.relu),
                    Linear(8, 8, device="cpu")])
    import jax
    j = jl.Sequential([jl.Linear(256), jl.Lambda(jax.nn.relu), jl.Linear(8),
                       jl.Lambda(jax.nn.relu), jl.Linear(8)])
    return t, j


def test_profile_sizes_equal_pipe_tpus():
    import jax
    import jax.numpy as jnp

    t, j = _big_small()
    x = np.zeros((16, 256), np.float32)
    want = jbal.profile_sizes(j, j.init(jax.random.key(0), jnp.asarray(x)),
                              jnp.asarray(x))
    assert tbal.profile_sizes(t, torch.from_numpy(x)) == want
    assert tbal.balance_by_size(2, t, torch.from_numpy(x)) == \
        jbal._bottleneck_split(want, 2)


def test_profile_times_orders_layers_and_drives_pipe():
    t, _ = _big_small()
    x = torch.zeros(64, 256)
    fwd = tbal.profile_times(t, x, backward=False, repeat=3)
    tot = tbal.profile_times(t, x, backward=True, repeat=3)
    assert len(fwd) == len(tot) == 5 and all(v > 0 for v in fwd + tot)
    assert tot[0] > tot[4]          # 256x256 with grads vs 8x8
    bal = tbal.balance_by_time(2, t, x, backward=False, repeat=1)
    assert sum(bal) == 5 and len(bal) == 2 and min(bal) > 0
    pipe = Pipe(t, chunks=2, balance=bal, device="cpu")
    assert pipe(x).shape == (64, 8)


def test_profile_times_is_the_median_after_warmup(monkeypatch):
    """The first call and ``warmup`` timed calls are dropped; the figure is
    the median of the rest (a fake clock feeds the samples)."""
    clock = iter([0.0, 50.0,            # warm-up sample, discarded
                  50.0, 51.0, 51.0, 54.0, 54.0, 54.5])
    monkeypatch.setattr(tbal.time, "perf_counter", lambda: next(clock))
    seq = Sequential([Linear(4, 4, device="cpu")])
    assert tbal.profile_times(seq, torch.zeros(2, 4), backward=False,
                              repeat=3, warmup=1) == [1.0]


# --- the wall model and the search -----------------------------------------

@pytest.mark.parametrize("name", ["gpipe", "1f1b", "zb-h1", "zb-h2"])
@pytest.mark.parametrize("mode", ["serialized", "parallel"])
def test_predict_wall_matches_pipe_tpu(name, mode):
    rng = np.random.default_rng(len(name))
    m, n = 8, 4
    op = get_schedule(name).op_tables(m, n)[0]
    assert np.array_equal(op, jget_schedule(name).op_tables(m, n)[0])
    f, b = rng.uniform(0.5, 2, n).tolist(), rng.uniform(1, 4, n).tolist()
    for recompute in (False, True):
        kw = dict(d=n, sigma=1.3, o=0.05, mode=mode, recompute=recompute)
        assert tplan.predict_wall(op, None, f, b, **kw) == \
            jplan.predict_wall(op, None, f, b, **kw)


def _json(plans):
    return [p.to_json() for p in plans]


_SEARCHES = [
    dict(n_devices=4, m_candidates=(2, 4, 8)),
    dict(n_devices=4, m_candidates=(2, 4, 8), checkpoint="except_last"),
    dict(n_devices=2, m_candidates=(2, 4, 8, 16), batch_rows=16,
         max_plans=32),
    dict(n_devices=4, m_candidates=(4, 8), memory_cap_bytes=20_000,
         max_plans=32),
    dict(n_devices=2, m_candidates=(4,), uniform_only=True,
         interleave_candidates=(2, 4)),
]


@pytest.mark.parametrize("case", range(len(_SEARCHES)))
@pytest.mark.parametrize("mode", ["parallel", "serialized"])
def test_search_over_uniform_profile_ranks_pipe_tpus_plans(case, mode):
    kw = dict(_SEARCHES[case], schedules=ALL_SCHEDULES)
    prof = dict(rows=4, f=1.0, layer_param_bytes=1000, layer_act_bytes=500,
                mode=mode)
    got = tplan.search(tplan.uniform_profile(8, **prof), **kw)
    want = jplan.search(jplan.uniform_profile(8, **prof), **kw)
    assert got and _json(got) == _json(want)


_HETERO = dict(layer_fwd_s=(1.0, 0.5, 3.0, 0.7, 1.2, 2.2, 0.4, 0.9),
               layer_bwd_s=(2.1, 1.0, 5.5, 1.3, 2.4, 4.0, 0.9, 1.7),
               layer_param_bytes=(4000, 100, 9000, 100, 2500, 6000, 50, 800),
               layer_act_bytes=(512, 512, 2048, 256, 512, 1024, 128, 512),
               rows=8, sigma=1.2, sigma_fused_split=2.0, o=0.03,
               rel_residual=0.1, source="fixed")


@pytest.mark.parametrize("mode", ["parallel", "serialized"])
@pytest.mark.parametrize("checkpoint", ["never", "always"])
def test_search_over_heterogeneous_profile_ranks_pipe_tpus_plans(mode,
                                                                 checkpoint):
    kw = dict(n_devices=2, m_candidates=(2, 4, 8), batch_rows=32,
              schedules=ALL_SCHEDULES, checkpoint=checkpoint, max_plans=16)
    got = tplan.search(tplan.CostProfile(mode=mode, **_HETERO), **kw)
    want = jplan.search(jplan.CostProfile(mode=mode, **_HETERO), **kw)
    assert len({p.balance for p in got}) > 1     # the cuts differ
    assert _json(got) == _json(want)


def test_profile_from_calibration_matches_pipe_tpu():
    calib = {"n": 4, "widths": [8, 16], "f_per_width": [0.01, 0.02],
             "op_costs_per_width": [{"f": 0.01, "sigma": 1.3, "o": 0.001},
                                    {"f": 0.02, "sigma": 1.25,
                                     "o": -0.002}],
             "rel_residual": 0.05, "rel_residual_per_width": [0.05, 0.04]}
    for width in (None, 8):
        kw = dict(n_layers=8, rows=4, layer_param_bytes=100,
                  layer_act_bytes=[10] * 8, width=width)
        assert tplan.profile_from_calibration(calib, **kw).to_json() == \
            jplan.profile_from_calibration(calib, **kw).to_json()


def test_calibration_refused_over_residual_threshold():
    kw = dict(layer_fwd_s=(1.0,) * 4, layer_bwd_s=(2.0,) * 4,
              layer_param_bytes=(0,) * 4, layer_act_bytes=(0,) * 4)
    with pytest.warns(UserWarning, match="REFUSING"):
        with pytest.raises(tplan.CalibrationError):
            tplan.CostProfile(rel_residual=0.30, **kw)
    assert tplan.MAX_REL_RESIDUAL == jplan.MAX_REL_RESIDUAL
    assert tplan.CostProfile(rel_residual=0.06, **kw).n_layers == 4
    with pytest.raises(ValueError, match="layer_bwd_s"):
        tplan.CostProfile(**dict(kw, layer_bwd_s=(1.0,)))
    prof = tplan.CostProfile(**kw)
    assert tplan.CostProfile.from_json(prof.to_json()) == prof
    assert json.loads(prof.to_json()) == json.loads(
        jplan.CostProfile(**kw).to_json())


def test_plan_json_roundtrips_between_the_packages(tmp_path):
    prof = tplan.uniform_profile(8, rows=4, layer_param_bytes=1000,
                                 layer_act_bytes=500)
    top = tplan.search(prof, n_devices=4, m_candidates=(2, 4, 8),
                       schedules=ALL_SCHEDULES)[0]
    assert tplan.Plan.from_json(top.to_json()) == top
    path = tmp_path / "plan.json"
    top.save(str(path))
    assert tplan.Plan.load(str(path)) == top
    assert jplan.Plan.load(str(path)).to_json() == top.to_json()
    assert json.loads(top.to_json())["runners_up"]
    with pytest.raises(ValueError, match="version"):
        tplan.Plan.from_json(json.dumps(dict(json.loads(top.to_json()),
                                             version=2)))


@pytest.mark.parametrize("args", [(0.6, 0.2, 4, 1.0), (0.0, 0.1, 2, 1.5),
                                  (1.0, 0.0, 8, 4.0)])
def test_spec_cost_model_matches_pipe_tpu(args):
    assert tplan.spec_speedup(*args) == jplan.spec_speedup(*args)
    assert tplan.spec_breakeven_acceptance(*args[1:]) == \
        jplan.spec_breakeven_acceptance(*args[1:])
    with pytest.raises(ValueError):
        tplan.spec_speedup(0.5, 0.2, 1)


# --- front doors -------------------------------------------------------------

def _plan_4x2(schedule="1f1b", checkpoint="never"):
    prof = tplan.uniform_profile(4, rows=4, f=1.0, layer_param_bytes=256,
                                 layer_act_bytes=32)
    return tplan.search(prof, n_devices=2, m_candidates=(4,),
                        schedules=(schedule,), checkpoint=checkpoint)[0]


def _seq(width=8, n=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return Sequential([Linear(width, width, device="cpu", generator=g)
                       for _ in range(n)])


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipe_plan_reproduces_the_hand_config_bitwise(schedule, tmp_path):
    top = _plan_4x2(schedule, "except_last")
    assert not top.split_stage
    path = tmp_path / "p.json"
    top.save(str(path))
    x = torch.randn(8, 8, generator=torch.Generator().manual_seed(1))
    results = []
    for kw in ({"plan": top}, {"plan": str(path)},
               {"chunks": top.m, "checkpoint": top.checkpoint,
                "schedule": top.schedule_obj(),
                "balance": list(top.balance)}):
        pipe = Pipe(_seq(), device="cpu", **kw)
        assert (pipe.chunks, pipe.checkpoint, pipe.balance) == \
            (top.m, top.checkpoint, list(top.balance))
        loss = pipe(x, train=True).square().mean()
        loss.backward()
        results.append((loss.detach(), [p.grad for p in pipe.parameters()]))
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, results[0][1]))


def test_pipe_plan_resolves_as_pipe_tpus():
    import pipe_tpu

    top = _plan_4x2("1f1b", "except_last")
    jtop = jplan.Plan.from_json(top.to_json())
    jpipe = pipe_tpu.Pipe(jl.Sequential([jl.Linear(8) for _ in range(4)]),
                          plan=jtop)
    tpipe = Pipe(_seq(), plan=top, device="cpu")
    assert (tpipe.chunks, tpipe.checkpoint, tpipe.balance,
            tpipe.n_stages, tpipe._schedule.name) == \
        (jpipe.chunks, jpipe.checkpoint, jpipe.balance, jpipe.n_stages,
         jpipe._schedule.name)


@pytest.mark.parametrize("kwargs", [{"chunks": 2}, {"balance": [2, 2]},
                                    {"n_stages": 2}, {"schedule": "1f1b"},
                                    {"checkpoint": "always"}])
def test_pipe_plan_conflicts_rejected_as_pipe_tpu(kwargs):
    import pipe_tpu

    top = _plan_4x2("1f1b", "never")
    with pytest.raises(ValueError) as jerr:
        pipe_tpu.Pipe(jl.Sequential([jl.Linear(8) for _ in range(4)]),
                      plan=jplan.Plan.from_json(top.to_json()), **kwargs)
    with pytest.raises(ValueError) as terr:
        Pipe(_seq(), plan=top, device="cpu", **kwargs)
    assert str(terr.value) == str(jerr.value)


def test_pipe_refuses_a_split_stage_plan_naming_a8():
    """A plan prescribing the structural split (A.8's first item, now
    ported): ``Pipe`` no longer refuses it but warns with ``pipe_tpu``'s
    words, and trains its zb-h1 tables (the stored-graph split) to the
    plain backward's gradients."""
    import pipe_tpu

    from pipe_tpu_torch.parallel.hetero_scheduled import (
        HeteroScheduledPipeline)

    top = _plan_4x2("zb-h1", "never")
    assert top.split_stage
    with pytest.warns(UserWarning) as jwarn:
        pipe_tpu.Pipe(jl.Sequential([jl.Linear(8) for _ in range(4)]),
                      plan=jplan.Plan.from_json(top.to_json()))
    with pytest.warns(UserWarning) as twarn:
        pipe = Pipe(_seq(), plan=top, device="cpu")
    assert [str(w.message) for w in twarn] == \
        [str(w.message) for w in jwarn]
    assert "structural B/W split" in str(twarn[0].message)
    x = torch.randn(8, 8, generator=torch.Generator().manual_seed(1))
    ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout, top.m,
                                 top.checkpoint, top.schedule_obj(),
                                 device="cpu")
    loss, grads = ex.loss_and_grad(x, loss_fn=lambda y: y.square().mean(1))
    grads = [g.clone() for g in grads.values()]
    pipe.zero_grad(set_to_none=True)
    want = pipe.partitions[1](pipe.partitions[0](x)).square().mean()
    want.backward()
    assert loss.item() == pytest.approx(want.item(), rel=1e-6)
    for g, p in zip(grads, pipe.parameters()):
        torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-7)


def test_profile_model_and_auto_plan_feed_pipe():
    seq = _seq(width=16, n=6)
    x = torch.randn(4, 16)
    prof = tplan.profile_model(seq, x, repeat=2)
    assert prof.n_layers == 6 and prof.rows == 4 and prof.mode == "serialized"
    assert prof.layer_param_bytes == (16 * 17 * 4,) * 6
    assert prof.layer_act_bytes == (4 * 16 * 4,) * 6
    assert all(b >= f > 0 for f, b in zip(prof.layer_fwd_s,
                                          prof.layer_bwd_s))
    # fit_m=(): the per-layer profile alone (a CPU host's timings of so
    # small a model are too noisy for the step fit, tested below)
    plan = tplan.auto_plan(seq, x, n_devices=2, m_candidates=(2, 4),
                           batch_rows=8, schedules=("gpipe", "1f1b"),
                           checkpoint="except_last", fit_m=())
    assert plan.profile_source == "profile_model" and plan.runners_up
    pipe = Pipe(seq, plan=plan, device="cpu")
    assert pipe(torch.randn(8, 16)).shape == (8, 16)


def _stub_walls(monkeypatch, walls):
    """Time the fit's steps by ``walls`` (one a point, in the order of m; a
    point may be a list, one wall a round), running each step as the real
    timer does; the fit times its m points round robin, so ``ran`` lists
    the chunks of every timed step in turn."""
    ms = []
    ran = []
    real = tbal._time_once

    def timed(fn, device):
        if not isinstance((fn.__defaults__ or (None,))[0], Pipe):
            return real(fn, device)                    # a layer's profile
        fn()
        m = fn.__defaults__[0].chunks
        ran.append(m)
        if m not in ms:
            ms.append(m)
        w = walls[sorted(ms).index(m)] if len(ms) == len(walls) \
            else walls[len(ms) - 1]
        return w[ran.count(m) - 1] if isinstance(w, list) else w

    monkeypatch.setattr(tbal, "_time_once", timed)
    return ran


def _fit_case(monkeypatch, k, o, extra=(0.0, 0.0, 0.0)):
    seq, x = _seq(width=16, n=6), torch.randn(4, 16)
    prof = tplan.uniform_profile(6, rows=4, f=1e-3, o_over_f=0.0,
                                 mode="serialized")
    cycles = [get_schedule("gpipe").op_tables(m, 2)[0].shape[0]
              for m in (2, 4, 8)]
    priced = 8 / 4 * 6 * (1e-3 + 2e-3 + 1e-3)    # every m alike, o = 0
    ran = _stub_walls(monkeypatch, [k * priced + c * o + e
                                    for c, e in zip(cycles, extra)])
    return seq, x, prof, ran, priced, cycles


@pytest.mark.parametrize("k,o", [(0.5, 2e-3), (1.0, 0.0), (2.0, 1e-4)])
def test_fit_step_costs_recovers_scale_and_overhead(monkeypatch, k, o):
    """Walls made by the model itself: the fit gives back its scale and
    per-cycle overhead with no residual, and a search over the fitted
    profile prices each m as the walls do."""
    seq, x, prof, ran, priced, cycles = _fit_case(monkeypatch, k, o)
    fit = tplan.fit_step_costs(seq, x, prof, n_devices=2, m_points=(8, 2, 4),
                               batch_rows=8, checkpoint="except_last")
    assert ran == [2, 4, 8] * tplan.FIT_ROUNDS
    assert fit.o == pytest.approx(o, abs=1e-12)
    assert fit.layer_fwd_s == pytest.approx([k * 1e-3] * 6)
    assert fit.layer_bwd_s == pytest.approx([k * 2e-3] * 6)
    assert fit.rel_residual == pytest.approx(0.0, abs=1e-9)
    assert fit.source == "uniform+steps" and seq[0].weight.grad is None
    plans = tplan.search(fit, n_devices=2, m_candidates=(2, 4, 8),
                         batch_rows=8, schedules=("gpipe",),
                         checkpoint="except_last", uniform_only=True)
    assert [p.predicted_step_s for p in plans] == pytest.approx(
        [k * priced + c * o for c in cycles])


def test_fit_step_costs_takes_each_ms_least_wall(monkeypatch):
    """A slow stretch of the host over all but the first and last rounds
    lengthens only the host-bound large-m steps (the m 2 step stays
    device-bound): each m's wall is the least of its rounds, so the fit is
    the clean walls' (a median of the rounds would bend the curve and
    refuse it)."""
    k, o = 0.5, 2e-3
    cycles = [get_schedule("gpipe").op_tables(m, 2)[0].shape[0]
              for m in (2, 4, 8)]
    priced = 8 / 4 * 6 * (1e-3 + 2e-3 + 1e-3)
    clean = [k * priced + c * o for c in cycles]
    slow = (1.0, 1.3, 2.5)                  # the host's stretch, per m
    walls = [[w * (f if 0 < r < tplan.FIT_ROUNDS - 1 else 1.0)
              for r in range(tplan.FIT_ROUNDS)]
             for w, f in zip(clean, slow)]
    _stub_walls(monkeypatch, walls)
    seq, x = _seq(width=16, n=6), torch.randn(4, 16)
    prof = tplan.uniform_profile(6, rows=4, f=1e-3, o_over_f=0.0,
                                 mode="serialized")
    fit = tplan.fit_step_costs(seq, x, prof, n_devices=2, m_points=(2, 4, 8),
                               batch_rows=8, checkpoint="except_last")
    assert fit.o == pytest.approx(o, abs=1e-12)
    assert fit.layer_fwd_s == pytest.approx([k * 1e-3] * 6)
    assert fit.rel_residual == pytest.approx(0.0, abs=1e-9)
    medians = [float(np.median(w)) for w in walls]
    a = np.array([[priced] * 3, cycles], dtype=float).T
    (k_median, _), *_ = np.linalg.lstsq(a, np.array(medians), rcond=None)
    assert k_median <= 0


def test_fit_step_costs_without_growth_fits_no_overhead(monkeypatch):
    """Walls that fall with m: no overhead, the layer costs scaled to the
    walls' least squares."""
    walls = (50e-3, 47e-3, 45e-3)
    _stub_walls(monkeypatch, walls)
    seq, x = _seq(width=16, n=6), torch.randn(4, 16)
    prof = tplan.uniform_profile(6, rows=4, f=1e-3, o_over_f=0.0,
                                 mode="serialized")
    fit = tplan.fit_step_costs(seq, x, prof, n_devices=2, m_points=(2, 4, 8),
                               batch_rows=8, checkpoint="except_last")
    assert fit.o == 0.0
    assert fit.layer_fwd_s[0] / 1e-3 == pytest.approx(
        np.mean(walls) / (8 / 4 * 6 * 4e-3))
    assert 0 < fit.rel_residual < 0.05


@pytest.mark.parametrize("walls", [
    (50e-3, 95e-3, 200e-3),     # steeper than the cycles: scale <= 0
    (1e-3, 20e-3, 2e-3),        # no line through them: residual > 0.25
])
def test_fit_step_costs_refuses_a_bad_fit(monkeypatch, walls):
    _stub_walls(monkeypatch, walls)
    seq, x = _seq(width=16, n=6), torch.randn(4, 16)
    prof = tplan.uniform_profile(6, rows=4, f=1e-3, mode="serialized")
    with pytest.warns(UserWarning, match="REFUSING"), \
            pytest.raises(tplan.CalibrationError):
        tplan.fit_step_costs(seq, x, prof, n_devices=2, m_points=(2, 4, 8),
                             batch_rows=8, checkpoint="except_last")
    with pytest.raises(ValueError, match="two distinct"):
        tplan.fit_step_costs(seq, x, prof, n_devices=2, m_points=(2, 2))


def test_auto_plan_ranks_m_by_the_fitted_overhead(monkeypatch):
    """With o = 0 a serialized step at a fixed batch prices every m alike,
    so rounding would pick m. Fitted to steps that grow with m, the
    smallest m wins and the prices rise with m, by more than rounding."""
    ran = _stub_walls(monkeypatch, (3e-3, 4e-3, 6e-3))
    seq, x = _seq(width=16, n=6), torch.randn(4, 16)
    plan = tplan.auto_plan(seq, x, n_devices=2, m_candidates=(2, 4, 8),
                           batch_rows=8, schedules=("gpipe",),
                           checkpoint="except_last")
    assert ran == [2, 4, 8] * tplan.FIT_ROUNDS
    assert plan.profile_source == "profile_model+steps"
    assert plan.m == 2 and plan.predicted_step_s == pytest.approx(3e-3,
                                                                 rel=0.2)
    prices = [plan.predicted_step_s] + [r["predicted_step_s"]
                                        for r in plan.runners_up]
    assert [plan.m] + [r["m"] for r in plan.runners_up] == [2, 4, 8]
    assert all(b > a * (1 + 1e-3) for a, b in zip(prices, prices[1:]))
    assert tplan._fit_points((2, 4, 8, 16, 32), 32) == (2, 8, 32)
    assert tplan._fit_points((3, 4, 8), 8) == (4, 8)


def _trainer_cfgs(**kw):
    model = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=4)
    jmodel = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=4)
    base = dict(n_stages=2, chunks=4, batch_size=8, eval_batch_size=8,
                bptt=model.seq_len, **kw)
    return model, jmodel, base


@pytest.mark.parametrize("checkpoint", ["never", "except_last"])
@pytest.mark.parametrize("cap", [None, 200_000])
def test_trainer_plan_auto_resolves_as_pipe_tpus(checkpoint, cap):
    """On the CPU pipe_tpu prices plan='auto' serialized too, so both
    trainers fold the same plan into the same config."""
    model, jmodel, base = _trainer_cfgs(checkpoint=checkpoint,
                                        plan_memory_cap=cap)
    jtr = jloop.Trainer(jmodel, jloop.TrainerConfig(plan="auto", **base))
    tr = tloop.Trainer(model, tloop.TrainerConfig(plan="auto", **base),
                       device="cpu")
    assert tr.cfg.plan.to_json() == jtr.cfg.plan.to_json()
    assert tr.cfg.plan.mode == "serialized"
    for field in ("schedule", "chunks", "checkpoint", "n_stages",
                  "interleave"):
        assert getattr(tr.cfg, field) == getattr(jtr.cfg, field), field
    line = tloop.plan_line(tr.cfg)
    assert line.startswith(f"plan resolved: schedule={tr.cfg.schedule} ")
    state, info = tr.train_epoch(
        tloop.np.random.default_rng(0).integers(
            0, model.vocab, size=(2 * model.seq_len + 1, 8)),
        max_steps=1, log_every=0)
    assert info["steps"] == 1 and np.isfinite(info["loss"])


def test_trainer_plan_from_a_path_and_the_zb_split_line(tmp_path):
    model, jmodel, base = _trainer_cfgs(checkpoint="never")
    top = tplan.search(tplan.uniform_profile(4, rows=1), n_devices=2,
                       m_candidates=(4,), schedules=("zb-h1",),
                       checkpoint="never", uniform_only=True)[0]
    path = tmp_path / "plan.json"
    top.save(str(path))
    tr = tloop.Trainer(model, tloop.TrainerConfig(plan=str(path), **base),
                       device="cpu")
    jtr = jloop.Trainer(jmodel, jloop.TrainerConfig(plan=str(path), **base))
    assert (tr.cfg.schedule, tr.cfg.chunks, tr.cfg.checkpoint) == \
        (jtr.cfg.schedule, jtr.cfg.chunks, jtr.cfg.checkpoint) == \
        ("zb-h1", 4, "never")
    assert tr.scheduled.schedule.name == "zb-h1"
    assert tr.scheduled.split_stage is not None
    assert "split=structural" in tloop.plan_line(tr.cfg)
    with pytest.raises(FileNotFoundError):
        tloop.Trainer(model, tloop.TrainerConfig(
            plan=str(tmp_path / "none.json"), **base), device="cpu")
