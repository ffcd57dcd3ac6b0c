"""pipe_tpu_torch's table executor (parallel/scheduled.py) against
pipe_tpu's ``ScheduledPipeline``, and against itself under dropout.

* The tiny LM with ``loss_post_fn`` through gpipe and 1f1b tables (zb-h1 and
  interleaved-1f1b: tests/test_torch_scheduled_zb.py) in every checkpoint
  mode at (n, m) = (2, 4), (4, 8) and (4, 2), dropout 0, from converted
  weights: loss within 1e-5 relative, every gradient within rtol 1e-4 /
  atol 1e-5 (JAX's own tolerance, tests/test_scheduled.py), and
  ``memory_plan`` equal dict for dict. JAX runs on the suite's virtual CPU
  devices (tests/conftest.py); its step is computed once per schedule and
  geometry, under ``never``, and every port mode is held to it (JAX's
  modes give the same step), with each mode's own ``memory_plan``.
* Dropout 0.2, the port against itself: the checkpoint modes replay the
  masks, and gpipe, 1f1b and zb-h1 give the same step.
* Exact ``except_last`` (stage calls counted), the stash caps, padded
  batches, the FWD-only ``forward``, and the refusals.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.schedule import InterleavedOneFOneBSchedule
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.parallel.interleaved import (stack_interleaved_params,
                                           unstack_interleaved_params)
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch import Pipe, convert
from pipe_tpu_torch.core import microbatch as tmb
from pipe_tpu_torch.core.schedule import get_schedule
from pipe_tpu_torch.models import common as tcommon
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.obs.telemetry import get_registry
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

MODES = ["always", "except_last", "never"]
GEOMS = [(2, 4), (4, 8), (4, 2)]          # (n_stages, m)
ROWS = 2
TOL_LOSS = 1e-5
TOL_GRAD = dict(rtol=1e-4, atol=1e-5)
# Under dropout: recompute replays the masks; the accumulation order of
# micro-batches differs between schedules, so those agree to rounding.
TOL_MODES = 1e-6
TOL_SCHEDULES = 1e-5


def _interleave(schedule):
    return 2 if schedule == "interleaved-1f1b" else 1


def lm_case(schedule, n, m, seed=0):
    """Converted weights and a batch: ``(jax model, its params, port model,
    x as numpy)``; interleaved tables hold ``2n`` virtual stages."""
    S = n * _interleave(schedule)
    layers = max(4, S)
    jcfg = dataclasses.replace(jlm.LMConfig().tiny(), n_layers=layers)
    jm = jlm.PipelinedLM(jcfg, S)
    params = jm.init(jax.random.key(seed))
    tm = tlm.PipelinedLM(
        dataclasses.replace(tlm.LMConfig().tiny(), n_layers=layers), S,
        device="cpu")
    convert.load_pipelined_lm(tm, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (m, ROWS, jcfg.seq_len))
    x = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=-1)}
    return jm, params, tm, x


_JAX_CACHE = {}


def _jax_pipeline(jm, schedule, mode, n, **kw):
    v = _interleave(schedule)
    sched = (InterleavedOneFOneBSchedule(interleave=v) if v > 1
             else schedule)
    return JPipeline(make_mesh(n, 1), jm.stage_fn, pre_fn=jm.pre_fn,
                     post_fn=jm.loss_post_fn, checkpoint=mode,
                     schedule=sched, **kw)


def jax_step(schedule, mode, n, m, **kw):
    """JAX's ``ScheduledPipeline.loss_and_grad`` on :func:`lm_case`:
    ``(loss, grads by port name, memory_plan, port model, x)``. The loss and
    gradients are computed once per ``(schedule, n, m)``, under ``never``
    (nothing to recompute): JAX's checkpoint modes give the same step
    (tests/test_scheduled.py holds them to each other), so every port mode
    is held to it. The memory plan is ``mode``'s, read from JAX's
    executor without a step (``kw``: its ``split_stage``, read by the plan
    only: the step is the unsplit one)."""
    key = (schedule, n, m)
    if key not in _JAX_CACHE:
        jm, params, tm, x = lm_case(schedule, n, m)
        sp, pre, post = params
        v = _interleave(schedule)
        stacked = (stack_interleaved_params(sp, n) if v > 1
                   else stack_stage_params(sp))
        pipe = _jax_pipeline(jm, schedule, "never", n)
        w = jnp.ones((m, ROWS), jnp.float32)
        loss, (gs, gpre, gpost) = jax.jit(pipe.loss_and_grad)(
            stacked, pre, post, jax.tree_util.tree_map(jnp.asarray, x), w,
            key=jax.random.key(1))
        gs = jax.tree_util.tree_map(np.asarray, gs)
        if v > 1:
            gs = unstack_interleaved_params(gs, n)
        grads = convert.pipelined_lm_arrays(
            tm, (gs, *jax.tree_util.tree_map(np.asarray, (gpre, gpost))))
        _JAX_CACHE[key] = (float(loss), grads, jm, tm, x)
    loss, grads, jm, tm, x = _JAX_CACHE[key]
    plan = _jax_pipeline(jm, schedule, mode, n, **kw).memory_plan(m)
    return loss, grads, plan, tm, x


def port_pipeline(model, n, schedule, mode, **kw):
    return ScheduledPipeline(model.stage_fn, model.pre_fn,
                             model.loss_post_fn, n_stages=n, module=model,
                             checkpoint=mode, schedule=schedule,
                             device="cpu", **kw)


def _torch_x(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def check_against_pipe_tpu(schedule, mode, n, m, **kw):
    """The port's step held to :func:`jax_step`'s; ``kw`` (``split_stage``)
    goes to both executors, and so to the memory plans."""
    want_loss, want_grads, want_plan, tm, x = jax_step(schedule, mode, n, m,
                                                       **kw)
    tm.zero_grad(set_to_none=True)
    pipe = port_pipeline(tm, n, schedule, mode, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")            # zb-h1 under recompute
        loss, grads = pipe.loss_and_grad(_torch_x(x), torch.ones(m, ROWS))
    assert loss.item() == pytest.approx(want_loss, rel=TOL_LOSS)
    assert sorted(grads) == sorted(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), want, **TOL_GRAD,
                                   err_msg=name)
    assert pipe.memory_plan(m) == want_plan
    return pipe


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,m", GEOMS)
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_executor_matches_pipe_tpu(schedule, n, m, mode):
    pipe = check_against_pipe_tpu(schedule, mode, n, m)
    assert pipe.last_slots["stash"] == get_schedule(schedule).stash_slots(m, n)


# --- the port against itself under dropout ----------------------------------

def _dropout_step(schedule, mode, n=2, m=4, seed=11):
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), dropout=0.2,
                              n_layers=max(4, n * _interleave(schedule)))
    model = tlm.PipelinedLM(cfg, n * _interleave(schedule), device="cpu",
                            generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (m, ROWS, cfg.seq_len))
    x = _torch_x({"tokens": tokens, "targets": np.roll(tokens, -1, -1)})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss, grads = port_pipeline(model, n, schedule, mode).loss_and_grad(
            x, torch.ones(m, ROWS), seed=seed)
    return loss.item(), {k: g.clone() for k, g in grads.items()}


def _close(a, b, rel):
    la, ga = a
    lb, gb = b
    assert la == pytest.approx(lb, rel=rel)
    for name in ga:
        scale = max(gb[name].abs().max().item(), 1e-12)
        assert (ga[name] - gb[name]).abs().max().item() <= rel * scale, name


@pytest.mark.parametrize("schedule",
                         ["gpipe", "1f1b", "zb-h1", "interleaved-1f1b"])
def test_checkpoint_modes_replay_dropout(schedule):
    """Recompute re-runs each stage with its seeds, so every checkpoint mode
    gives the step the stored graphs give; the dropout is live (seed 0
    differs from seed 11)."""
    steps = {mode: _dropout_step(schedule, mode) for mode in MODES}
    for mode in ("always", "except_last"):
        _close(steps[mode], steps["never"], TOL_MODES)
    other = _dropout_step(schedule, "never", seed=0)
    assert other[0] != steps["never"][0]


def test_schedules_agree_under_dropout():
    """One seed gives the same masks under every table: gpipe, 1f1b and
    zb-h1 take the same step (to the rounding of their accumulation
    order)."""
    base = _dropout_step("gpipe", "except_last")
    for schedule, mode in (("1f1b", "except_last"), ("zb-h1", "never"),
                           ("1f1b", "never")):
        _close(_dropout_step(schedule, mode), base, TOL_SCHEDULES)


# --- exact except_last, stash caps, padding, forward --------------------------

@pytest.mark.parametrize("schedule,n,m", [("1f1b", 2, 4), ("gpipe", 2, 4),
                                          ("zb-h1", 4, 8),
                                          ("interleaved-1f1b", 2, 4)])
def test_except_last_forwards_the_last_microbatch_once(schedule, n, m):
    """Micro-batch m-1 keeps its graph and runs each stage once; every other
    micro-batch runs each stage twice (its forward, then the recompute at
    B). The stash never holds more than the schedule's slots."""
    cfg = dataclasses.replace(tlm.LMConfig().tiny(),
                              n_layers=max(4, n * _interleave(schedule)))
    model = tlm.PipelinedLM(cfg, n * _interleave(schedule), device="cpu")
    calls = {}

    def counted(s, h, ctx):
        calls[(ctx.microbatch, s)] = calls.get((ctx.microbatch, s), 0) + 1
        return model.stage_fn(s, h, ctx)

    pipe = ScheduledPipeline(counted, model.pre_fn, model.loss_post_fn,
                             n_stages=n, module=model,
                             checkpoint="except_last", schedule=schedule,
                             device="cpu")
    x, _ = tmb.stack_scatter({"tokens": torch.randint(0, cfg.vocab,
                                                      (2 * m, cfg.seq_len))},
                             m)
    x["targets"] = x["tokens"].roll(-1, -1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe.loss_and_grad(x, torch.ones(m, 2))
    S = pipe.n_virtual
    assert calls == {(i, s): 1 if i == m - 1 else 2
                     for i in range(m) for s in range(S)}
    sched = get_schedule(schedule) if schedule != "interleaved-1f1b" \
        else pipe.schedule
    assert 0 < pipe.last_slots["stash"] <= sched.stash_slots(m, n)
    if schedule == "1f1b":
        assert pipe.last_slots["stash"] == min(m, n)


def test_zb_never_parks_seeds_for_w_within_its_slots():
    _, _, tm, x = lm_case("zb-h1", 4, 8)
    pipe = port_pipeline(tm, 4, "zb-h1", "never")
    pipe.loss_and_grad(_torch_x(x), torch.ones(8, ROWS))
    sched = get_schedule("zb-h1")
    assert pipe.last_slots["stash"] == sched.stash_slots(8, 4)
    assert pipe.last_slots["wstash"] == sched.wstash_slots(8, 4)
    assert get_registry().gauge("scheduled.cycles").value == \
        sched.num_cycles(8, 4)


def test_a_batch_chunks_do_not_divide_gives_the_real_rows_mean():
    """Batch 10, chunks 4: zero-padded to 12 rows, the padding weighted 0;
    the loss and gradients are the unpipelined mean over the 10 rows."""
    cfg = tlm.LMConfig().tiny()
    model = tlm.PipelinedLM(cfg, 2, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (10, cfg.seq_len),
                           generator=torch.Generator().manual_seed(4))
    x, rows = tmb.stack_scatter({"tokens": tokens,
                                 "targets": tokens.roll(-1, -1)}, 4)
    w = tmb.valid_row_mask(x, rows)
    assert x["tokens"].shape[:2] == (4, 3) and w.sum().item() == 10
    loss, grads = port_pipeline(model, 2, "1f1b", "except_last") \
        .loss_and_grad(x, w)
    grads = {k: g.clone() for k, g in grads.items()}
    model.zero_grad(set_to_none=True)
    seq = tl.Sequential([model.embed, model.posenc, *model.blocks,
                         model.decoder])
    want = tcommon.per_row_ce(seq(tokens), tokens.roll(-1, -1)).mean()
    want.backward()
    assert loss.item() == pytest.approx(want.item(), rel=1e-6)
    for name, p in model.named_parameters():
        torch.testing.assert_close(grads[name], p.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved-1f1b",
                                      "zb-h1"])
def test_forward_walks_the_fwd_ops(schedule):
    """``forward``: the FWD ops of the table in eval mode, the last stage's
    outputs ``[m, rows, ...]``, equal to ``Pipe``'s eval forward of the
    same layers."""
    n, m = 2, 4
    cfg = dataclasses.replace(tlm.LMConfig().tiny(),
                              n_layers=4 * _interleave(schedule))
    model = tlm.PipelinedLM(cfg, n * _interleave(schedule), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (m * ROWS, cfg.seq_len))
    x, _ = tmb.stack_scatter({"tokens": tokens}, m)
    pipe = port_pipeline(model, n, schedule, "never")
    with torch.no_grad():
        h = pipe.forward(x)
        got = model.decoder(h.flatten(0, 1))
        want = Pipe(tl.Sequential([model.embed, model.posenc, *model.blocks,
                                   model.decoder]),
                    chunks=m, device="cpu")(tokens)
    assert h.shape == (m, ROWS, cfg.seq_len, cfg.d_model)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# --- construction -------------------------------------------------------------

@pytest.mark.parametrize("field,value,item", [
    ("context_axis", "ctx", "A.8"),
    ("stage_param_specs", {}, "A.8"), ("overlap_transport", True, "A.8"),
    ("phase_compile", True, "A.8")])
def test_unported_fields_raise_naming_their_item(field, value, item):
    model = tlm.PipelinedLM(tlm.LMConfig().tiny(), 2, device="cpu")
    assert field in {f.name for f in dataclasses.fields(JPipeline)}
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md: {item}"):
        port_pipeline(model, 2, "1f1b", "never", **{field: value})


def test_construction_validates_like_pipe_tpu(monkeypatch):
    model = tlm.PipelinedLM(tlm.LMConfig().tiny(), 2, device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        port_pipeline(model, 2, "1f1b", "sometimes")
    with pytest.raises(ValueError, match="op_tables"):
        port_pipeline(model, 2, object(), "never")
    with pytest.raises(ValueError, match="unknown schedule"):
        port_pipeline(model, 2, "nope", "never")
    with pytest.warns(UserWarning, match="zero-bubble advantage is lost"):
        port_pipeline(model, 2, "zb-h1", "except_last")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_pipeline(model, 2, "zb-h1", "never")
    assert port_pipeline(model, 2, "1f1b", "never", overlap_transport=False,
                         phase_compile=False).n_virtual == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                          n_stages=2, module=model)


@pytest.mark.parametrize("schedule,mode,split", [
    pytest.param(s, c, x, id=f"{s}-{c}" + ("-auto" if x else ""))
    for s, c, x in (
        ("gpipe", "except_last", None), ("1f1b", "except_last", None),
        ("1f1b", "always", None), ("1f1b", "never", None),
        ("zb-h1", "never", None), ("zb-h1", "except_last", None),
        ("interleaved-1f1b", "except_last", None),
        ("zb-h1", "never", "auto"))])
def test_kernel_calls_follow_stage_passes(monkeypatch, schedule, mode, split):
    """The tiny LM with ``attn_impl="flash"`` (the wrappers run their plain
    versions on the CPU): per step the forward wrapper is called
    ``stage_passes()["forward"]`` times per attention layer of a stage, dQ
    and dK/dV ``["backward"]`` times. 1f1b/except_last at m 4 is the
    emulator's 7 forwards and 4 backwards a layer; zb-h1/never's
    stored-graph split walks the backward twice (B, then W) except at stage
    0's B, its structural split (``split_stage="auto"``) once, at B."""
    from pipe_tpu_torch.ops import flash_attention as tfa

    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for key, name in (("fwd", "flash_attention_fwd"),
                      ("dq", "flash_attention_bwd_dq"),
                      ("dkv", "flash_attention_bwd_dkv")):
        def counted(*a, _f=getattr(tfa, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tfa, name, counted)
    n, m = 2, 4
    v = _interleave(schedule)
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), attn_impl="flash",
                              n_layers=4 * v)
    model = tlm.PipelinedLM(cfg, n * v, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (m * ROWS, cfg.seq_len))
    x, _ = tmb.stack_scatter({"tokens": tokens,
                              "targets": tokens.roll(-1, -1)}, m)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = port_pipeline(model, n, schedule, mode, split_stage=split)
    pipe.loss_and_grad(x, torch.ones(m, ROWS))
    passes = pipe.stage_passes(m)
    lps = model.layers_per_stage
    assert calls == {"fwd": passes["forward"] * lps,
                     "dq": passes["backward"] * lps,
                     "dkv": passes["backward"] * lps}
    if (schedule, mode) in (("1f1b", "except_last"),
                            ("gpipe", "except_last")):
        assert passes == {"forward": n * (2 * m - 1), "backward": n * m}
    if (schedule, mode) == ("zb-h1", "never"):
        assert passes == {"forward": n * m, "backward": (
            n * m if split else (2 * n - 1) * m)}


@pytest.mark.parametrize("batch,chunks", [(8, 4), (10, 4), (3, 4), (7, 1)])
def test_stack_scatter_and_row_mask_match_pipe_tpu(batch, chunks):
    from pipe_tpu.core import microbatch as jmb

    x = np.arange(batch * 3, dtype=np.int64).reshape(batch, 3)
    want, n = jmb.stack_scatter({"tokens": jnp.asarray(x)}, chunks)
    got, m = tmb.stack_scatter({"tokens": torch.from_numpy(x)}, chunks)
    assert m == n == batch
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(tmb.valid_row_mask(got, m).numpy(),
                                  np.asarray(jmb.valid_row_mask(want, n)))
    with pytest.raises(ValueError):
        tmb.stack_scatter({"a": torch.zeros(2), "b": torch.zeros(3)}, 2)
