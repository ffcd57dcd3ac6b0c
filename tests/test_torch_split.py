"""The structural B/W split of pipe_tpu_torch (``core/remat.py``'s
``split_backward_stage`` and the table executor's ``split_stage``) on toy
stages, against the port's own fused backward, and its guards against
``pipe_tpu``'s.

``pipe_tpu``'s own auto split cannot run on this JAX (ROADMAP.md C.4), so
the split is held here to the port's 1f1b/never step on the same weights
(the fused backward of every micro-batch at B), and in
tests/test_torch_scheduled_zb.py to ``pipe_tpu``'s unsplit zb-h1 step. The
laws: W dispatches only the weight-gradient products and B none of them,
B + W dispatch what the fused backward does (``count_dots``), W never
launches the attention backward, and every gradient is the fused one's.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.parallel.mesh import make_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.scheduled import SkipLanes as JSkipLanes
from pipe_tpu_torch.core.partition import StageCtx
from pipe_tpu_torch.core.remat import (SplitUnsupported, count_dots,
                                       split_backward_stage)
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.parallel.scheduled import (ScheduledPipeline, SkipLanes,
                                               SplitBackwardStage)

D, V, SEQ, ROWS = 8, 11, 5, 3
TOL = dict(rtol=1e-5, atol=1e-6)


class Toy(nn.Module):
    """A pre (embedding + a positional table), ``S`` stages and a post (a
    linear head, squared error to the next token's embedding). Each stage
    runs every region op the split has a rule for, and one it has not:
    a norm scale into a linear (cascaded), an embedding of data indices, a
    broadcast multiply and a sliced add, a product with ``exp`` of a
    parameter (nonlinear entry, C.18) and ``torch.where`` of a weight
    (re-run at W). ``dead`` is never used."""

    def __init__(self, S: int, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)

        def p(*shape, scale=0.3):
            return nn.Parameter(torch.randn(*shape, generator=g) * scale)

        self.emb, self.pos = p(V, D), p(SEQ, D)
        self.gamma = nn.ParameterList(p(D, scale=1.0) for _ in range(S))
        self.beta = nn.ParameterList(p(D) for _ in range(S))
        self.w = nn.ParameterList(p(D, D) for _ in range(S))
        self.b = nn.ParameterList(p(D) for _ in range(S))
        self.scale = nn.ParameterList(p(D) for _ in range(S))
        self.shift = nn.ParameterList(p(2 * SEQ, D) for _ in range(S))
        self.u = nn.ParameterList(p(D, D, scale=0.1) for _ in range(S))
        self.gate = nn.ParameterList(p(D) for _ in range(S))
        self.table = nn.ParameterList(p(V, D, scale=0.1) for _ in range(S))
        self.register_buffer("ids", torch.arange(SEQ) * 3 % V)
        self.head = p(D, D)
        self.dead = nn.Parameter(torch.ones(5))

    def pre_fn(self, x_mb, ctx=StageCtx()):
        return F.embedding(x_mb["tokens"], self.emb) + self.pos

    def stage_fn(self, s, h, ctx=StageCtx()):
        h = F.layer_norm(h, (D,), self.gamma[s], self.beta[s])
        h = torch.tanh(F.linear(h, self.w[s], self.b[s]))
        h = h * self.scale[s] + self.shift[s][:h.shape[-2]]
        h = h + F.embedding(self.ids[:h.shape[-2]], self.table[s])
        h = h + torch.tanh(h @ torch.exp(self.u[s]))
        return torch.where(h > 0, h, self.gate[s] * 0.5)

    def post_fn(self, h, x_mb, ctx=StageCtx()):
        want = F.embedding(x_mb["targets"], self.emb.detach())
        return ((F.linear(h, self.head) - want) ** 2).mean(dim=(-1, -2))


def _batch(m, seed=1):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, V, (m, ROWS, SEQ)))
    return {"tokens": tok, "targets": tok.roll(-1, -1)}


def _step(model, n, m, schedule="zb-h1", split_stage=None, **kw):
    model.zero_grad(set_to_none=True)
    ex = ScheduledPipeline(model.stage_fn, model.pre_fn, model.post_fn,
                           n_stages=n, module=model, checkpoint="never",
                           schedule=schedule, device="cpu",
                           split_stage=split_stage, **kw)
    loss, grads = ex.loss_and_grad(_batch(m), torch.ones(m, ROWS))
    return loss.item(), {k: g.clone() for k, g in grads.items()}, ex


def _assert_steps_close(got, want):
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert sorted(got[1]) == sorted(want[1])
    for name, g in want[1].items():
        torch.testing.assert_close(got[1][name], g, **TOL, msg=name)


@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (4, 2)])
def test_split_step_equals_the_1f1b_never_step(n, m):
    """Every gradient (pre, post, each stage's, the dead one's zero) equals
    the fused backward's; the taps ride the stash, the cotangents the W
    park, within the schedule's slots."""
    model = Toy(n)
    want = _step(model, n, m, schedule="1f1b")
    got = _step(model, n, m, split_stage="auto")
    _assert_steps_close(got, want)
    assert torch.count_nonzero(got[1]["dead"]) == 0
    assert all(torch.count_nonzero(got[1][k]) > 0 for k in got[1]
               if k != "dead")
    ex = got[2]
    assert ex.last_slots["stash"] <= ex.schedule.stash_slots(m, n)
    assert 0 < ex.last_slots["wstash"] <= ex.schedule.wstash_slots(m, n)
    assert ex.memory_plan(m)["taps_slots"] == ex.schedule.stash_slots(m, n)
    assert ex.stage_passes(m) == {"forward": n * m, "backward": n * m}


def test_plans_are_cached_per_signature_and_replayed():
    """One plan per (stage, micro-batch) signature after the first step;
    the second step replays them (no new plan) and takes the same step."""
    model = Toy(2)
    first = _step(model, 2, 4, split_stage="auto")
    plans = first[2].split_stage.tapped_fn.plans
    assert len(plans) == 2 * 4
    ex = first[2]
    model.zero_grad(set_to_none=True)
    loss, grads = ex.loss_and_grad(_batch(4), torch.ones(4, ROWS))
    assert len(plans) == 8
    assert loss.item() == first[0]
    for name, g in first[1].items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=0)


def _one_microbatch(model, stage_fn, s, h, split=None):
    """Stage ``s`` on ``h`` once fused (forward + backward) and once split
    (tapped forward, B, W), each under ``count_dots``: the dot counts, the
    input cotangents and the parameter gradients of each."""
    seed = torch.randn(h.shape, generator=torch.Generator().manual_seed(5))
    ctx = StageCtx(train=True, stage=s)
    model.zero_grad(set_to_none=True)
    h0 = h.clone().requires_grad_(True)
    with count_dots() as f_fwd:
        out = stage_fn(s, h0, ctx)
    with count_dots() as fused:
        out.backward(seed)
    want = {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}
    model.zero_grad(set_to_none=True)
    split = split or split_backward_stage(stage_fn, model)
    h1 = h.clone().requires_grad_(True)
    with count_dots() as s_fwd:
        out, ys, taps = split.tapped_fn(s, h1, ctx)
    with count_dots() as b:
        g = torch.autograd.grad(out, [h1, *ys], seed, allow_unused=True)
    with count_dots() as w:
        pairs = split.wgrad_fn(s, taps, list(g[1:]))
        torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
    got = {k: p.grad.clone() for k, p in model.named_parameters()
           if p.grad is not None}
    assert s_fwd.count == f_fwd.count
    torch.testing.assert_close(g[0], h0.grad, **TOL)
    return fused.count, b.count, w.count, got, want


def test_count_dots_laws_on_a_toy_stage():
    """Two weight products (the linear's and the matmul's): W dispatches
    exactly those two, B the rest, and B + W the fused backward's."""
    model = Toy(1)
    h = torch.randn(ROWS, SEQ, D, generator=torch.Generator().manual_seed(2))
    fused, b, w, got, want = _one_microbatch(model, model.stage_fn, 0, h)
    assert (b, w, fused) == (fused - 2, 2, b + w)
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        torch.testing.assert_close(got[name], g, **TOL, msg=name)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_count_dots_laws_on_the_tiny_lm(monkeypatch, attn_impl):
    """The tiny LM's stage: W dispatches one product per linear (six a
    block), B the input-gradient and attention products, B + W the fused
    backward's; with the flash route (the wrappers' plain versions on the
    CPU) W launches neither dQ nor dK/dV."""
    from pipe_tpu_torch.ops import flash_attention as tfa

    calls = {"dq": 0, "dkv": 0}
    for key, name in (("dq", "flash_attention_bwd_dq"),
                      ("dkv", "flash_attention_bwd_dkv")):
        def counted(*a, _f=getattr(tfa, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tfa, name, counted)
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=2,
                              attn_impl=attn_impl)
    model = tlm.PipelinedLM(cfg, 1, device="cpu")
    h = torch.randn(2, cfg.seq_len, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    split = split_backward_stage(model.stage_fn, model)
    real_wgrad = split.wgrad_fn

    def wgrad_no_attention(s, taps, g_ys):
        before = dict(calls)
        pairs = real_wgrad(s, taps, g_ys)
        assert calls == before
        return pairs

    split = SplitBackwardStage(split.tapped_fn, wgrad_no_attention)
    fused, b, w, got, want = _one_microbatch(model, model.stage_fn, 0, h,
                                             split)
    assert w == 6 * cfg.n_layers and b + w == fused
    if attn_impl == "flash":
        assert calls == {"dq": 2 * cfg.n_layers, "dkv": 2 * cfg.n_layers}
    for name, g in want.items():
        torch.testing.assert_close(got[name], g, **TOL, msg=name)


def test_cascaded_products_stay_exact():
    """``(h @ w1) @ w2`` and a norm scale into a linear: each product's
    output is a cut point, so W reads the whole cotangent there and no
    path counts twice."""
    model = nn.Module()
    g = torch.Generator().manual_seed(4)
    model.w1 = nn.Parameter(torch.randn(D, D, generator=g))
    model.w2 = nn.Parameter(torch.randn(D, D, generator=g))
    model.gamma = nn.Parameter(torch.randn(D, generator=g))

    def stage(s, h, ctx):
        h = F.layer_norm(h, (D,), model.gamma)
        return F.linear((h @ model.w1) @ model.w2, model.w1)

    h = torch.randn(ROWS, D, generator=g)
    fused, b, w, got, want = _one_microbatch(model, stage, 0, h)
    assert (w, b + w) == (3, fused)
    for name, grad in want.items():
        torch.testing.assert_close(got[name], grad, **TOL, msg=name)


def test_a_params_only_output_raises():
    model = nn.Module()
    model.w = nn.Parameter(torch.ones(3, 4))
    split = split_backward_stage(lambda s, h, ctx: model.w * 2.0, model)
    with pytest.raises(SplitUnsupported, match="params-only value"):
        split.tapped_fn(0, torch.ones(3, 4).requires_grad_(), StageCtx())


def test_unseen_and_in_place_parameter_paths_raise():
    """A weight handed to a custom ``autograd.Function`` reaches the output
    by a path the interception cannot see; an in-place op with a weight
    operand leaves no new value to take a cotangent at. Both raise rather
    than drop a gradient."""
    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return x * w

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            return g * w, (g * x).sum(0)

    model = nn.Module()
    model.w = nn.Parameter(torch.ones(4))
    h = torch.ones(3, 4).requires_grad_()
    unseen = split_backward_stage(
        lambda s, h, ctx: Scale.apply(h * 1.0, model.w), model)
    with pytest.raises(SplitUnsupported, match="cannot see"):
        unseen.tapped_fn(0, h, StageCtx())
    in_place = split_backward_stage(
        lambda s, h, ctx: (h * 1.0).add_(model.w), model)
    with pytest.raises(SplitUnsupported, match="in place"):
        in_place.tapped_fn(0, h, StageCtx())

    def tap_changed(s, h, ctx):
        x = h * 1.0
        y = x * model.w
        x.add_(1.0)              # W would read this x, not the one y used
        return y + x

    split = split_backward_stage(tap_changed, model)
    out, ys, taps = split.tapped_fn(0, h, StageCtx())
    g = torch.autograd.grad(out, ys, torch.ones_like(out))
    with pytest.raises(SplitUnsupported, match="modified in place"):
        split.wgrad_fn(0, taps, list(g))


def _hand_split(model):
    """The Toy stage's split written out by hand: the tapped forward with
    every weight detached at its product, and W's closed forms."""
    def tapped(s, h, ctx):
        g, bt, w, b = (model.gamma[s], model.beta[s], model.w[s], model.b[s])
        xhat = F.layer_norm(h, (D,))
        y1 = F.layer_norm(h, (D,), g.detach(), bt.detach())
        y2 = F.linear(y1, w.detach(), b.detach())
        t = torch.tanh(y2)
        y3 = t * model.scale[s].detach()
        shift = model.shift[s][:t.shape[-2]]
        ids = model.ids[:t.shape[-2]]
        y7 = F.embedding(ids, model.table[s].detach()).requires_grad_()
        y4 = y3 + shift.detach() + y7
        eu = torch.exp(model.u[s])
        y5 = y4 @ eu.detach()
        h = y4 + torch.tanh(y5)
        gate = model.gate[s] * 0.5
        y6 = torch.where(h > 0, h, gate.detach())
        return y6, [y1, y2, y3, y7, y4, y5, y6], (
            xhat, y1, t, shift, ids, y4, eu, h > 0, gate)

    def wgrad(s, taps, gs):
        xhat, y1, t, shift, ids, y4, eu, pos, gate = taps
        g1, g2, g3, g7, g4, g5, g6 = gs
        flat = lambda a: a.reshape(-1, a.shape[-1])
        table = torch.zeros_like(model.table[s]).index_add_(0, ids, g7)
        return [(model.gamma[s], (g1 * xhat).sum((0, 1))),
                (model.beta[s], g1.sum((0, 1))),
                (model.w[s], flat(g2).t().mm(flat(y1))),
                (model.b[s], flat(g2).sum(0)),
                (model.scale[s], (g3 * t).sum((0, 1))),
                (model.table[s], table),
                (shift, g4.sum(0)),
                (eu, flat(y4).t().mm(flat(g5))),
                (gate, torch.where(pos, 0.0, g6).sum((0, 1)))]

    return SplitBackwardStage(tapped_fn=tapped, wgrad_fn=wgrad)


def test_a_hand_written_split_equals_auto():
    model = Toy(2)
    auto = _step(model, 2, 4, split_stage="auto")
    hand = _step(model, 2, 4, split_stage=_hand_split(model))
    _assert_steps_close(hand, auto)


def _jax_error(**kw):
    """``pipe_tpu``'s constructor's refusal of a zb-h1/never
    ``split_stage="auto"`` executor changed by ``kw``."""
    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    args = dict(checkpoint="never", schedule="zb-h1", split_stage="auto")
    args.update(kw)
    with pytest.raises(Exception) as err:
        JPipeline(mesh, lambda p, h, c: h, pre_fn=lambda p, x, c: x,
                  post_fn=lambda p, h, x, c: h, **args)
    return err


@pytest.mark.parametrize("case", ["schedule", "checkpoint", "remat_policy",
                                  "string", "stat_spec", "skip_lanes"])
def test_guards_match_pipe_tpu(case):
    """Each refusal of ``split_stage``: the same exception type and words
    as ``pipe_tpu``'s constructor."""
    jax_kw, port_kw = {
        "schedule": ({"schedule": "1f1b"}, {"schedule": "1f1b"}),
        "checkpoint": ({"checkpoint": "except_last"},
                       {"checkpoint": "except_last"}),
        "remat_policy": (
            {"remat_policy": jax.checkpoint_policies.dots_saveable},
            {"remat_policy": "dots_saveable"}),
        "string": ({"split_stage": "manual"}, {"split_stage": "manual"}),
        "stat_spec": ({"stat_spec": {}}, {"stat_spec": {}}),
        "skip_lanes": (
            {"skip_lanes": JSkipLanes(
                pairs=((0, 1),),
                specs=(jax.ShapeDtypeStruct((3,), np.float32),))},
            {"skip_lanes": SkipLanes(pairs=((0, 1),), specs=())}),
    }[case]
    jerr = _jax_error(**jax_kw)
    model = Toy(2)
    args = dict(checkpoint="never", schedule="zb-h1", split_stage="auto")
    args.update(port_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(Exception) as terr:
            ScheduledPipeline(model.stage_fn, model.pre_fn, model.post_fn,
                              n_stages=2, module=model, device="cpu", **args)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)
