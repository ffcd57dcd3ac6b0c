"""pipe_tpu_torch's tensor-parallel block (``ops/tp_layers.py``) and
``TPPipelinedLM``'s split stage (``models/tp_lm.py``) on one device, against
pipe_tpu's.

The block's leaves keep ``pipe_tpu``'s names and layouts, so JAX's
``tp_block_init`` params load as they are. At ``tp_axis=None`` (no mesh):
the block's forward and the gradients of ``sum(out ** 2)`` against JAX's
``tp_block_apply`` (tests/test_tp.py's tolerances: rtol 1e-5 on the loss,
rtol 2e-4 / atol 1e-5 on the gradients), the GELU being ``jax.nn.gelu``'s
tanh form; the decode against JAX's ``tp_block_decode`` and its own apply,
the cache's tail untouched (tests/test_tp_gen.py); the tapped forward, its
taps, ``tp_block_zs`` and the W contractions against JAX's. The split stage
``tp_split_backward_stage``: zb-h1/never against the port's 1f1b/never step
of the same parameters at 1, 2 and 4 stages, and against JAX's split run
at one stage only (ROADMAP.md C.4: JAX's split TP stage is red at 2 and 4).
The split-with-specs refusal and the structure refusal use JAX's words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core import microbatch as jmb
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.models.tp_lm import TPPipelinedLM as JTPLM
from pipe_tpu.models.tp_lm import tp_split_backward_stage as jsplit
from pipe_tpu.models.transformer_lm import LMConfig as JLMConfig
from pipe_tpu.ops import tp_layers as jtp
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu.parallel.scheduled import ScheduledPipeline as JPipeline
from pipe_tpu.parallel.spmd import stack_stage_params
from pipe_tpu_torch import convert
from pipe_tpu_torch.core.partition import StageCtx
from pipe_tpu_torch.models.tp_lm import TPPipelinedLM, tp_split_backward_stage
from pipe_tpu_torch.models.transformer_lm import LMConfig
from pipe_tpu_torch.ops import tp_layers as ttp
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

D, HEADS, FF, SEQ, ROWS = 16, 4, 32, 8, 2


def _block_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jtp.tp_block_init(jax.random.key(seed), D, HEADS, FF))


def _port_block(params, causal=True):
    blk = ttp.TPBlock(D, HEADS, FF, causal=causal, tp_axis=None,
                      device="cpu")
    convert.load_params(blk, params)
    return blk


def _h(seed=1, rows=ROWS, seq=SEQ):
    return np.random.default_rng(seed).standard_normal(
        (rows, seq, D)).astype(np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("causal", [True, False])
def test_block_apply_and_grads_match_pipe_tpu(causal):
    params, h = _block_params(), _h()

    def loss(p, x):
        out = jtp.tp_block_apply(p, x, JCtx(), causal=causal, tp_axis=None)
        return jnp.sum(out ** 2), out

    (l_ref, out_ref), (g_ref, gh_ref) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(h))
    blk = _port_block(params, causal)
    x = torch.from_numpy(h).requires_grad_()
    out = blk(x)
    l = (out ** 2).sum()
    l.backward()
    np.testing.assert_allclose(l.item(), float(l_ref), rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gh_ref),
                               rtol=2e-4, atol=1e-5)
    want = _leaves(g_ref)
    got = {n: p.grad.numpy() for n, p in blk.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=2e-4, atol=1e-5,
                                   err_msg=n)


def test_gelu_is_jax_tanh_form():
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    np.testing.assert_allclose(ttp._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(ttp._gelu(torch.from_numpy(x)).numpy() - exact).max() > 1e-5


def test_block_decode_matches_pipe_tpu_and_its_apply():
    """Prefill through the decode (no mesh) equals the apply, JAX's decode
    equals it, the cache past the prompt stays zero; one more token's
    decode equals JAX's."""
    params = _block_params()
    h = _h(seed=2, rows=2, seq=12)
    blk = _port_block(params)
    cache = blk.attn.make_cache(2, 16)
    assert tuple(cache["k"].shape) == (2, 16, HEADS, D // HEADS)
    with torch.no_grad():
        ref = blk(torch.from_numpy(h))
        out, cache = blk.decode(torch.from_numpy(h), cache, 0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert not cache["k"][:, 12:].any() and not cache["v"][:, 12:].any()
    jcache = {"k": jnp.zeros((2, 16, HEADS, D // HEADS)),
              "v": jnp.zeros((2, 16, HEADS, D // HEADS))}
    jout, jcache = jtp.tp_block_decode(params, jnp.asarray(h), jcache, 0,
                                       tp_axis=None)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-5, atol=1e-6)
    step = _h(seed=3, rows=2, seq=1)
    with torch.no_grad():
        out2, cache = blk.decode(torch.from_numpy(step), cache, 12)
    jout2, _ = jtp.tp_block_decode(params, jnp.asarray(step), jcache, 12,
                                   tp_axis=None)
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout2), rtol=2e-5,
                               atol=2e-5)
    assert not cache["k"][:, 13:].any()
    with pytest.raises(ValueError, match="KV-cache decode requires causal"):
        _port_block(params, causal=False).decode(
            torch.from_numpy(step), blk.attn.make_cache(2, 16), 0)


def test_tapped_zs_and_wgrad_match_pipe_tpu():
    """The tapped forward (zero injections in) equals the apply bit for bit
    and JAX's tapped forward; its taps, ``tp_block_zs`` shapes and the W
    contractions of one set of cotangents equal JAX's."""
    params, h = _block_params(), _h()
    blk = _port_block(params)
    p = blk.tree()
    x = torch.from_numpy(h)
    zs = ttp.tp_block_zs(x, p)
    jzs = jtp.tp_block_zs(jnp.asarray(h), params)
    assert {k: tuple(v.shape) for k, v in zs.items()} == {
        k: tuple(v.shape) for k, v in jzs.items()}
    with torch.no_grad():
        out, ys, taps = ttp.tp_block_tapped(p, x, StageCtx(), zs)
        plain = blk(x)
    assert torch.equal(out, plain)
    assert tuple(ys) == ttp.TP_YS
    jout, jtaps = jtp.tp_block_tapped(params, jnp.asarray(h), JCtx(), jzs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for k in jtaps:
        np.testing.assert_allclose(taps[k].numpy(), np.asarray(jtaps[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    rng = np.random.default_rng(7)
    gzs = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in zs.items()}
    got = _leaves({k: (v.numpy() if torch.is_tensor(v) else
                       {a: b.numpy() for a, b in v.items()})
                   for k, v in ttp.tp_block_wgrad(
                       taps, {k: torch.from_numpy(v)
                              for k, v in gzs.items()}).items()})
    want = _leaves(jtp.tp_block_wgrad(jtaps, {k: jnp.asarray(v)
                                               for k, v in gzs.items()}))
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=2e-4, atol=1e-5,
                                   err_msg=n)


# --- the split stage ---------------------------------------------------------

def _cfg(n_layers, dropout=0.0):
    return dict(vocab=61, d_model=D, nhead=HEADS, d_ff=FF, seq_len=SEQ,
                n_layers=n_layers, dropout=dropout)


def _batch(m, rows, vocab, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (m * rows, SEQ))
    return {"tokens": toks.astype(np.int64),
            "targets": np.roll(toks, -1, -1).astype(np.int64)}


def _port_step(model, n_stages, x, w, schedule, split=None, seed=3):
    from pipe_tpu_torch.core import microbatch as mb
    xt, _ = mb.stack_scatter({k: torch.from_numpy(v) for k, v in x.items()},
                             w.shape[0])
    model.zero_grad(set_to_none=True)
    ex = ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                           n_stages, model, checkpoint="never",
                           schedule=schedule, device="cpu",
                           split_stage=split)
    loss, grads = ex.loss_and_grad(xt, torch.from_numpy(w), seed=seed)
    return float(loss), {k: g.clone() for k, g in grads.items()}


@pytest.mark.parametrize("n_stages,dropout", [(1, 0.0), (2, 0.1), (4, 0.0)])
def test_split_stage_is_the_unsplit_step(n_stages, dropout):
    """zb-h1/never with ``tp_split_backward_stage`` against 1f1b/never on
    the same parameters (and dropout seed): loss within 1e-5 relative,
    gradients within rtol 2e-4 / atol 1e-5 (the held-to-the-unsplit rule
    of C.4)."""
    model = TPPipelinedLM(LMConfig(**_cfg(4, dropout)), n_stages,
                          tp_axis=None, device="cpu")
    x, w = _batch(4, 2, 61), np.ones((4, 2), np.float32)
    l_ref, g_ref = _port_step(model, n_stages, x, w, "1f1b")
    l, g = _port_step(model, n_stages, x, w, "zb-h1",
                      tp_split_backward_stage(model))
    np.testing.assert_allclose(l, l_ref, rtol=1e-5)
    assert set(g) == set(g_ref)
    for n in g_ref:
        np.testing.assert_allclose(g[n].numpy(), g_ref[n].numpy(),
                                   rtol=2e-4, atol=1e-5, err_msg=n)


def test_split_stage_matches_pipe_tpu_at_one_stage():
    """One stage only (ROADMAP.md C.4): the port's split step against
    JAX's zb-h1/never step with its ``tp_split_backward_stage``."""
    cfg = _cfg(2)
    jmodel = JTPLM(JLMConfig(**cfg), 1, tp_axis=None)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(0)))
    x, w = _batch(4, 2, 61), np.ones((4, 2), np.float32)
    jx, n_rows = jmb.stack_scatter({k: jnp.asarray(v, jnp.int32)
                                    for k, v in x.items()}, 4)
    jw = jmb.valid_row_mask(jx, n_rows)
    pipe = JPipeline(jmake_mesh(1, 1, devices=jax.devices()[:1]),
                     jmodel.stage_fn, pre_fn=jmodel.pre_fn,
                     post_fn=jmodel.loss_post_fn, checkpoint="never",
                     schedule="zb-h1",
                     split_stage=jsplit(JLMConfig(**cfg)))
    sp, pre, post = params
    l_ref, grads = jax.jit(pipe.loss_and_grad)(
        stack_stage_params(sp), pre, post, jx, jw)
    model = TPPipelinedLM(LMConfig(**cfg), 1, tp_axis=None, device="cpu")
    convert.load_pipelined_lm(model, params)
    want = convert.pipelined_lm_arrays(model, jax.tree_util.tree_map(
        np.asarray, grads))
    l, g = _port_step(model, 1, x, w, "zb-h1",
                      tp_split_backward_stage(model))
    np.testing.assert_allclose(l, float(l_ref), rtol=1e-5)
    assert set(g) == set(want)
    for n in want:
        np.testing.assert_allclose(g[n].numpy(), want[n], rtol=2e-4,
                                   atol=1e-5, err_msg=n)


def test_split_and_structure_refusals_are_pipe_tpus():
    model = TPPipelinedLM(LMConfig(**_cfg(2)), 1, tp_axis=None, device="cpu")
    with pytest.raises(ValueError, match="split_stage does not compose with "
                                         "stage_param_specs"):
        ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                          1, model, checkpoint="never", schedule="zb-h1",
                          device="cpu", split_stage="auto",
                          stage_param_specs=model.stage_param_specs())
    with pytest.raises(ValueError, match="stage_param_specs structure .* "
                                         "does not match the stacked stage "
                                         "params"):
        ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                          1, model, device="cpu",
                          stage_param_specs=[ttp.tp_block_specs()])
    # no model axis: the specs are checked and nothing is cut
    ex = ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                           1, model, device="cpu",
                           stage_param_specs=model.stage_param_specs())
    assert model.blocks[0].wqkv.shape[2] == HEADS
    assert ex.gather_model_grads({"x": torch.ones(1)})["x"].item() == 1.0
    assert {n for n, _ in model.named_parameters()
            if n.startswith("blocks.0.")} == {
        f"blocks.0.{n}" for n in _leaves(ttp.tp_block_specs())}


def test_model_leaves_and_specs_are_pipe_tpus():
    """``TPPipelinedLM``'s block leaves have JAX's names and shapes, its
    specs JAX's sharded dims, and the converted whole triple loads."""
    cfg = _cfg(2)
    jmodel = JTPLM(JLMConfig(**cfg), 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(0)))
    model = TPPipelinedLM(LMConfig(**cfg), 2, device="cpu")
    convert.load_pipelined_lm(model, params)
    want = _leaves(params[0][1][0])
    got = {n: p.detach().numpy() for n, p in
           model.blocks[1].named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
    jspecs = _leaves(jax.tree_util.tree_map(
        lambda s: np.asarray([-1 if a is None else 1 for a in s]),
        jmodel.stage_param_specs()[0], is_leaf=lambda v: isinstance(
            v, jax.sharding.PartitionSpec)))
    specs = ttp.tp_block_specs()
    for n, axes in jspecs.items():
        node = specs
        for k in n.split("."):
            node = node[k]
        assert [-1 if a is None else 1 for a in node] == list(axes), n
    assert len(model.stage_param_specs()) == model.layers_per_stage == 1


def test_convert_loads_whole_params_into_a_cut_model():
    """``shard_params`` cuts each sharded leaf to the rank's block of the
    dim its spec names (once: a second cut is a no-op, another line's
    raises), and ``convert`` loads ``pipe_tpu``'s whole params into the
    cut leaves, each its block of the whole array."""
    from types import SimpleNamespace

    from pipe_tpu_torch.parallel.mesh import flat_specs, shard_params

    cfg = _cfg(2)
    params = jax.tree_util.tree_map(np.asarray, JTPLM(
        JLMConfig(**cfg), 2).init(jax.random.key(0)))
    model = TPPipelinedLM(LMConfig(**cfg), 2, device="cpu")
    rank = SimpleNamespace(n_model=2, model=1)
    specs = flat_specs(model.stage_param_specs()[0])
    cut = shard_params(model.blocks[0], specs, rank)
    assert sorted(cut) == ["b1", "bqkv", "w1", "w2", "wo", "wqkv"]
    assert shard_params(model.blocks[0], specs, rank) == []
    with pytest.raises(ValueError, match="holds model shard 1 of 2"):
        shard_params(model.blocks[0], specs, SimpleNamespace(n_model=2,
                                                             model=0))
    convert.load_pipelined_lm(model, params)
    whole = _leaves(params[0][0][0])
    for n, p in model.blocks[0].named_parameters():
        dim = specs[n].dim_of("model")
        want = whole[n]
        if dim is not None:
            want = np.split(want, 2, axis=dim)[1]
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=n)
    assert model.blocks[0].wqkv.shape[2] == HEADS // 2
    assert model.blocks[1].wqkv.shape[2] == HEADS
