"""pipe_tpu_torch's MoE layer and block (``ops/moe.py``) on one device,
against pipe_tpu's.

The leaves keep ``pipe_tpu``'s names and layouts, so JAX's ``moe_ffn_init``
and ``moe_block_init`` params load as they are. At ``ep_axis=None`` (no
mesh): ``moe_ffn_apply``'s output, aux loss and every gradient of
``sum(out ** 2) + 0.01 * aux`` against JAX's (tests/test_moe.py's
tolerances: rtol 1e-5 on the loss, rtol 3e-4 / atol 1e-5 on the
gradients), at k 1 and 2 and at a capacity that drops tokens; the GShard
capacity over a grid; the drop law; ``moe_block_apply`` and
``moe_block_decode`` against JAX's (2e-5, tests/test_moe_gen.py); a planted
tie routed as ``jax.lax.top_k`` routes it (the lower index first); the
model line's all-reduces counted on a stand-in line (two a MoE layer, three
a block, forward and backward; no all-to-all); the refusals in JAX's words.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.core.partition import StageCtx as JCtx
from pipe_tpu.models.moe_lm import MoELMConfig as JMoECfg
from pipe_tpu.models.moe_lm import MoEPipelinedLM as JMoELM
from pipe_tpu.ops import moe as jmoe
from pipe_tpu_torch import convert
from pipe_tpu_torch.models.moe_lm import MoELMConfig, MoEPipelinedLM
from pipe_tpu_torch.ops import moe as tmoe
from pipe_tpu_torch.parallel.mesh import flat_specs, shard_params

D, FF, E, ROWS, SEQ = 8, 16, 4, 2, 8
HEADS = 2


def _ffn_params(seed=0, e=E):
    return jax.tree_util.tree_map(
        np.array, jmoe.moe_ffn_init(jax.random.key(seed), D, FF, e))


def _h(seed=1, rows=ROWS, seq=SEQ, d=D):
    return np.random.default_rng(seed).standard_normal(
        (rows, seq, d)).astype(np.float32)


def _jax_ffn(params, h, k, cf):
    def loss(p, x):
        out, aux = jmoe.moe_ffn_apply(p, x, JCtx(), n_experts=E, k=k,
                                      capacity_factor=cf, ep_axis=None)
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

    (l, (out, aux)), (g, gh) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(h))
    return float(l), np.asarray(out), float(aux), g, np.asarray(gh)


def _port_ffn(params, h, k, cf):
    p = {n: torch.tensor(v, requires_grad=True) for n, v in params.items()}
    x = torch.from_numpy(h).requires_grad_()
    out, aux = tmoe.moe_ffn_apply(p, x, n_experts=E, k=k, capacity_factor=cf)
    loss = (out ** 2).sum() + 0.01 * aux
    loss.backward()
    return loss.item(), out.detach().numpy(), aux.item(), \
        {n: t.grad.numpy() for n, t in p.items()}, x.grad.numpy()


@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.25), (2, 0.5)])
def test_moe_ffn_matches_pipe_tpu(k, cf):
    params, h = _ffn_params(), _h()
    l_ref, out_ref, aux_ref, g_ref, gh_ref = _jax_ffn(params, h, k, cf)
    l, out, aux, g, gh = _port_ffn(params, h, k, cf)
    np.testing.assert_allclose(l, l_ref, rtol=1e-5)
    np.testing.assert_allclose(out, out_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, aux_ref, rtol=1e-6)
    np.testing.assert_allclose(gh, gh_ref, rtol=3e-4, atol=1e-5)
    assert set(g) == set(g_ref)
    for n in g_ref:
        np.testing.assert_allclose(g[n], np.asarray(g_ref[n]), rtol=3e-4,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("n_tokens,n_experts,k,cf", [
    (16, 4, 1, 0.1), (16, 4, 2, 1.25), (1024, 8, 2, 1.25), (7, 3, 2, 1.0),
    (2, 8, 2, 1.25), (4096, 8, 1, 2.0), (33, 5, 3, 0.7), (1, 1, 1, 1.0)])
def test_moe_capacity_is_pipe_tpus(n_tokens, n_experts, k, cf):
    assert tmoe.moe_capacity(n_tokens, n_experts, k, cf) == \
        jmoe.moe_capacity(n_tokens, n_experts, k, cf)


def test_capacity_drops_overflow_as_pipe_tpu():
    """tests/test_moe.py's law: at capacity 1 a slot per expert most tokens
    fall through (zero output), more than at a generous capacity; the
    dropped tokens are JAX's (the outputs equal), slot 0 of every token
    goes first, and the layer still differentiates to finite gradients."""
    params, h = _ffn_params(), _h()
    p = {n: torch.tensor(v) for n, v in params.items()}
    x = torch.from_numpy(h)
    assert tmoe.moe_capacity(ROWS * SEQ, E, 1, 0.1) == 1
    zeros = {}
    for cf in (4.0, 0.1):
        out, _ = tmoe.moe_ffn_apply(p, x, n_experts=E, k=1,
                                    capacity_factor=cf)
        jout = _jax_ffn(params, h, 1, cf)[1]
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-6)
        zeros[cf] = int((out == 0).all(dim=-1).sum())
    assert zeros[0.1] > zeros[4.0]
    # at capacity 1 the kept tokens are the first to choose each expert
    gates = torch.softmax(x.reshape(-1, D) @ p["wr"] + p["br"], -1)
    first = {int(e): t for t, e in reversed(list(enumerate(
        gates.argmax(-1).tolist())))}
    kept = (out.reshape(-1, D) != 0).any(-1).nonzero().flatten().tolist()
    assert sorted(first.values()) == kept
    q = {n: torch.tensor(v, requires_grad=True) for n, v in params.items()}
    (tmoe.moe_ffn_apply(q, x, n_experts=E, k=1, capacity_factor=0.1)[0]
     ** 2).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in q.values())


def test_planted_top_k_tie_routes_as_pipe_tpu():
    """Two experts with the same router column get equal gates for every
    token: ``jax.lax.top_k`` puts the lower index first, and so does the
    port (``torch.topk`` promises no order), at k 1 (which expert takes the
    token) and k 2 (which slot goes first for capacity)."""
    params = _ffn_params()
    params["wr"][:, 2] = params["wr"][:, 1]
    params["wr"][:, 3] = params["wr"][:, 1] * 0.25
    h = _h()
    gates = torch.softmax(torch.from_numpy(h).reshape(-1, D)
                          @ torch.from_numpy(params["wr"]), -1)
    vals, idx = tmoe._top_k(gates, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (gates[:, 1] == gates[:, 2]).all()
    assert ((idx == 1) | (idx == 2)).any()
    for k in (1, 2):
        l_ref, out_ref, _, g_ref, _ = _jax_ffn(params, h, k, 0.5)
        l, out, _, g, _ = _port_ffn(params, h, k, 0.5)
        np.testing.assert_allclose(out, out_ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["w1"], np.asarray(g_ref["w1"]),
                                   rtol=3e-4, atol=1e-5)


def _block_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, jmoe.moe_block_init(
        jax.random.key(seed), D, HEADS, FF, E))


def _port_block(params, causal=True, cf=4.0, **kw):
    blk = tmoe.MoEBlock(D, HEADS, FF, E, 2, cf, causal=causal, ep_axis=None,
                        device="cpu", **kw)
    convert.load_params(blk, params)
    return blk


@pytest.mark.parametrize("causal", [True, False])
def test_moe_block_apply_matches_pipe_tpu(causal):
    """The block's forward and its parameters' gradients of ``sum(out **
    2) + 0.01 * aux`` against JAX's ``moe_block_apply`` at the default
    capacity (tokens dropped)."""
    params, h = _block_params(), _h(2, 2, 12)

    def loss(p, x):
        out, aux = jmoe.moe_block_apply(p, x, JCtx(train=False), n_experts=E,
                                        k=2, causal=causal, ep_axis=None)
        return jnp.sum(out ** 2) + 0.01 * aux, out

    (l_ref, out_ref), g_ref = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params, jnp.asarray(h))
    blk = _port_block(params, causal, cf=1.25)
    out, aux = tmoe.moe_block_apply(blk.tree(), torch.from_numpy(h),
                                    n_experts=E, k=2, causal=causal)
    l = (out ** 2).sum() + 0.01 * aux
    l.backward()
    np.testing.assert_allclose(l.item(), float(l_ref), rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(blk(torch.from_numpy(h)), out.detach())
    # the diagnostic's count: none at a drop-free capacity, some at 0.25
    x = torch.from_numpy(h)
    assert _port_block(params, causal, cf=4.0).dropped_slots(x) == 0
    assert 0 < _port_block(params, causal, cf=0.25).dropped_slots(x) < 48
    want = jax.tree_util.tree_map(np.asarray, g_ref)
    for n, p in blk.named_parameters():
        node = want
        for key in n.split("."):
            node = node[key]
        np.testing.assert_allclose(p.grad.numpy(), node, rtol=3e-4,
                                   atol=1e-5, err_msg=n)


def test_moe_block_decode_matches_pipe_tpu_and_its_apply():
    """tests/test_moe_gen.py's case: a prefill through the decode (no mesh)
    equals the apply at a drop-free capacity, and JAX's decode; one more
    token's decode equals JAX's; the cache past it stays zero."""
    params, h = _block_params(), _h(3, 2, 12)
    blk = _port_block(params)
    cache = blk.attn.make_cache(2, 16)
    with torch.no_grad():
        ref = blk(torch.from_numpy(h))
        out, cache = blk.decode(torch.from_numpy(h), cache, 0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    jcache = {"k": jnp.zeros((2, 16, HEADS, D // HEADS)),
              "v": jnp.zeros((2, 16, HEADS, D // HEADS))}
    decode = jax.jit(lambda p, x, c, pos: jmoe.moe_block_decode(
        p, x, c, pos, n_experts=E, k=2, capacity_factor=4.0, ep_axis=None),
        static_argnums=3)
    jout, jcache = decode(params, jnp.asarray(h), jcache, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    step = _h(4, 2, 1)
    with torch.no_grad():
        out2, cache = blk.decode(torch.from_numpy(step), cache, 12)
    jout2, _ = decode(params, jnp.asarray(step), jcache, 12)
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout2), rtol=2e-5,
                               atol=2e-5)
    assert not cache["k"][:, 13:].any()
    with pytest.raises(ValueError, match="KV-cache decode requires causal"):
        _port_block(params, causal=False).decode(
            torch.from_numpy(step), blk.attn.make_cache(2, 16), 0)


class _Line:
    """A stand-in model line of 2 (rank 0): its all-reduce leaves the
    tensor as it is and counts the call; it has no all-to-all."""

    model_size = n_model = 2
    model = 0

    def __init__(self):
        self.calls = 0

    def all_reduce(self, t, over):
        assert over == "model"
        self.calls += 1


def test_two_allreduces_a_moe_layer_three_a_block():
    """The communication is all-reduces over the model line, not an
    all-to-all: a MoE layer does two forward (the router's logits, the
    output) and two backward (``tp_enter`` of its input and of the
    logits), a block three each (attention's one more)."""
    params = _block_params()
    blk = _port_block(params)
    line = _Line()
    blk.mesh, blk.ep_axis = line, "model"
    shard_params(blk, flat_specs(tmoe.moe_block_specs()), line)
    assert blk.moe.w1.shape[0] == E // 2 and blk.wqkv.shape[2] == HEADS // 2
    x = torch.from_numpy(_h()).requires_grad_()
    p = blk.tree()
    out, aux = tmoe.moe_ffn_apply(p["moe"], x, n_experts=E, mesh=line)
    assert line.calls == 2
    ((out ** 2).sum() + aux).backward()
    assert line.calls == 4
    line.calls = 0
    blk(x).sum().backward()
    assert line.calls == 6


def test_refusals_are_pipe_tpus():
    """An expert count the line does not divide, in JAX's words (the layer
    and the block); a block with whole experts over a line of 2."""
    params = _ffn_params(e=3)
    p = {n: torch.tensor(v) for n, v in params.items()}
    msg = ("n_experts=3 not divisible by the expert-axis size 2: orphaned "
           "experts would receive router mass but produce zero output")
    with pytest.raises(ValueError) as e:
        tmoe.moe_ffn_apply(p, torch.zeros(1, 2, D), n_experts=3,
                           mesh=_Line())
    assert str(e.value) == msg
    blk = tmoe.MoEBlock(D, HEADS, FF, 3, device="cpu", mesh=_Line())
    with pytest.raises(ValueError) as e:
        blk(torch.zeros(1, 2, D))
    assert str(e.value) == msg
    blk = tmoe.MoEBlock(D, HEADS, FF, E, device="cpu", mesh=_Line())
    with pytest.raises(ValueError, match="holds 4 of 4 experts over a model "
                                         "line of 2"):
        blk(torch.zeros(1, 2, D))
    with pytest.raises(ValueError, match="ep_axis must be"):
        tmoe.MoEBlock(D, HEADS, FF, E, device="cpu", ep_axis="data")


def test_model_leaves_and_specs_are_pipe_tpus():
    """``MoEPipelinedLM``'s block leaves have JAX's names and shapes (drawn
    at 1/sqrt(fan-in), biases zero), its specs JAX's sharded dims, its
    config JAX's defaults, and the converted whole triple loads; the
    model's ``tp_axis`` is its ``ep_axis``."""
    cfg = dict(vocab=61, d_model=D, nhead=HEADS, d_ff=FF, seq_len=SEQ,
               n_layers=2, dropout=0.0, n_experts=E)
    jmodel = JMoELM(JMoECfg(**cfg), 2)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.key(0)))
    model = MoEPipelinedLM(MoELMConfig(**cfg), 2, device="cpu")
    fresh = {n: p.detach().numpy().copy()
             for n, p in model.blocks[1].named_parameters()}
    convert.load_pipelined_lm(model, params)
    want = {}
    for n, v in jax.tree_util.tree_leaves_with_path(params[0][1][0]):
        want[".".join(k.key for k in n)] = np.asarray(v)
    got = {n: p.detach().numpy() for n, p in
           model.blocks[1].named_parameters()}
    assert set(got) == set(want) == set(fresh)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
        assert fresh[n].shape == want[n].shape, n
        if n.split(".")[-1].startswith("b"):
            assert not fresh[n].any(), n
    assert abs(fresh["moe.w2"].std() * np.sqrt(FF) - 1) < 0.2
    jspecs = jax.tree_util.tree_map(
        lambda s: [-1 if a is None else 1 for a in s],
        jmodel.stage_param_specs()[0],
        is_leaf=lambda v: isinstance(v, jax.sharding.PartitionSpec))
    for n, spec in flat_specs(tmoe.moe_block_specs()).items():
        node = jspecs
        for k in n.split("."):
            node = node[k]
        assert [-1 if a is None else 1 for a in spec] == list(node), n
    assert len(model.stage_param_specs()) == model.layers_per_stage == 1
    assert model.tp_axis == model.ep_axis == "model"
    base = JMoECfg()
    port = MoELMConfig()
    assert (port.n_experts, port.top_k, port.capacity_factor) == (
        base.n_experts, base.top_k, base.capacity_factor) == (8, 2, 1.25)


def test_convert_loads_whole_params_into_a_cut_model():
    """``shard_params`` cuts the nested ``moe.*`` leaves and the heads to
    the rank's block, and ``convert`` loads JAX's whole params into the cut
    leaves, each its block of the whole array; ``pipelined_lm_arrays`` maps
    JAX's whole gradients onto a cut rank's blocks."""
    cfg = dict(vocab=61, d_model=D, nhead=HEADS, d_ff=FF, seq_len=SEQ,
               n_layers=2, dropout=0.0, n_experts=E)
    params = jax.tree_util.tree_map(np.asarray, JMoELM(
        JMoECfg(**cfg), 2).init(jax.random.key(0)))
    model = MoEPipelinedLM(MoELMConfig(**cfg), 2, device="cpu")
    rank = SimpleNamespace(n_model=2, model=1)
    specs = flat_specs(model.stage_param_specs()[0])
    cut = shard_params(model.blocks[0], specs, rank)
    assert sorted(cut) == ["bqkv", "moe.b1", "moe.b2", "moe.br", "moe.w1",
                           "moe.w2", "moe.wr", "wo", "wqkv"]
    convert.load_pipelined_lm(model, params)
    whole = {".".join(k.key for k in n): np.asarray(v) for n, v in
             jax.tree_util.tree_leaves_with_path(params[0][0][0])}
    arrays = convert.pipelined_lm_arrays(model, params)
    for n, p in model.blocks[0].named_parameters():
        dim = specs[n].dim_of("model")
        want = whole[n] if dim is None else np.split(whole[n], 2, axis=dim)[1]
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=n)
        np.testing.assert_array_equal(arrays[f"blocks.0.{n}"], want)
    assert model.blocks[0].moe.wr.shape == (D, E // 2)
    assert model.blocks[1].moe.w1.shape[0] == E
