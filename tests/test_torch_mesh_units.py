"""The mesh slice's pieces that need no world of ranks, against pipe_tpu's.

* ``make_mesh``'s rank grid is JAX's device grid
  (``np.asarray(devices).reshape(n_stages, n_data)``), and
  ``global_pipeline_mesh``'s placements are ``pipe_tpu``'s, integer for
  integer.
* ``pack_words``/``unpack_words`` and ``StageParamPack`` rows byte-equal to
  JAX's for the same numpy trees; the stage-stacked and interleaved stackings
  equal; ``convert`` carries ``pipe_tpu``'s packed rows and interleaved
  stacking into the port's modules and puts port-named arrays back into
  ``pipe_tpu``'s layouts.
* C.16: on JAX's mesh the data shards of a micro-batch draw the same
  dropout masks (the key folds the stage only); the port's dropout draws a
  data rank's rows of the whole micro-batch's mask (``StageCtx.rows``, the
  kernels' ``bh_base``), so the halves of a batch equal the whole.
* The interleaved wavefront's tables, and the refusals that stay (context
  and model axes, overlapped transport, phase compilation, NCCL on one card)
  name their ROADMAP items.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
import pipe_tpu
from pipe_tpu.core import packing as jpacking
from pipe_tpu.models import transformer_lm as jlm
from pipe_tpu.parallel import buffers as jbuffers
from pipe_tpu.parallel import interleaved as jinter
from pipe_tpu.parallel import mesh as jmesh
from pipe_tpu.parallel import spmd as jspmd
from pipe_tpu.runtime import distributed as jdist
from pipe_tpu_torch import convert
from pipe_tpu_torch import pipe as tpipe_mod
from pipe_tpu_torch.core import packing as tpacking
from pipe_tpu_torch.core.schedule import BWD, FWD
from pipe_tpu_torch.models import transformer_lm as tlm
from pipe_tpu_torch.ops import flash_attention as fa
from pipe_tpu_torch.ops import layers as tl
from pipe_tpu_torch.parallel import buffers as tbuffers
from pipe_tpu_torch.parallel import interleaved as tinter
from pipe_tpu_torch.parallel import mesh as tmesh
from pipe_tpu_torch.parallel import spmd as tspmd
from pipe_tpu_torch.runtime import distributed as tdist


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("n_stages,n_data", [(2, 2), (4, 1), (1, 4), (2, 4)])
def test_make_mesh_grid_is_jax_device_grid(n_stages, n_data):
    devices = jax.devices()[:n_stages * n_data]
    jgrid = np.vectorize(lambda d: d.id)(
        jmesh.make_mesh(n_stages, n_data, devices=devices).devices)
    ids = np.array([d.id for d in devices])
    np.testing.assert_array_equal(ids[tmesh.mesh_grid(n_stages, n_data)],
                                  jgrid)
    for across in (False, True):
        jg = np.vectorize(lambda d: d.id)(jdist.global_pipeline_mesh(
            n_stages, n_data, devices=devices, stage_across=across).devices)
        np.testing.assert_array_equal(
            ids[tdist.pipeline_grid(n_stages, n_data, across)], jg)


def test_pack_words_bytes_equal_jax():
    rng = np.random.default_rng(0)
    tree = {"b": [rng.standard_normal((3, 5)).astype(np.float32),
                  rng.integers(-9, 9, (7,)).astype(np.int8)],
            "a": rng.integers(-300, 300, (5,)).astype(np.int16),
            "c": {"z": rng.integers(0, 255, (2, 3)).astype(np.uint8),
                  "y": rng.integers(-5, 5, (4,)).astype(np.int32)},
            "d": rng.standard_normal((3,)).astype(np.float32)}
    jw = np.asarray(jbuffers.pack_words(jax.tree_util.tree_map(jnp.asarray,
                                                               tree)))
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    tw = tbuffers.pack_words(ttree)
    assert tw.numpy().tobytes() == jw.tobytes()
    assert tbuffers.packed_words(ttree) == jbuffers.packed_words(tree) \
        == tw.numel()
    back = tbuffers.unpack_words(tw, ttree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # bf16 rides beside f32 bit for bit
    h = torch.randn(5).bfloat16()
    jh = jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)
    assert tbuffers.pack_words([h]).numpy().tobytes() == \
        np.asarray(jbuffers.pack_words([jh])).tobytes()
    with pytest.raises(TypeError, match="bool"):
        tbuffers.pack_words([torch.ones(2, dtype=torch.bool)])


def _jax_lm_params(n_parts):
    cfg = jlm.LMConfig().tiny()
    pipe = pipe_tpu.Pipe(jlm.build_sequential(cfg), chunks=2,
                         n_stages=n_parts)
    return _np(pipe.init(jax.random.key(3),
                         jnp.zeros((2, cfg.seq_len), jnp.int32)))


@pytest.mark.parametrize("n_parts", [2, 4])
def test_stage_param_pack_rows_equal_jax(n_parts):
    params = _jax_lm_params(n_parts)
    jpack = jpacking.StageParamPack(params)
    mesh = jmesh.make_mesh(n_parts, 1, devices=jax.devices()[:n_parts])
    jrows = {dt: np.asarray(a) for dt, a in jpack.shard(mesh,
                                                        params).items()}
    tpack = tpacking.StageParamPack(params)
    trows = tpack.rows_np(params)
    assert tpack.capacities == jpack.capacities
    assert sorted(trows) == sorted(jrows)
    for dt in jrows:
        assert trows[dt].tobytes() == jrows[dt].tobytes()
    assert tpack.per_device_bytes() == jpack.per_device_bytes()
    assert tpack.total_param_bytes() == jpack.total_param_bytes()
    for a, b in zip(jax.tree_util.tree_leaves(tpack.unshard(trows)),
                    jax.tree_util.tree_leaves(jpack.unshard(jrows))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="different") as terr:
        tpack.check_packed({dt: r[:, 1:] for dt, r in trows.items()})
    with pytest.raises(ValueError, match="different") as jerr:
        jpack.check_packed({dt: r[:, 1:] for dt, r in jrows.items()})
    assert str(terr.value) == str(jerr.value)


def _port_pipe(n_parts):
    cfg = tlm.LMConfig().tiny()
    import pipe_tpu_torch
    return pipe_tpu_torch.Pipe(tlm.build_sequential(cfg, device="cpu"),
                               chunks=2, n_stages=n_parts, device="cpu")


@pytest.mark.parametrize("n_parts,v", [(2, 1), (4, 2)])
def test_convert_packed_rows_and_back(n_parts, v):
    """``pipe_tpu``'s packed rows (device-major when interleaved) load into
    the port's partitions as its per-stage trees do; the port's named arrays
    go back into ``pipe_tpu``'s trees exactly."""
    params = _jax_lm_params(n_parts)
    d = n_parts // v
    order = [(r % v) * d + r // v for r in range(n_parts)]
    rows = tpacking.StageParamPack([params[s] for s in order]).rows_np(
        [params[s] for s in order])
    got, want = _port_pipe(n_parts), _port_pipe(n_parts)
    convert.load_packed_rows(got, rows, params, v=v)
    convert.load_stage_params(want, params)
    for a, b in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, b)
    named = {n: p.detach().numpy() for n, p in got.named_parameters()}
    back = convert.stage_trees(got, named, params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_stackings_equal_jax_and_convert_reads_them():
    cfg = jlm.LMConfig().tiny()
    jmodel = jlm.PipelinedLM(cfg, 4)
    sp, pre, post = _np(jmodel.init(jax.random.key(4)))
    for stacked_j, stacked_t in (
            (jspmd.stack_stage_params(sp), tspmd.stack_stage_params(sp)),
            (jinter.stack_interleaved_params(sp, 2),
             tinter.stack_interleaved_params(sp, 2))):
        for a, b in zip(jax.tree_util.tree_leaves(_np(stacked_j)),
                        jax.tree_util.tree_leaves(stacked_t)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(
            jax.tree_util.tree_leaves(tinter.unstack_interleaved_params(
                tinter.stack_interleaved_params(sp, 2), 2)),
            jax.tree_util.tree_leaves(sp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(tspmd.unstack_stage_params(
            tspmd.stack_stage_params(sp), 4)), jax.tree_util.tree_leaves(sp)):
        np.testing.assert_array_equal(a, b)
    # the interleaved stacking loads as the per-stage list does, and the
    # port's names go back into the stage-stacked layout
    tcfg = tlm.LMConfig().tiny()
    got = tlm.PipelinedLM(tcfg, 4, device="cpu")
    want = tlm.PipelinedLM(tcfg, 4, device="cpu")
    convert.load_pipelined_lm(got, (tinter.stack_interleaved_params(sp, 2),
                                    pre, post), interleaved_devices=2)
    convert.load_pipelined_lm(want, (sp, pre, post))
    for a, b in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, b)
    stacked = tspmd.stack_stage_params(sp)
    named = {n: p.detach().numpy() for n, p in got.named_parameters()}
    back = convert.pipelined_lm_tree(got, named, (stacked, pre, post))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves((stacked, pre, post))):
        np.testing.assert_array_equal(a, b)


def test_jax_data_shards_share_dropout_masks_c16():
    """C.16, in the reference: a ``(stage 1, data 2)`` SpmdPipeline whose
    stage drops half its input draws one mask per micro-batch and stage,
    the same on both data shards (``axis_index(STAGE_AXIS)`` is all the key
    folds in), so a mesh step with dropout is not the one-device step."""
    def stage_fn(params, h, ctx):
        keep = jax.random.bernoulli(ctx.key, 0.5, h.shape)
        return jnp.where(keep, h, 0.0)

    mesh = jmesh.make_mesh(1, 2, devices=jax.devices()[:2])
    pipe = jspmd.SpmdPipeline(mesh, stage_fn)
    x = jnp.ones((2, 4, 64))
    out = np.asarray(pipe({"w": jnp.zeros((1, 1))}, None, None, x,
                          key=jax.random.key(0), train=True))
    assert np.array_equal(out[:, :2], out[:, 2:])     # both shards: one mask
    assert 0 < out.mean() < 1


def test_port_dropout_rows_are_the_whole_batch_masks_c16():
    """The port's repair: a data rank's rows draw rows ``offset ..`` of the
    whole micro-batch's mask, for the plain dropout and for the flash
    kernels' Philox mask (``bh_base``); two halves make the whole."""
    x = torch.randn(4, 6, 8)
    whole = tl._dropout(x, 0.5, 123)
    halves = torch.cat([tl._dropout(x[:2], 0.5, 123, (0, 4)),
                        tl._dropout(x[2:], 0.5, 123, (2, 4))])
    assert torch.equal(whole, halves)
    assert not torch.equal(tl._dropout(x[2:], 0.5, 123), whole[2:])
    b, h, s, d = 4, 2, 16, 8
    q, k, v = (torch.randn(b * h, s, d) for _ in range(3))
    kw = dict(causal=True, scale=d ** -0.5, seed=77, rate=0.3)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o0, _ = fa.flash_attention_fwd(q[:4], k[:4], v[:4], **kw)
    o1, _ = fa.flash_attention_fwd(q[4:], k[4:], v[4:], bh_base=4, **kw)
    torch.testing.assert_close(torch.cat([o0, o1]), o, rtol=0, atol=0)
    do = torch.randn_like(q)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dq1 = fa.flash_attention_bwd_dq(q[4:], k[4:], v[4:], do[4:], lse[4:],
                                    delta[4:], bh_base=4, **kw)
    torch.testing.assert_close(dq1, dq[4:], rtol=0, atol=0)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dk1, dv1 = fa.flash_attention_bwd_dkv(q[4:], k[4:], v[4:], do[4:],
                                          lse[4:], delta[4:], bh_base=4, **kw)
    torch.testing.assert_close(dk1, dk[4:], rtol=0, atol=0)
    torch.testing.assert_close(dv1, dv[4:], rtol=0, atol=0)
    # the attention layer passes the row offset times the heads
    out = fa.flash_attention(q.view(b, h, s, d).transpose(1, 2)[2:],
                             k.view(b, h, s, d).transpose(1, 2)[2:],
                             v.view(b, h, s, d).transpose(1, 2)[2:],
                             dropout_rate=0.3, dropout_seed=77,
                             dropout_row_base=2)
    torch.testing.assert_close(out.transpose(1, 2).reshape(4, s, d), o[4:],
                               rtol=0, atol=0)


@pytest.mark.parametrize("m,d,v", [(4, 2, 2), (8, 4, 2), (4, 4, 3),
                                   (2, 2, 1)])
def test_interleaved_wavefront_tables(m, d, v):
    """Each (micro-batch, virtual stage) once forward and once backward on
    device ``s % d``; JAX's forward cycle ``k + p``; a stage's forward
    after its input's, its backward after the next stage's; ``m < d``
    refused with an interleave."""
    op, mbi, grp = tinter.InterleavedWavefront(interleave=v).op_tables(m, d)
    fwd, bwd = {}, {}
    for t in range(op.shape[0]):
        for p in range(d):
            s, i = int(grp[t, p]) * d + p, int(mbi[t, p])
            if op[t, p] == FWD:
                assert (i, s) not in fwd
                fwd[(i, s)] = t
            elif op[t, p] == BWD:
                assert (i, s) not in bwd
                bwd[(i, s)] = t
    S = v * d
    assert set(fwd) == set(bwd) == {(i, s) for i in range(m)
                                    for s in range(S)}
    for (i, s), t in fwd.items():
        g, p = divmod(s, d)
        assert t == g * m + i + p
        if s:
            assert fwd[(i, s - 1)] < t
        if s < S - 1:
            assert bwd[(i, s + 1)] < bwd[(i, s)]
        assert max(fwd.values()) < bwd[(i, s)]
    if v > 1:
        with pytest.raises(ValueError, match="chunks >= n_devices"):
            tinter.InterleavedWavefront(interleave=v).op_tables(d - 1, d)


def test_refusals_name_their_items(monkeypatch):
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
    from pipe_tpu_torch.ops.layers import Linear

    # the context and model axes are ported: make_mesh(n_context=) and
    # make_mesh(n_model=) need a world like any mesh, context_axis a mesh
    # with the axis, and stage_param_specs a spec tree of the stage's
    # blocks (JAX's words)
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_mesh(2, 1, n_context=2)
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_mesh(2, 1, n_model=2)
    for field, exc, words in (
            ("context_axis", ValueError,
             "mesh has no 'context' axis for context_axis"),
            ("stage_param_specs", ValueError,
             "stage_param_specs needs a module whose stage_blocks")):
        with pytest.raises(exc, match=words):
            ScheduledPipeline(lambda s, h, c: h, lambda x, c: x,
                              lambda h, x, c: h, n_stages=1,
                              module=Linear(2, 2, device="cpu"),
                              device="cpu", **{field: "context"})
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_mesh(2, 2)
    with pytest.raises(ValueError, match="'nccl' moves CUDA"):
        tdist.initialize("nccl", rank=0, world_size=4,
                         init_method="file:///nonexistent", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="Duplicate GPU detected"):
        tdist.initialize("nccl", rank=0, world_size=4,
                         init_method="file:///nonexistent", device="cuda")
    assert not torch.distributed.is_initialized()


def test_init_weights_draws_each_layer_by_its_rule():
    """``Pipe.init_sharded``'s initializer: the constructors' rules, drawn
    afresh from a generator (two draws from one seed agree)."""
    cfg = dataclasses.replace(tlm.LMConfig().tiny(), n_layers=1)
    a = tlm.build_sequential(cfg, device="cpu")
    b = tlm.build_sequential(cfg, device="cpu")
    tpipe_mod.init_weights(a, torch.Generator().manual_seed(5))
    tpipe_mod.init_weights(b, torch.Generator().manual_seed(5))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    block = a[2]
    assert torch.equal(block.attn.wq.bias, torch.zeros_like(block.attn.wq.bias))
    assert torch.equal(block.ln1.weight, torch.ones_like(block.ln1.weight))
    bound = 1 / cfg.d_model ** 0.5
    assert block.ff1.weight.abs().max() <= bound


def test_initialize_reads_torchruns_environment():
    """With ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``
    set (what ``torchrun`` sets), ``initialize`` joins by ``env://``; a
    1-rank mesh runs a collective (in a fresh interpreter: the test
    process stays outside any world)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (
        "import torch\n"
        "from pipe_tpu_torch.runtime import distributed as d\n"
        "from pipe_tpu_torch.parallel.mesh import make_mesh\n"
        "d.initialize('gloo', device='cpu', timeout=30)\n"
        "m = make_mesh(1)\n"
        "t = torch.ones(2)\n"
        "m.all_reduce(t, 'world')\n"
        "print(d.process_summary(), m.stage, m.data, t.tolist())\n")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "process 0/1 | backend gloo | device cpu 0 0 [1.0, 1.0]" in \
        out.stdout
