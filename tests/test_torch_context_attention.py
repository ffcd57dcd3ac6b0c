"""pipe_tpu_torch's context axis (``parallel/mesh.py``), ring and Ulysses
attention (``ops/ring_attention.py``, ``ops/ulysses_attention.py``) and
``context_parallel_attention`` against pipe_tpu's.

One 4-rank gloo world of CPU ranks is spawned for the module and fed the
cases of ``tests/torch_context_cases.py`` (no JAX there). A context axis of
2 runs as two data replicas of a 2-rank line, one of 4 as the whole world.
The JAX references run once per module on the virtual CPU devices:
``context_parallel_attention`` under ``shard_map`` over
``make_context_mesh(n)``, its gradients of ``sum(o ** 2)`` by ``jax.grad``,
and ``blockwise_attention_reference``, on the same numpy inputs; the port
is held to them within 1e-5 x max(1, max|ref|), causal and not, at
``n_context`` 2 and 4, the fully masked causal blocks of the ring at 4
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_context_cases as cases
from torch_threads import one_torch_thread  # noqa: F401
from pipe_tpu.ops.ring_attention import blockwise_attention_reference as jref
from pipe_tpu.parallel.context import context_parallel_attention as jcpa
from pipe_tpu.parallel.context import make_context_mesh
from pipe_tpu.parallel.mesh import make_mesh as jmake_mesh
from pipe_tpu_torch.ops.ring_attention import (blockwise_attention_reference,
                                               ring_attention)
from pipe_tpu_torch.ops.ulysses_attention import ulysses_attention
from pipe_tpu_torch.parallel.context import context_parallel_attention
from pipe_tpu_torch.runtime import World

SHAPES = {2: (1, 2, 2), 4: (1, 1, 4)}      # (stages, data, context)
RTOL = 1e-5                                # x max(1, max|ref|)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with World(4, device="cpu", timeout=60, threads=1,
               store_dir=str(tmp_path_factory.mktemp("store"))) as w:
        yield w


def _qkv(seed=0, b=2, s=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for _ in range(3))


_JAX = {}


def _jax_run(fn, q, k, v):
    """``fn``'s output and its gradients of ``sum(o ** 2)``, one jitted
    program."""
    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o ** 2), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in grads]


def _jax(impl, causal, n):
    """JAX's output and input gradients of ``sum(o ** 2)`` through
    ``context_parallel_attention`` over ``n`` devices, and the oracle's."""
    q, k, v = (jnp.asarray(a) for a in _qkv())
    if ("ref", causal) not in _JAX:
        _JAX[("ref", causal)] = _jax_run(
            lambda *a: jref(*a, causal=causal), q, k, v)
    if (impl, causal, n) not in _JAX:
        mesh = make_context_mesh(n)
        _JAX[(impl, causal, n)] = _jax_run(
            lambda *a: jcpa(mesh, *a, causal=causal, impl=impl), q, k, v)
    return {"cp": _JAX[(impl, causal, n)], "ref": _JAX[("ref", causal)]}


def _close(got, want):
    tol = RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _assembled(res, n):
    """The global output and gradients from the first context line's
    shards."""
    line = sorted(res[:n], key=lambda r: r["context"])
    o = np.concatenate([r["o"] for r in line], axis=1)
    grads = [np.concatenate([r["grads"][i] for r in line], axis=1)
             for i in range(3)]
    return o, grads


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_matches_pipe_tpu(world, impl, causal, n):
    """Forward and gradients of every rank's shard against JAX's
    ``context_parallel_attention`` under ``shard_map`` and against the
    blockwise oracle; every data replica of the line agrees bit for bit;
    every gradient is finite (the ring's fully masked causal blocks at 4
    ranks among them)."""
    q, k, v = _qkv()
    res = world.run(cases.attention, SHAPES[n], q, k, v, causal, impl)
    o, grads = _assembled(res, n)
    want = _jax(impl, causal, n)
    for name in ("cp", "ref"):
        _close(o, want[name][0])
        for g, w in zip(grads, want[name][1]):
            _close(g, w)
    assert all(r["finite"] for r in res)
    if n == 2:                          # the other data replica's line
        o2, grads2 = _assembled(res[2:], n)
        np.testing.assert_array_equal(o2, o)
        for a, b in zip(grads2, grads):
            np.testing.assert_array_equal(a, b)


def test_ring_fully_masked_blocks_have_zero_gradient(world):
    """Causal at 4 ranks, a loss on context rank 0's output shard only:
    its queries see none of the blocks born on ranks 1-3, which visit it
    fully masked, so those ranks' K/V gradients are exactly zero (finite,
    not NaN), and every gradient is the oracle's for that loss."""
    q, k, v = _qkv(seed=3)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = blockwise_attention_reference(*ins, causal=True)
    (o[:, :8] ** 2).sum().backward()
    res = world.run(cases.attention, SHAPES[4], q, k, v, True, "ring",
                    False, True)
    _, grads = _assembled(res, 4)
    for g, ref in zip(grads, ins):
        assert np.isfinite(g).all()
        _close(g, ref.grad.numpy())
    assert not grads[1][:, 8:].any() and not grads[2][:, 8:].any()


def test_ulysses_runs_the_flash_attention_wrappers(world):
    """Ulysses' default attention through ``flash_attention`` (its plain
    versions on the CPU, the route forced as on the card): each rank
    calls the forward, dQ and dK/dV wrappers once for its ``heads / c``
    heads at the full sequence, and the result is JAX's."""
    q, k, v = _qkv()
    res = world.run(cases.attention, SHAPES[4], q, k, v, True, "ulysses",
                    True)
    assert [r["calls"] for r in res] == [{"fwd": 1, "dq": 1, "dkv": 1}] * 4
    o, grads = _assembled(res, 4)
    want = _jax("ulysses", True, 4)["cp"]
    _close(o, want[0])
    for g, w in zip(grads, want[1]):
        _close(g, w)


@pytest.mark.parametrize("shape", [(1, 1, 4), (2, 1, 2), (1, 2, 2)])
def test_mesh_context_axis_is_jax_grid(world, shape):
    """``make_mesh(S, D, n_context=C)``: the grid is JAX's device grid
    ``(stage, data, context)`` over ranks, each rank's coordinates and
    stage neighbours follow it, the context shift moves one hop each way,
    the tiled all-to-all is JAX's (and its reverse undoes it), the sum
    and max span the line and the plane sum the stage's (data, context)
    plane; each is counted in the stats."""
    S, D, C = shape
    jgrid = np.vectorize(lambda d: d.id)(
        jmake_mesh(S, D, n_context=C, devices=jax.devices()[:4]).devices)
    res = world.run(cases.mesh_units, shape)
    for r in res:
        np.testing.assert_array_equal(np.array(r["grid"]), jgrid)
        s, d, c = r["stage"], r["data"], r["context"]
        assert jgrid[s, d, c] == r["rank"]
        assert r["axis_names"] == ["stage", "data", "context"]
        assert r["prev"] == jgrid[(s - 1) % S, d, c]
        assert r["next"] == jgrid[(s + 1) % S, d, c]
        assert r["fwd"] == jgrid[s, d, (c - 1) % C]
        assert r["back"] == jgrid[s, d, (c + 1) % C]
        line = jgrid[s, d, :]
        assert r["sum"] == line.sum() and r["max"] == line.max()
        assert r["plane"] == jgrid[s].sum()
        # block j of each member's row of 3 lands at member j, in order
        members = [x for x in res if (x["stage"], x["data"]) == (s, d)]
        members.sort(key=lambda x: x["context"])
        want = np.concatenate([m["x"].reshape(C, 3)[c] for m in members])
        np.testing.assert_array_equal(r["a2a"].reshape(-1), want)
        np.testing.assert_array_equal(r["a2a_back"].reshape(-1),
                                      r["x"].reshape(-1))
        st = r["stats"]
        assert st["p2p_messages"] == 4 and st["collectives"] == 5


def test_refusals_are_pipe_tpus(world):
    """Ulysses' head count, the impl name and the 2-D-only survivor mesh
    refuse with ``pipe_tpu``'s words; the model axis is a mesh axis like
    any other, whose bad shape refuses with ``make_mesh``'s words."""
    res = world.run(cases.refusals, SHAPES[4])[0]
    assert res["heads"] == ("ValueError", "ulysses_attention needs heads % "
                            "axis_size == 0, got heads=3, axis_size=4")
    assert res["impl"] == ("ValueError",
                           "impl must be ring|ulysses, got 'nope'")
    assert res["survivor"][0] == "NotImplementedError"
    assert "survivor_mesh" in res["survivor"][1]
    assert res["model"] == ("ValueError",
                            "mesh 1x1x2 needs 2 ranks, the world has 4")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_one_device_is_the_oracle(impl):
    """Without a mesh both attentions are one shard: the oracle's
    forward and gradients (JAX's at ``n_context`` 1)."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(seed=5))
    fn = ring_attention if impl == "ring" else ulysses_attention
    o = fn(q, k, v, None, causal=True)
    assert torch.equal(o, context_parallel_attention(None, q, k, v,
                                                     impl=impl))
    (o ** 2).sum().backward()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    want = blockwise_attention_reference(q2, k2, v2, causal=True)
    (want ** 2).sum().backward()
    torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-6)
    for a, b in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)
