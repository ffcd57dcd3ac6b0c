"""pipe_tpu_torch on a CUDA card: the kernels against their plain versions,
and the Pipe slice through them. Skipped without a card.

This file imports only torch and pipe_tpu_torch, so it runs on a machine
without JAX; there, skip the repo's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

import pipe_tpu_torch as pt
from pipe_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda

TOL = 1e-4   # fp32; the kernel sums in another order than the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bh,s,d,causal", [
    (64, 128, 64, True), (3, 24, 8, True), (8, 256, 128, False),
    (2, 200, 64, True), (2, 96, 96, False)])
def test_flash_kernel_matches_plain_version(cuda, bh, s, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = [torch.randn((bh, s, d), generator=gen, device=cuda)
               for _ in range(3)]
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, scale=0.125)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal, 0.125)
    assert (o - o_ref).abs().max().item() <= TOL
    assert (lse - lse_ref).abs().max().item() <= TOL


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(x.transpose(1, 2).contiguous().transpose(1, 2),
                                x, x, causal=True, scale=1.0)
    with pytest.raises(TypeError):
        y = x.double()
        tfa.flash_attention_fwd(y, y, y, causal=True, scale=1.0)
    z = torch.zeros(1, 8, 136, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention_fwd(z, z, z, causal=True, scale=1.0)


def test_flash_pipe_refuses_dropout(cuda):
    cfg = dataclasses.replace(pt.LMConfig().tiny(), attn_impl="flash",
                              dropout=0.2)
    pipe = pt.Pipe(pt.build_sequential(cfg, device=cuda), chunks=2,
                   device=cuda)
    tokens = torch.zeros(2, cfg.seq_len, dtype=torch.long, device=cuda)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="dropout.*training slice"):
        pipe(tokens, train=True, seed=0)


def test_tiny_pipe_slice_goes_through_the_kernel(cuda):
    cfg = dataclasses.replace(pt.LMConfig().tiny(), attn_impl="flash")
    seq = pt.build_sequential(cfg, device=cuda)
    pipe = pt.Pipe(seq, chunks=4, n_stages=2, device=cuda)
    twin_seq = pt.build_sequential(dataclasses.replace(cfg, attn_impl="xla"),
                                   device=cuda)
    twin_seq.load_state_dict(seq.state_dict())
    twin = pt.Pipe(twin_seq, chunks=4, n_stages=2, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    with torch.inference_mode():
        before = tfa.flash_attention_fwd.launches
        got = pipe(tokens)
        assert tfa.flash_attention_fwd.launches - before == cfg.n_layers * 4
        want = twin(tokens)
    assert (got - want).abs().max().item() <= TOL
