"""pipe_tpu_torch's flash attention against pipe_tpu's Pallas kernel.

The Pallas forward runs in interpret mode on the CPU, as
tests/test_pallas_attention.py runs it; the port's wrapper runs its plain
PyTorch version for CPU tensors. Inputs come from numpy with a seed and go
through both. fp32 tolerance 1e-5 abs: the two sum in different orders.
The CUDA kernel itself is checked on the card by tests/test_torch_cuda.py
(skipped without one) and by chip_smoke.py.
"""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipe_tpu.ops import pallas_attention as jfa
from pipe_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv3(bh, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(3)]


def _cases():
    for s in (8, 16, 64, 256):
        for d in (8, 64):
            for causal in (True, False):
                for block in ((128, 32) if s >= 64 else (128,)):
                    yield s, d, causal, block


@pytest.mark.parametrize("s,d,causal,block", list(_cases()))
def test_plain_version_matches_pallas_fwd(s, d, causal, block):
    q, k, v = _qkv3(2, s, d, seed=s + d)
    scale = 1.0 / math.sqrt(d)
    b = min(block, s)
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.zeros((1,), jnp.int32), causal, scale, b, b,
                          True, 0.0)
    o_t, lse_t = tfa.flash_attention_ref(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), causal, scale)
    assert lse_t.shape == lse_j.shape == (2, 1, s)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("block", [8, 16, 32, 128])
def test_supports_matches_pallas(block):
    for s in range(0, 300):
        assert tfa.supports(s, block=block) == jfa.supports(s, block=block), s


@pytest.mark.parametrize("s,block_q,block_k", [
    (24, 128, 128), (100, 128, 128), (4, 128, 128), (96, 32, 32),
    (96, 32, 64), (64, 24, 64), (128, 64, 32), (40, 16, 8), (48, 32, 16)])
def test_wrapper_refuses_what_pallas_refuses(s, block_q, block_k):
    rng = np.random.default_rng(s)
    q, k, v = [rng.standard_normal((1, s, 1, 8)).astype(np.float32)
               for _ in range(3)]

    def outcome(fn):
        try:
            return "ok", np.asarray(fn())
        except ValueError:
            return "refused", None

    jr, jo = outcome(lambda: jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=block_q, block_k=block_k))
    tr, to = outcome(lambda: tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, block_q=block_q, block_k=block_k))
    assert jr == tr
    if jr == "ok":
        np.testing.assert_allclose(to, jo, rtol=0, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,d", [(2, 64, 2, 16), (1, 24, 3, 8)])
def test_public_flash_attention_matches_pallas(b, s, h, d, causal):
    rng = np.random.default_rng(7)
    q, k, v = [rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3)]
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, block_q=32,
                              block_k=32)
    exp = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=32, block_k=32)
    assert tuple(got.shape) == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=TOL)


def test_cpu_call_does_not_move_the_launch_counter():
    before = tfa.flash_attention_fwd.launches
    q, k, v = [torch.from_numpy(a) for a in _qkv3(2, 16, 8)]
    tfa.flash_attention_fwd(q, k, v, causal=True, scale=0.3)
    tfa.flash_attention(q.view(2, 16, 1, 8), k.view(2, 16, 1, 8),
                        v.view(2, 16, 1, 8))
    assert tfa.flash_attention_fwd.launches == before


def test_gradient_and_dropout_raise_not_implemented():
    q, k, v = [torch.from_numpy(a) for a in _qkv3(1, 16, 8)]
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention_fwd(q.requires_grad_(), k, v, causal=True,
                                scale=1.0)
    with torch.no_grad():   # no gradient needed: runs
        tfa.flash_attention_fwd(q, k, v, causal=True, scale=1.0)
    x = torch.zeros(1, 16, 1, 8)
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention(x, x, x, dropout_rate=0.1)
    with pytest.raises(ValueError):
        tfa.flash_attention(x, x, x, dropout_rate=1.0)


def test_wrapper_checks_shapes_and_dtypes():
    a = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(a, torch.zeros(2, 8, 8), a, causal=True,
                                scale=1.0)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(a, a.double(), a, causal=True, scale=1.0)


def test_module_imports_and_runs_without_triton_or_nvcc():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch\n"
        "from pipe_tpu_torch.ops import flash_attention as f\n"
        "x = torch.randn(1, 16, 2, 8)\n"
        "assert f.flash_attention(x, x, x).shape == x.shape\n"
        "assert f.flash_attention_fwd.launches == 0\n"
        "assert 'pipe_tpu_torch._build' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
