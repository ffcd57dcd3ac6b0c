"""Plain PyTorch pieces that the references are written in: seeded weights
drawn in a few large calls, layer norm, softmax attention, the token
cross-entropy, and three training steps with a global-norm clip and Adam.

Nothing here imports the program. Every matrix product runs in float32 with
TF32 off unless a caller asks for TF32 (the control of the correctness
check).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, float]   # name, shape, kind, scale


def make_weights(specs: Sequence[Spec], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``seed``: one uniform and one normal draw on
    ``device`` for all leaves, cut into views. ``uniform`` leaves lie in
    ±scale, ``normal`` ones have standard deviation scale, ``zeros`` and
    ``ones`` are constant."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_uni = sum(math.prod(s) for _, s, k, _ in specs if k == "uniform")
    n_nrm = sum(math.prod(s) for _, s, k, _ in specs if k == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device).mul_(2).sub_(1)
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    out, at_u, at_n = {}, 0, 0
    for name, shape, kind, scale in specs:
        n = math.prod(shape)
        if kind == "uniform":
            out[name] = uni[at_u:at_u + n].view(shape).mul_(scale)
            at_u += n
        elif kind == "normal":
            out[name] = nrm[at_n:at_n + n].view(shape).mul_(scale)
            at_n += n
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {kind!r} for {name}")
    return out


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Matrix products in TF32 (the control) or in float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def layer_norm(x, g, b, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def linear(x, w, b=None):
    y = x @ w.t()
    return y if b is None else y + b


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x * x * x)))


def self_attention(x, w: Dict[str, torch.Tensor], prefix: str, heads: int,
                   causal: bool = True):
    """Multi-head softmax self-attention of ``x [b, s, d]``: the
    projections ``{prefix}w{q,k,v,o}.{weight,bias}``, heads as contiguous
    slices of d."""
    b, s, d = x.shape
    hd = d // heads

    def proj(n):
        return linear(x, w[f"{prefix}{n}.weight"], w[f"{prefix}{n}.bias"]
                      ).view(b, s, heads, hd).transpose(1, 2)

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    o = torch.softmax(scores, dim=-1) @ v
    o = o.transpose(1, 2).reshape(b, s, d)
    return linear(o, w[f"{prefix}wo.weight"], w[f"{prefix}wo.bias"])


def row_ce(logits, targets):
    """Per-row mean token cross-entropy ``[rows]`` in float32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold).mean(dim=-1)


def train_steps(logits_fn: Callable, weights: Dict[str, torch.Tensor],
                batches: List[Tuple[torch.Tensor, torch.Tensor]], *,
                lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                clip: Optional[float] = None, row_block: int,
                tf32: bool = False, rows: Optional[int] = None,
                against: Optional[Dict[str, torch.Tensor]] = None,
                keep_grad: bool = False) -> dict:
    """Train a copy of ``weights`` on ``batches`` (tokens, targets):
    the mean over rows of the per-row mean cross-entropy of
    ``logits_fn(params, tokens)``, backward in blocks of ``row_block``
    rows, the global norm clipped to ``clip`` (left alone below it, else
    scaled to it), then Adam (bias-corrected, eps outside the root).

    ``rows`` keeps only the first rows of each batch (a fault of the check:
    half the batch left out, the mean over the rest).

    Returns the loss of each step, the global gradient norm before the
    clip and each leaf's gradient norm after it at step 1, and each leaf's
    distance from its start after the last step; with ``against`` (another
    step-1 gradient, by leaf, anywhere) also each leaf's norm of the
    difference from it, and with ``keep_grad`` the step-1 gradient itself,
    on the host."""
    b1, b2 = betas
    params = {n: w.detach().clone().requires_grad_(True)
              for n, w in weights.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    out = {"losses": []}
    with matmul_precision(tf32):
        for t, (tokens, targets) in enumerate(batches, 1):
            if rows is not None:
                tokens, targets = tokens[:rows], targets[:rows]
            for p in params.values():
                p.grad = None
            n_rows = tokens.shape[0]
            total = 0.0
            for r in range(0, n_rows, row_block):
                ce = row_ce(logits_fn(params, tokens[r:r + row_block]),
                            targets[r:r + row_block])
                loss = ce.sum() / n_rows
                loss.backward()
                total += float(loss.detach())
            out["losses"].append(total)
            with torch.no_grad():
                grads = {n: (p.grad if p.grad is not None
                             else torch.zeros_like(p))
                         for n, p in params.items()}
                norm = torch.sqrt(sum(g.square().sum()
                                      for g in grads.values()))
                if clip is not None and float(norm) >= clip:
                    for g in grads.values():
                        g.mul_(clip / norm)
                if t == 1:
                    out["grad_norm"] = float(norm)
                    out["leaf_grad"] = {n: float(g.norm())
                                        for n, g in grads.items()}
                    if against is not None:
                        out["leaf_grad_diff"] = {
                            n: float((g - against[n].to(g.device)).norm())
                            for n, g in grads.items()}
                    if keep_grad:
                        out["grad"] = {n: g.cpu() for n, g in grads.items()}
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                for n, p in params.items():
                    g = grads[n]
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(bc2)).add_(eps)
                    p.addcdiv_(m[n], denom, value=-lr / bc1)
    with torch.no_grad():
        out["leaf_change"] = {n: float((params[n] - weights[n]).norm())
                              for n in params}
    return out
