"""Adam over flat buffers, with its moments sharded over the data group (ZeRO-1).

Counterpart of ``pipe_tpu/train/zero.py``. JAX expresses ZeRO-1 as a layout:
each moment leaf is sharded over ``data`` on its largest divisible dimension
and XLA partitions the elementwise update and inserts the all-gather of the
parameters. Over ranks it is done by hand, on one flat buffer per dtype of a
rank's parameters: data rank ``j`` of ``D`` owns elements
``[j * ceil(N / D), (j + 1) * ceil(N / D))`` of each buffer, keeps Adam's two
moments for those only, updates those parameters from the (already
data-summed) gradients, and the updated slices are all-gathered back into
every replica's parameters. Flat shards hold every moment byte once across
the group (the tail is padded), where the per-leaf rule leaves leaves with
no divisible dimension replicated; :func:`zero_report` counts what this
layout holds.

:class:`ShardedAdam` also keeps the first moment in ``mu_dtype`` (optax's
``scale_by_adam(mu_dtype=)``: the moment is updated in float32 and stored in
``mu_dtype``), with or without sharding. Its update is
``torch.optim.Adam``'s, operation for operation, so with float32 moments and
one data rank it equals ``torch.optim.Adam`` on the same parameters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

__all__ = ["ShardedAdam", "zero_report"]


class ShardedAdam:
    """Adam (``torch.optim.Adam``'s update, no weight decay) over ``params``
    grouped into one flat buffer per dtype. ``mesh`` with ``zero=True``
    shards the moments over its data group (module docstring); ``mu_dtype``
    (e.g. ``torch.bfloat16``) stores the first moment. ``param_groups[0]
    ["lr"]`` is read at every step, as a torch optimizer's is."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8, *, mesh=None,
                 zero: bool = False, mu_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.param_groups = [{"lr": lr, "betas": tuple(betas), "eps": eps,
                              "params": self.params}]
        self.mesh = mesh
        self.shards = (mesh.n_data if zero and mesh is not None else 1)
        self.rank = mesh.data if self.shards > 1 else 0
        self.mu_dtype = mu_dtype
        self.step_count = 0
        self.groups: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in self.params:
            self.groups.setdefault(p.dtype, []).append(p)
        self.exp_avg: Dict[torch.dtype, torch.Tensor] = {}
        self.exp_avg_sq: Dict[torch.dtype, torch.Tensor] = {}
        for dt, ps in self.groups.items():
            per = self._per(ps)
            self.exp_avg[dt] = torch.zeros(per, dtype=mu_dtype or dt,
                                           device=ps[0].device)
            self.exp_avg_sq[dt] = torch.zeros(per, dtype=dt,
                                              device=ps[0].device)

    def _per(self, ps: List[torch.Tensor]) -> int:
        n = sum(p.numel() for p in ps)
        return -(-n // self.shards)

    def reset(self) -> None:
        """Back to step 0 with zero moments."""
        self.step_count = 0
        for t in (*self.exp_avg.values(), *self.exp_avg_sq.values()):
            t.zero_()

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def _segments(self, dt: torch.dtype, rank: int):
        """``(param, a, b, lo)``: the parts ``[a, b)`` of each parameter's
        flat elements that fall in ``rank``'s shard, and where each starts
        in the shard."""
        per = self.exp_avg[dt].numel()
        lo, hi = rank * per, (rank + 1) * per
        out, off = [], 0
        for p in self.groups[dt]:
            a, b = max(lo, off), min(hi, off + p.numel())
            if a < b:
                out.append((p, a - off, b - off, a - lo))
            off += p.numel()
        return out

    @torch.no_grad()
    def step(self) -> None:
        """One Adam update of this rank's shard, in place on the parameters'
        own storage (the same elementwise operations, sharded or not), then
        the shards all-gathered over the data group."""
        g0 = self.param_groups[0]
        lr, (b1, b2), eps = g0["lr"], g0["betas"], g0["eps"]
        self.step_count += 1
        bc1 = 1 - b1 ** self.step_count
        bc2_sqrt = (1 - b2 ** self.step_count) ** 0.5
        for dt in self.groups:
            segs = self._segments(dt, self.rank)
            for p, a, b, at in segs:
                sp = p.view(-1)[a:b]
                sg = (p.grad.view(-1)[a:b] if p.grad is not None
                      else torch.zeros_like(sp))
                m = self.exp_avg[dt][at:at + b - a]
                v = self.exp_avg_sq[dt][at:at + b - a]
                m32 = m.to(dt) if self.mu_dtype is not None else m
                m32.lerp_(sg, 1 - b1)
                v.mul_(b2).addcmul_(sg, sg, value=1 - b2)
                denom = (v.sqrt() / bc2_sqrt).add_(eps)
                sp.addcdiv_(m32, denom, value=-(lr / bc1))
                if self.mu_dtype is not None:
                    m.copy_(m32)
            if self.shards > 1:
                self._gather(dt, segs)

    def _gather(self, dt: torch.dtype, own) -> None:
        """Every data rank's updated shard into every replica's
        parameters."""
        per = self.exp_avg[dt].numel()
        shard = torch.zeros(per, dtype=dt, device=self.exp_avg[dt].device)
        for p, a, b, at in own:
            shard[at:at + b - a] = p.view(-1)[a:b]
        for k, got in enumerate(self.mesh.all_gather(shard, "data",
                                                      to_device=False)):
            if k == self.rank:
                continue
            for p, a, b, at in self._segments(dt, k):
                p.view(-1)[a:b].copy_(got[at:at + b - a])
            if got.device != shard.device:       # the host-to-device leg
                self.mesh.stats.staged_bytes += got.numel() * got.element_size()

    # --- state ---

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step_count,
                "exp_avg": {str(dt): t for dt, t in self.exp_avg.items()},
                "exp_avg_sq": {str(dt): t
                               for dt, t in self.exp_avg_sq.items()},
                "param_groups": [{k: v for k, v in self.param_groups[0].items()
                                  if k != "params"}]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step_count = int(sd["step"])
        for dt in self.groups:
            self.exp_avg[dt].copy_(sd["exp_avg"][str(dt)])
            self.exp_avg_sq[dt].copy_(sd["exp_avg_sq"][str(dt)])
        self.param_groups[0].update(sd["param_groups"][0])

    def full_moments(self) -> Dict[int, Dict[str, torch.Tensor]]:
        """``{index in params: {"exp_avg", "exp_avg_sq"}}``, every moment
        whole (gathered over the data group when sharded; collective)."""
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        index = {id(p): k for k, p in enumerate(self.params)}
        for dt, ps in self.groups.items():
            flats = {}
            for name, t in (("exp_avg", self.exp_avg[dt]),
                            ("exp_avg_sq", self.exp_avg_sq[dt])):
                flats[name] = (torch.cat(self.mesh.all_gather(t, "data"))
                               if self.shards > 1 else t)
            off = 0
            for p in ps:
                out[index[id(p)]] = {
                    name: f[off:off + p.numel()].view(p.shape).clone()
                    for name, f in flats.items()}
                off += p.numel()
        return out

    def load_full_moments(self, moments: Dict[int, Dict[str, torch.Tensor]],
                          step: int) -> None:
        """Inverse of :meth:`full_moments`: this rank's shard of the given
        whole moments (by index in ``params``)."""
        self.step_count = int(step)
        index = {id(p): k for k, p in enumerate(self.params)}
        for dt, ps in self.groups.items():
            per = self.exp_avg[dt].numel()
            lo = self.rank * per
            for name, dst in (("exp_avg", self.exp_avg[dt]),
                              ("exp_avg_sq", self.exp_avg_sq[dt])):
                flat = torch.cat([moments[index[id(p)]][name].reshape(-1).to(
                    dst.device, dst.dtype) for p in ps])
                flat = torch.cat([flat, flat.new_zeros(
                    per * self.shards - flat.numel())])
                dst.copy_(flat[lo:lo + per])


def zero_report(opt: ShardedAdam) -> Dict[str, Any]:
    """Moment bytes: ``total_bytes`` over the whole group, the bytes held
    sharded over ``data`` and replicated, and this rank's share
    (``per_device_bytes``), as ``pipe_tpu``'s report counts them."""
    total = per_device = 0
    for dt, ps in opt.groups.items():
        n = sum(p.numel() for p in ps)
        elem = (opt.exp_avg[dt].element_size()
                + opt.exp_avg_sq[dt].element_size())
        total += n * elem
        per_device += opt.exp_avg[dt].numel() * elem
    sharded = total if opt.shards > 1 else 0
    return {"total_bytes": total, "data_sharded_bytes": sharded,
            "replicated_bytes": total - sharded,
            "per_device_bytes": per_device, "shards": opt.shards}
