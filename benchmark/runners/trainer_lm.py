"""Training cells of the tutorial LM through the port's ``Trainer``
(``train/loop.py``): its ``train_epoch`` over a token source, a few
batches a call, with its table executor, global-norm clip and Adam."""

from __future__ import annotations

import contextlib

import torch

from harness import core, traffic
from harness import train as flow

KIND = "train"


def logits_fn(plan):
    """The plain reference's logits ``(weights, tokens)`` of the cell."""
    ref, cfg = plan.reference(), plan.config
    return lambda w, t: ref.logits(w, t, cfg)


def _adapter(plan):
    return core.load_module(plan.root / "benchmark" / "adapters"
                            / f"{plan.config['family']}.py")


class Program:
    """The port's ``Trainer`` of the cell, holding the benchmark's weights."""

    range_prefixes = ("Optimizer.step", "bench:clip")

    def __init__(self, plan, weights, seed: int, device):
        from pipe_tpu_torch.train.loop import Trainer, TrainerConfig

        cfg, cell = plan.config, plan.cell
        self.adapter = _adapter(plan)
        self.bptt = cfg["bptt"]
        self.device = torch.device(device)
        tcfg = TrainerConfig(
            batch_size=cell["batch"], bptt=cfg["bptt"], chunks=cell["chunks"],
            checkpoint=cell["checkpoint"], n_stages=cell["stages"],
            schedule=cell["schedule"], lr=cell["lr"], grad_clip=cell["clip"],
            seed=seed)
        self.trainer = Trainer(self.adapter.model_config(cfg), tcfg,
                               device=device)
        self.state = self.trainer.init_state()
        self.adapter.load(list(self.trainer.pipe), weights)
        self.optimizer = self.trainer.optimizer
        self.tokens_per_step = cell["batch"] * cfg["bptt"]
        self.source = traffic.lm_source(seed, cell["max_steps"] * self.bptt
                                        + 1, cell["batch"], cfg["ntokens"])

    def leaves(self):
        return self.adapter.leaves(list(self.trainer.pipe))

    def run(self, first: int, n: int):
        self.state, info = self.trainer.train_epoch(
            self.source, state=self.state, max_steps=first + n,
            start_step=first, log_every=0, log_fn=lambda line: None)
        if info["steps"] != n:
            raise RuntimeError(f"train_epoch ran {info['steps']} of {n} "
                               f"steps from batch {first}")
        return info["losses"]

    def batch(self, step: int):
        data, target = traffic.lm_batch(self.source, step, self.bptt)
        return (torch.from_numpy(data).to(self.device),
                torch.from_numpy(target).to(self.device))

    @contextlib.contextmanager
    def _wrap_clip(self, after):
        from pipe_tpu_torch.train import loop

        orig = loop.clip_by_global_norm

        def wrapped(grads, max_norm, mesh=None):
            return after(orig, grads, max_norm, mesh)

        loop.clip_by_global_norm = wrapped
        try:
            yield
        finally:
            loop.clip_by_global_norm = orig

    def probe(self, norms: list):
        """Keep the norm the trainer's clip returns (before clipping)."""
        def after(orig, grads, max_norm, mesh):
            norm = orig(grads, max_norm, mesh=mesh)
            norms.append(norm.detach().clone())
            return norm
        return self._wrap_clip(after)

    def traced(self):
        """The clip inside a host range the profile attributes."""
        def after(orig, grads, max_norm, mesh):
            with torch.profiler.record_function("bench:clip"):
                return orig(grads, max_norm, mesh=mesh)
        return self._wrap_clip(after)


def run(plan, seed, seconds, trace, device, t_start):
    cfg = plan.config
    flops = dict(d_model=cfg["emsize"], d_ff=cfg["nhid"],
                 n_layers=cfg["nlayers"], vocab=cfg["ntokens"],
                 seq_len=cfg["bptt"], causal=True,
                 checkpoint=plan.cell["checkpoint"],
                 chunks=plan.cell["chunks"])
    attn = flow.attention_shape(plan, cfg["nhead"], cfg["bptt"],
                                cfg["emsize"])
    return flow.run(plan, Program, logits_fn(plan), seed, seconds, trace, device, t_start, flops, attn)
