"""Training cells of GPT-2 through the port's ``Pipe`` front door over
``gpt2.build_sequential`` (the embedding skip on a lane) and its
partitions on the schedule tables (``HeteroScheduledPipeline``), with
``torch.optim.Adam``, as the port's model zoo trains it."""

from __future__ import annotations

import contextlib

import torch

from harness import core, traffic
from harness import train as flow

KIND = "train"


def logits_fn(plan):
    """The plain reference's logits ``(weights, tokens)`` of the cell,
    with the embedding skip where the cell builds it."""
    ref, cfg, skip = plan.reference(), plan.config, plan.cell["embed_skip"]
    return lambda w, t: ref.logits(w, t, cfg, embed_skip=skip)


class Program:
    range_prefixes = ("Optimizer.step",)

    def __init__(self, plan, weights, seed: int, device):
        from pipe_tpu_torch import Pipe
        from pipe_tpu_torch.models import gpt2
        from pipe_tpu_torch.models.common import per_row_ce
        from pipe_tpu_torch.parallel.hetero_scheduled import \
            HeteroScheduledPipeline

        cfg, cell = plan.config, plan.cell
        self.adapter = core.load_module(plan.root / "benchmark" / "adapters"
                                        / f"{cfg['family']}.py")
        mcfg = self.adapter.model_config(cfg)
        self.seq = gpt2.build_sequential(
            mcfg, embed_skip=cell["embed_skip"], device=device,
            generator=torch.Generator(device=device).manual_seed(seed))
        self.adapter.load(list(self.seq), weights)
        self.pipe = Pipe(self.seq, chunks=cell["chunks"],
                         checkpoint=cell["checkpoint"],
                         balance=cell["balance"], device=device)
        self.ex = HeteroScheduledPipeline(
            self.pipe.partitions, self.pipe.skip_layout, cell["chunks"],
            cell["checkpoint"], cell["schedule"], device=device)
        self.loss_fn = per_row_ce
        self.optimizer = torch.optim.Adam(
            self.pipe.parameters(), lr=cell["lr"], betas=tuple(cell["betas"]),
            eps=cell["eps"])
        self.tokens_per_step = cell["batch"] * mcfg.seq_len
        self.tokens = traffic.token_batches(seed, cell["max_steps"],
                                            cell["batch"], mcfg.seq_len,
                                            mcfg.vocab, device)

    def leaves(self):
        return self.adapter.leaves(list(self.seq))

    def batch(self, step: int):
        x = self.tokens[step]
        return x[:, :-1].contiguous(), x[:, 1:].contiguous()

    def run(self, first: int, n: int):
        losses = []
        for b in range(first, first + n):
            tokens, targets = self.batch(b)
            self.optimizer.zero_grad(set_to_none=True)
            loss, _ = self.ex.loss_and_grad(tokens, targets=targets,
                                            loss_fn=self.loss_fn, seed=None)
            self.optimizer.step()
            losses.append(loss.detach())
        return [float(x) for x in losses]

    def probe(self, norms: list):
        return contextlib.nullcontext()

    def traced(self):
        return contextlib.nullcontext()


def run(plan, seed, seconds, trace, device, t_start):
    cfg = plan.config
    d = cfg["n_embd"]
    flops = dict(d_model=d, d_ff=cfg["n_inner"] or 4 * d,
                 n_layers=cfg["n_layer"], vocab=cfg["vocab_size"],
                 seq_len=cfg["n_positions"], causal=True,
                 checkpoint=plan.cell["checkpoint"],
                 chunks=plan.cell["chunks"])
    attn = flow.attention_shape(plan, cfg["n_head"], cfg["n_positions"], d)
    return flow.run(plan, Program, logits_fn(plan), seed, seconds, trace, device, t_start, flops, attn)
