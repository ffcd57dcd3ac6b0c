"""pipe_tpu_torch stands alone: it imports neither JAX nor pipe_tpu, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_RUN = """
import sys
for name in ("jax", "jaxlib", "pipe_tpu"):
    sys.modules[name] = None          # any import of them now fails
import torch
import pipe_tpu_torch as pt
from pipe_tpu_torch import convert, _build
from pipe_tpu_torch.apps import lm_tutorial
from pipe_tpu_torch.data import lm_text
from pipe_tpu_torch.models import common
from pipe_tpu_torch.train import Trainer, TrainerConfig, save_checkpoint
cfg = pt.LMConfig().tiny()
seq = pt.build_sequential(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(1))
pipe = pt.Pipe(seq, chunks=2, n_stages=2, device="cpu")
with torch.inference_mode():
    out = pipe(torch.randint(0, cfg.vocab, (4, cfg.seq_len)))
assert out.shape == (4, cfg.seq_len, cfg.vocab)
assert torch.isfinite(out).all()
tr = Trainer(cfg, TrainerConfig(batch_size=4, bptt=cfg.seq_len, chunks=2),
             device="cpu")
ids = torch.randint(0, cfg.vocab, (2048,)).numpy()
state, info = tr.train_epoch(lm_text.batchify(ids, 4), max_steps=2,
                             log_every=0)
assert info["steps"] == 2 and info["loss"] == info["loss"]
for schedule, ck in (("1f1b", "except_last"), ("zb-h1", "never")):
    tr = Trainer(cfg, TrainerConfig(batch_size=4, bptt=cfg.seq_len, chunks=2,
                                    schedule=schedule, checkpoint=ck),
                 device="cpu")
    _, info = tr.train_epoch(lm_text.batchify(ids, 4), max_steps=1,
                             log_every=0)
    assert info["steps"] == 1 and info["loss"] == info["loss"]
from pipe_tpu_torch.apps import generate as gen_app
from pipe_tpu_torch.ops.layers import Linear
from pipe_tpu_torch.inference import (GenerationConfig, Generator,
                                      quantize_params)
lm = pt.PipelinedLM(cfg, 2, device="cpu")
prompt = torch.randint(0, cfg.vocab, (2, 5))
for model, gcfg in ((lm, GenerationConfig(max_new_tokens=4, temperature=0.0)),
                    (quantize_params(lm), GenerationConfig(
                        max_new_tokens=4, temperature=0.7, top_k=5)),
                    (lm, GenerationConfig(max_new_tokens=3, num_beams=2))):
    toks = Generator(model, gcfg).generate(prompt)
    assert toks.shape == (2, gcfg.max_new_tokens)
assert tr.generate(state, prompt, max_new_tokens=3).shape == (2, 3)
assert gen_app.main(["--tiny", "--device", "cpu", "--max-new", "3"]) == 0
from pipe_tpu_torch.apps import zoo
from pipe_tpu_torch.extras.norm import BatchNorm
from pipe_tpu_torch.models import gpt2
from pipe_tpu_torch.models.common import per_row_ce
from pipe_tpu_torch.parallel.hetero_scheduled import HeteroScheduledPipeline
assert zoo.main(["gpt2", "--tiny", "--device", "cpu", "--steps", "1"]) == 0
gcfg = gpt2.GPT2Config().tiny()
gpipe = pt.Pipe(gpt2.build_sequential(gcfg, embed_skip=True, device="cpu"),
                chunks=2, balance=[2, 2, 2, 2], device="cpu")
toks = torch.randint(0, gcfg.vocab, (4, gcfg.seq_len))
ex = HeteroScheduledPipeline(gpipe.partitions, gpipe.skip_layout, 2,
                             "except_last", "1f1b", device="cpu")
loss, _ = ex.loss_and_grad(toks, targets=toks.roll(-1, -1), loss_fn=per_row_ce)
assert loss.item() == loss.item() and ex.memory_plan()["skip_lanes"] == 1
bn = pt.Pipe(pt.Sequential([Linear(4, 4, device="cpu"),
                            BatchNorm(4, device="cpu")]),
             chunks=2, n_stages=2, deferred_batch_norm=True, device="cpu")
bn(torch.randn(8, 4), train=True)
assert bn[1].mean.abs().sum() > 0
from pipe_tpu_torch.apps import serve as serve_app
from pipe_tpu_torch.core.remat import checkpoint_policies
from pipe_tpu_torch.models import BertConfig, PipelinedBERT, ViTConfig
for argv in (["bert", "--schedule", "interleaved-1f1b"], ["vit"]):
    assert zoo.main(argv + ["--tiny", "--device", "cpu", "--steps", "1"]) == 0
rp = pt.Pipe(pt.build_sequential(cfg, device="cpu"), chunks=2, n_stages=2,
             remat_policy=checkpoint_policies.dots_saveable, device="cpu")
rp(torch.randint(0, cfg.vocab, (4, cfg.seq_len)), train=True).sum().backward()
assert gen_app.main(["--family", "gpt2", "--tiny", "--device", "cpu",
                     "--max-new", "3"]) == 0
g2 = gpt2.PipelinedGPT2(gcfg, device="cpu")
assert g2.embed_at(toks[:, :1], torch.tensor([0, 3, 9, 15])).shape == (
    4, 1, gcfg.d_model)
import os, tempfile
from pipe_tpu_torch import obs, resilience
from pipe_tpu_torch.core import balance, planner
from pipe_tpu_torch.data import native
from pipe_tpu_torch.obs import meters, tb_writer, telemetry
from pipe_tpu_torch.resilience import chaos, detect, recover
d = tempfile.mkdtemp()
tr = Trainer(cfg, TrainerConfig(
    batch_size=4, bptt=cfg.seq_len, chunks=2, telemetry_dir=d,
    tb_dir=os.path.join(d, "tb"), profile_every=2, prefetch_depth=2,
    plan="auto", resilience=recover.ResilienceConfig(data_backoff_s=0.0)),
    device="cpu", chaos=chaos.ChaosPlan([chaos.Fault("nan_grads", 1),
                                         chaos.Fault("data_raise", 0)]))
_, info = tr.train_epoch(lm_text.batchify(ids, 4), max_steps=2, log_every=1)
assert info["steps"] == 2 and info["anomalies"] == 1
assert os.path.exists(os.path.join(d, "trace_step2", "trace.json"))
tl = meters.stage_timeline_from_trace(os.path.join(d, "trace_step2"))
assert tl["source"] == "host" and tl["stages"], tl
assert native.prefetch_available() and native.BatchPrefetcher.opened >= 1
plan = planner.auto_plan(pt.build_sequential(cfg, device="cpu"),
                         torch.randint(0, cfg.vocab, (2, cfg.seq_len)),
                         n_devices=2, m_candidates=(2,), batch_rows=4,
                         schedules=("gpipe",), checkpoint="except_last")
pt.Pipe(pt.build_sequential(cfg, device="cpu"), plan=plan, device="cpu")
assert lm_tutorial.main(["never", "--tiny", "--device", "cpu", "--steps", "1",
                         "--plan", "auto", "--profile",
                         os.path.join(d, "p")]) == 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""

_NO_CUDA = """
import torch
torch.cuda.is_available = lambda: False
import pipe_tpu_torch as pt
from pipe_tpu_torch.ops.layers import Linear
from pipe_tpu_torch.train import Trainer, TrainerConfig
from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
from pipe_tpu_torch.apps import generate as gen_app, lm_tutorial, zoo
from pipe_tpu_torch.extras.norm import BatchNorm
from pipe_tpu_torch.models import (BertConfig, GPT2Config, PipelinedBERT,
                                   PipelinedGPT2, PipelinedViT, ViTConfig)
from pipe_tpu_torch.parallel.hetero_scheduled import HeteroScheduledPipeline
for make in (lambda: Linear(4, 4),
             lambda: BatchNorm(4),
             lambda: PipelinedGPT2(GPT2Config().tiny()),
             lambda: PipelinedBERT(BertConfig().tiny()),
             lambda: PipelinedViT(ViTConfig().tiny()),
             lambda: zoo.main(["vit", "--tiny"]),
             lambda: gen_app.main(["--tiny", "--family", "gpt2"]),
             lambda: zoo.main(["gpt2", "--tiny"]),
             lambda: HeteroScheduledPipeline(
                 [pt.Sequential([Linear(4, 4, device="cpu")])], None, 2),
             lambda: pt.PipelinedLM(pt.LMConfig().tiny()),
             lambda: gen_app.main(["--tiny"]),
             lambda: pt.build_sequential(pt.LMConfig().tiny()),
             lambda: pt.Pipe(pt.Sequential([Linear(4, 4, device="cpu")])),
             lambda: Trainer(pt.LMConfig().tiny(), TrainerConfig()),
             lambda: Trainer(pt.LMConfig().tiny(), TrainerConfig(
                 plan="auto", prefetch_depth=2, profile_every=1)),
             lambda: ScheduledPipeline(lambda s, h, c: h, lambda x, c: x,
                                       lambda h, x, c: h, n_stages=1,
                                       module=Linear(4, 4, device="cpu")),
             lambda: lm_tutorial.main(["never", "--tiny"]),
             lambda: lm_tutorial.main(["never", "--tiny", "--plan", "auto"])):
    try:
        make()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("constructed on a default device without CUDA")
print("ok")
"""


def _run(code: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("ok")


def test_imports_and_runs_with_jax_and_pipe_tpu_blocked():
    _run(_BLOCKED_RUN)


def test_default_device_raises_without_cuda():
    _run(_NO_CUDA)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "pipe_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]))
def test_no_source_imports_jax_or_pipe_tpu(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "pipe_tpu"), (path, name)
