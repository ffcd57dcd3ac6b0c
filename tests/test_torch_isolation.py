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
from pipe_tpu_torch.apps import generate as gen_app
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
from pipe_tpu_torch.apps import generate as gen_app, lm_tutorial
for make in (lambda: Linear(4, 4),
             lambda: pt.PipelinedLM(pt.LMConfig().tiny()),
             lambda: gen_app.main(["--tiny"]),
             lambda: pt.build_sequential(pt.LMConfig().tiny()),
             lambda: pt.Pipe(pt.Sequential([Linear(4, 4, device="cpu")])),
             lambda: Trainer(pt.LMConfig().tiny(), TrainerConfig()),
             lambda: lm_tutorial.main(["never", "--tiny"])):
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
