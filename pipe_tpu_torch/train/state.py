"""Train state and model-state checkpoints (save / resume).

Counterpart of ``pipe_tpu/train/state.py``. :class:`TrainState` holds what a
resumable step needs: the model's ``state_dict``, the optimizer's
``state_dict`` and the step. :func:`save_checkpoint` writes it with
``torch.save`` into ``directory/step_{N}/state.pt`` and records a per-tensor
sha256 manifest beside it (``manifest_step{N}.json``); both are written under
a temporary name, synced and renamed, so a crash leaves either no file or a
whole one. :func:`restore_checkpoint` re-hashes what it loaded and raises
:class:`CheckpointCorrupt` naming the first tensor that disagrees. The buddy
and stage-shard manifests of elastic training are not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import torch

__all__ = ["TrainState", "CheckpointCorrupt", "state_manifest",
           "save_checkpoint", "restore_checkpoint", "latest_step"]

_STEP_DIR = re.compile(r"^step_(\d+)$")


class CheckpointCorrupt(RuntimeError):
    """A restored checkpoint's content hash disagrees with the manifest
    recorded at save time. The message names the first corrupt tensor."""


@dataclasses.dataclass
class TrainState:
    """Everything a resumable step needs. ``model`` and ``optimizer`` are
    ``state_dict``s; the ones a ``Trainer`` hands out share their tensors
    with the trainer's live model and optimizer (see ``Trainer``)."""

    model: Dict[str, torch.Tensor]
    optimizer: Dict[str, Any]
    step: int = 0


def _leaves(tree: Any, prefix: str = ""):
    """``(name, leaf)`` pairs of nested dicts, lists and tuples, named by
    their path (``model/partitions.0.layers.0.weight``)."""
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _leaves(tree[key], f"{prefix}/{key}" if prefix
                               else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _as_tree(state: TrainState) -> dict:
    return {"model": state.model, "optimizer": state.optimizer,
            "step": state.step}


def state_manifest(state: TrainState) -> Dict[str, str]:
    """Per-leaf sha256 content hashes, keyed by path. A tensor's hash covers
    its dtype, shape and raw bytes, so any bit flip changes it."""
    out = {}
    for name, leaf in _leaves(_as_tree(state)):
        h = hashlib.sha256()
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            h.update(str(t.dtype).encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(leaf).encode())
        out[name] = h.hexdigest()
    return out


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(target: Path, write) -> None:
    """``write(file)`` into a temporary name beside ``target``, fsync, rename,
    fsync the directory."""
    tmp = target.parent / f".{target.name}.tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    _fsync_dir(target.parent)


def _manifest_path(directory: Path, step: int) -> Path:
    return directory / f"manifest_step{step}.json"


def _steps(directory: Path):
    if not directory.is_dir():
        return []
    return sorted(int(m.group(1)) for p in directory.iterdir()
                  if (m := _STEP_DIR.match(p.name))
                  and (p / "state.pt").exists())


def save_checkpoint(directory: str, state: TrainState, step: int,
                    max_to_keep: int = 3) -> None:
    """Write ``state`` as checkpoint ``step`` and its manifest; keep the
    newest ``max_to_keep`` checkpoints."""
    root = Path(directory)
    step_dir = root / f"step_{int(step)}"
    step_dir.mkdir(parents=True, exist_ok=True)
    _atomic_write(step_dir / "state.pt",
                  lambda f: torch.save(_as_tree(state), f))
    doc = json.dumps({"step": int(step), "leaves": state_manifest(state)},
                     indent=0, sort_keys=True).encode()
    _atomic_write(_manifest_path(root, int(step)), lambda f: f.write(doc))
    for old in _steps(root)[:-max_to_keep]:
        shutil.rmtree(root / f"step_{old}")
        _manifest_path(root, old).unlink(missing_ok=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    steps = _steps(Path(directory))
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, template: TrainState,
                       step: Optional[int] = None,
                       verify: bool = True) -> TrainState:
    """Restore ``step`` (default: latest) as a new :class:`TrainState`.

    ``template``, a state of the same model (a trainer's live state, or
    ``Trainer.init_state()`` when starting afresh), gives the device the
    model tensors land on and the model's tensor names, which the checkpoint
    must match. With ``verify=True`` the loaded tensors are re-hashed against the
    save-time manifest; a mismatch raises :class:`CheckpointCorrupt`.
    """
    root = Path(directory)
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    tree = torch.load(root / f"step_{int(step)}" / "state.pt",
                      map_location="cpu", weights_only=True)
    restored = TrainState(model=tree["model"], optimizer=tree["optimizer"],
                          step=int(tree["step"]))
    if verify:
        _verify_manifest(root, int(step), restored)
    if set(restored.model) != set(template.model):
        raise ValueError(
            f"checkpoint step {step} in {directory} holds another model: "
            f"{sorted(set(restored.model) ^ set(template.model))[:4]} ...")
    restored.model = {k: v.to(template.model[k].device)
                      for k, v in restored.model.items()}
    return restored


def _verify_manifest(root: Path, step: int, restored: TrainState) -> None:
    record = _manifest_path(root, step)
    if not record.exists():
        warnings.warn(
            f"checkpoint step {step} in {root} has no content manifest — "
            f"restoring unverified", RuntimeWarning, stacklevel=3)
        return
    saved = json.loads(record.read_text())["leaves"]
    actual = state_manifest(restored)
    for name, digest in saved.items():
        got = actual.get(name)
        if got is None:
            raise CheckpointCorrupt(
                f"checkpoint step {step} in {root}: tensor {name} is in the "
                f"save-time manifest but missing from the restored state")
        if got != digest:
            raise CheckpointCorrupt(
                f"checkpoint step {step} in {root}: tensor {name} hash "
                f"mismatch (saved {digest[:16]}…, restored {got[:16]}…) — "
                f"the checkpoint is corrupt")
