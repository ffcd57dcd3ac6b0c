"""Device selection: the port runs on a CUDA card unless the caller asks for
the CPU (where every kernel's wrapper runs its plain PyTorch version)."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE
                   ) -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and absent.

    There is no quiet fall-back to the CPU: a caller who wants the CPU says
    ``device="cpu"``.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pipe_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
