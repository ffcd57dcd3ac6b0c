"""Training: ``Trainer``/``TrainerConfig`` (``loop``) and checkpoints (``state``)."""

from .loop import Trainer, TrainerConfig
from .state import (CheckpointCorrupt, TrainState, latest_step,
                    restore_checkpoint, save_checkpoint)

__all__ = ["Trainer", "TrainerConfig", "TrainState", "CheckpointCorrupt",
           "save_checkpoint", "restore_checkpoint", "latest_step"]
