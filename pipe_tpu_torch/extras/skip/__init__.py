"""Skip-connection subsystem: tensors that jump over pipeline stages.

Counterpart of ``pipe_tpu/extras/skip``: a layer deep in one stage can
``stash`` a tensor and a layer in a *later* stage can ``pop`` it, outside
the stage-to-stage dataflow. A stash is a named value recorded by a
:class:`SkipTracker` while the schedule runs; its gradient path is autograd's
(the emulator carries cross-stage values as explicit task inputs and
outputs, the table executors on skip lanes). :func:`inspect_skip_layout`
gives the static wiring and :func:`verify_skippables` the fail-fast check.
"""

from .namespace import Namespace
from .skippable import Skippable, pop, skippable, stash, verify_skippables
from .layout import SkipLayout, inspect_skip_layout
from .tracker import SkipTracker, current_skip_tracker, use_skip_tracker

__all__ = [
    "Namespace",
    "Skippable",
    "skippable",
    "stash",
    "pop",
    "verify_skippables",
    "SkipLayout",
    "inspect_skip_layout",
    "SkipTracker",
    "current_skip_tracker",
    "use_skip_tracker",
]
