"""The world of ranks (``runtime/distributed.py``)."""

from .distributed import (World, WorldError, global_pipeline_mesh,
                          host_local_batch, initialize, is_initialized,
                          launch, process_summary)

__all__ = ["World", "WorldError", "global_pipeline_mesh", "host_local_batch",
           "initialize", "is_initialized", "launch", "process_summary"]
