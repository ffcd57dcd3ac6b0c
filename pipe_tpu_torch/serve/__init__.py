"""Continuous-batching serving over the port's generator, on one device.

Counterpart of the single-device part of ``pipe_tpu/serve``:
:class:`~.queue.RequestQueue` is the bounded front door (backpressure,
deadlines, cancellation, FIFO or priority); :class:`~.engine.ServeEngine`
schedules requests into fixed decode **slots** and runs one decode step for
all of them per host tick, captured once in a CUDA graph on the card and
replayed every tick (a capture counter pins it at one);
:class:`~.buckets.BucketSpec` caps prefill to a closed set of prompt-length
shapes. :class:`~.engine.SingleDeviceSlotBackend` keeps a per-slot KV slab.
The paged KV pool, the resident loop, the speculative lane, the ring backend
and the fleet router are not ported yet (ROADMAP.md A.6, A.7, A.8).
``apps/serve.py`` is the driver.
"""

from .buckets import BucketSpec
from .engine import EngineDraining, ServeEngine, SingleDeviceSlotBackend
from .queue import QueueFull, Request, RequestQueue, Response

__all__ = ["BucketSpec", "ServeEngine", "SingleDeviceSlotBackend",
           "QueueFull", "Request", "RequestQueue", "Response",
           "EngineDraining"]
