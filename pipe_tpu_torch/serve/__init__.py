"""Continuous-batching serving over the port's generator, on one device.

Counterpart of the single-device part of ``pipe_tpu/serve``:
:class:`~.queue.RequestQueue` is the bounded front door (backpressure,
deadlines, cancellation, FIFO or priority); :class:`~.engine.ServeEngine`
schedules requests into fixed decode **slots** and runs the decode program
for all of them per host tick, captured once in a CUDA graph on the card
and replayed every tick (a capture counter pins it at one);
:class:`~.buckets.BucketSpec` caps the slab's prefill to a closed set of
prompt-length shapes. :class:`~.engine.SingleDeviceSlotBackend` keeps a
per-slot KV slab, or the paged pool of :mod:`.kvpool`
(:class:`~.kvpool.KvPool`: blocks, radix prefix sharing, copy-on-write,
host offload, int8 rows) with one chunked prefill program, and runs the
resident loop (several decode chunks per launch) on the card, whose
chunks become speculative draft/verify rounds with ``spec_tokens``. The
ring backend and the fleet router are not ported yet (ROADMAP.md A.8,
A.7). ``apps/serve.py`` is the driver.
"""

from .buckets import BucketSpec
from .engine import EngineDraining, ServeEngine, SingleDeviceSlotBackend
from .kvpool import HostKvStore, KvPool, PoolExhausted, block_demand
from .queue import QueueFull, Request, RequestQueue, Response

__all__ = ["BucketSpec", "ServeEngine", "SingleDeviceSlotBackend",
           "QueueFull", "Request", "RequestQueue", "Response",
           "EngineDraining", "KvPool", "PoolExhausted", "HostKvStore",
           "block_demand"]
