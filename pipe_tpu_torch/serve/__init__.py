"""Continuous-batching serving over the port's generator.

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
fleet router
(:class:`~.router.Router`, a shim over :mod:`~..fleet`) runs N engines behind
one front queue with health-gated failover. :class:`~.ring.RingSlotBackend`
serves over a stage ring of ranks, each holding its stage's weights: the
ring's groups are the slots, and the engine runs on the rank of stage 0.
``apps/serve.py`` is the driver.
"""

from .buckets import BucketSpec
from .engine import EngineDraining, ServeEngine, SingleDeviceSlotBackend
from .kvpool import (Admission, HostKvStore, KvPool, PoolExhausted,
                     block_demand)
from .queue import QueueFull, Request, RequestQueue, Response
from .ring import RingSlotBackend, drive_ring
from .router import (DRAINING, HEALTHY, RETIRED, SUSPECT, WEDGED, Replica,
                     Router, RouterPolicy)

__all__ = ["BucketSpec", "ServeEngine", "SingleDeviceSlotBackend",
           "QueueFull", "Request", "RequestQueue", "Response",
           "EngineDraining", "Router", "RouterPolicy", "Replica",
           "HEALTHY", "SUSPECT", "WEDGED", "DRAINING", "RETIRED",
           "KvPool", "PoolExhausted", "Admission", "HostKvStore",
           "block_demand", "RingSlotBackend", "drive_ring"]
