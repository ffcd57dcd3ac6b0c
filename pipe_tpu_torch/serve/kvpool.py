"""Paged KV memory: radix-tree prefix sharing, copy-on-write, host offload,
int8 KV rows.

Counterpart of ``pipe_tpu/serve/kvpool.py``. The slab backend reserves
``max_len`` cache rows per slot whatever the request needs, so memory, not
compute, caps live slots. This module makes KV memory a resource:

* :class:`KvPool` -- a HOST-side allocator over ``num_blocks`` physical
  blocks of ``block_size`` rows each: numpy/dict bookkeeping (free list,
  refcounts, radix tree, eviction clock) that touches no device. A slot
  reserves ``ceil((prompt_len + max_new - 1) / block_size)`` blocks at
  admission.
* **Radix tree over prefix blocks.** Full prompt blocks are content-addressed
  by a rolling chain hash of the token prefix, so a digest is a path in a
  trie; path-compressed :class:`RadixNode` runs split on divergence, so
  eviction walks leaf-first and hot nodes can be listed.
* **Copy-on-write sharing.** Requests sharing a system prompt pin one
  physical copy per block (per-digest refcounts). A write into a shared
  block (the prefill recompute tail) forks it first: the pool hands the
  backend ``(src, dst)`` copy pairs and the slot's table points at the
  private copy.
* **Block-level eviction and host offload.** Under pressure the allocator
  reclaims cold refcount-0 blocks one at a time, deepest (leaf) digest
  first, oldest last-touch first among leaves. With a :class:`HostKvStore`
  attached (:meth:`KvPool.attach_offload`) an evicted block's rows spill to
  host memory (the digest stays in the tree with ``block=None``) and are
  restored at the next admission that reuses it (``Admission.restores``).
* **Device helpers** (:func:`storage_for`, :func:`flat_row_index`,
  :func:`gather_block_cache`, :func:`scatter_block_rows`,
  :func:`copy_block`) -- the gather/scatter indexing the backend runs inside
  its captured prefill-chunk and decode programs. Every index is an int64
  tensor, so a CUDA graph can read it; the pool arrays are updated in place.

The sacrificial block
---------------------
Physical block 0 is never allocated. Table rows are ``table_width`` entries
whose unreserved tail stays 0, and the flat row index clamps the block index
at ``table_width - 1``, so every overshoot write (decode past retirement
inside a chunk, prefill padding past the prompt, a released slot still
riding the fixed-shape decode program) lands in block 0.
:meth:`KvPool.release` zeroes the slot's table row on the host, so a dead
slot can never corrupt a block that has been reallocated.

Refcount monotonicity
---------------------
A slot that covers digest ``i`` read-only also covers every shallower digest
``j < i`` (admission reuses a LEADING chain), so along any chain refcounts
are non-increasing with depth: every refcount-0 resident digest is
reachable leaf-first, and an offloaded digest is re-referenced only through
an admission that first restores it.

int8 KV rows reuse ``inference/quant.py``: storage holds int8 codes plus one
float32 scale per row per head, quantized on scatter and dequantized inside
the gather. Offload payloads are raw host copies of the stored dtype, so an
offload -> restore round trip is bitwise for both.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.telemetry import get_registry

__all__ = ["KvPool", "PoolExhausted", "Admission", "HostKvStore",
           "RadixNode", "block_demand", "prefix_hashes",
           "prefix_match_depth", "storage_for", "gather_block_cache",
           "scatter_block_rows", "flat_row_index", "copy_block"]

SACRIFICIAL = 0


class PoolExhausted(RuntimeError):
    """Raised by :meth:`KvPool.admit` when the pool cannot cover a
    request's block demand — the paged analog of
    :class:`~.queue.QueueFull`, carrying the same style of detail so
    admission control can park instead of thrash."""

    def __init__(self, message: str, *, demand: int = 0, free: int = 0,
                 evictable: int = 0, total: int = 0):
        super().__init__(message)
        self.demand = demand
        self.free = free
        self.evictable = evictable
        self.total = total


def block_demand(prompt_len: int, max_new_tokens: int,
                 block_size: int) -> int:
    """Blocks a request must reserve. The last sampled token's KV row is
    never written (retirement happens first), hence ``- 1``; decode
    overshoot past that lands in the sacrificial block."""
    rows = prompt_len + max_new_tokens - 1
    return -(-rows // block_size)


def prefix_hashes(prompt: Sequence[int], block_size: int) -> List[str]:
    """Rolling content hash per FULL prompt block (the partial tail
    block is always private, never cached). Digest ``i`` covers blocks
    ``0..i``, so a digest uniquely names a PATH in the radix tree — two
    prompts share digest ``i`` iff their first ``(i+1)*block_size``
    tokens are identical."""
    out: List[str] = []
    h = hashlib.sha256()
    for i in range(len(prompt) // block_size):
        h.update(np.asarray(prompt[i * block_size:(i + 1) * block_size],
                            np.int64).tobytes())
        out.append(h.hexdigest())
    return out


def prefix_match_depth(hashes: Sequence[str], resident) -> int:
    """Leading blocks of a hash chain present in ``resident`` (a set of
    digests) — the fleet placement scorer's matcher."""
    depth = 0
    while depth < len(hashes) and hashes[depth] in resident:
        depth += 1
    return depth


@dataclasses.dataclass
class Admission:
    """What :meth:`KvPool.admit` hands the backend: the slot's table
    row, where prefill may resume (``resume_from`` — everything before
    it is covered by shared cached blocks), the COW copies to run
    before any chunk writes, and the host→device ``restores`` of
    offloaded blocks this admission reuses."""

    slot: int
    table: np.ndarray                    # [table_width] int32
    resume_from: int
    shared_len: int
    prefix_hits: int
    cow_forks: List[Tuple[int, int]]     # (src, dst) physical ids
    blocks: List[int]
    rows_needed: int
    restores: List[Tuple[int, dict]] = dataclasses.field(
        default_factory=list)            # (dst block id, host payload)


class RadixNode:
    """Path-compressed radix node: ``run`` is a chain of digests with no
    divergence between them; children diverge after the run's tail."""

    __slots__ = ("run", "parent", "children")

    def __init__(self, run: List[str], parent: Optional["RadixNode"]):
        self.run = run
        self.parent = parent
        self.children: List["RadixNode"] = []


class HostKvStore:
    """Host-memory spill target for offloaded KV blocks: an
    insertion-ordered digest → payload map with optional block/byte
    caps. ``put`` returns the digests it had to drop (oldest first) to
    stay under capacity — possibly including the one just put, when a
    single payload exceeds the byte cap."""

    def __init__(self, *, max_blocks: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.max_blocks = max_blocks
        self.max_bytes = max_bytes
        self._data: "OrderedDict[str, dict]" = OrderedDict()
        self._sizes: Dict[str, int] = {}
        self._nbytes = 0

    @staticmethod
    def payload_nbytes(payload: dict) -> int:
        return sum(int(np.asarray(a).nbytes) for a in payload.values())

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, digest: str) -> bool:
        return digest in self._data

    def put(self, digest: str, payload: dict) -> List[str]:
        if digest in self._data:
            self.pop(digest)
        nb = self.payload_nbytes(payload)
        self._data[digest] = payload
        self._sizes[digest] = nb
        self._nbytes += nb
        dropped: List[str] = []
        while ((self.max_blocks is not None
                and len(self._data) > self.max_blocks)
               or (self.max_bytes is not None
                   and self._nbytes > self.max_bytes)):
            d, _ = self._data.popitem(last=False)
            self._nbytes -= self._sizes.pop(d)
            dropped.append(d)
            if d == digest:
                break
        return dropped

    def get(self, digest: str) -> Optional[dict]:
        return self._data.get(digest)

    def pop(self, digest: str) -> Optional[dict]:
        payload = self._data.pop(digest, None)
        if payload is not None:
            self._nbytes -= self._sizes.pop(digest)
        return payload

    def stats(self) -> dict:
        return {"blocks": len(self._data), "nbytes": self._nbytes}


class _Cached:
    __slots__ = ("block", "refs", "tokens", "touch")

    def __init__(self, block: Optional[int],
                 tokens: Optional[np.ndarray] = None):
        self.block = block       # physical id; None while offloaded
        self.refs = 0
        self.tokens = tokens     # this block's token ids (replication)
        self.touch = 0


class _SlotMeta:
    __slots__ = ("blocks", "rows_needed", "registered")

    def __init__(self, blocks, rows_needed, registered):
        self.blocks = blocks          # [(block_id, hash-or-None)]
        self.rows_needed = rows_needed
        self.registered = registered  # hashes first published by this slot


class KvPool:
    """Host-side paged-KV allocator. Single-threaded (the engine tick
    discipline); never touches the device.

    ``num_blocks`` counts physical blocks INCLUDING the sacrificial
    block 0, so ``num_blocks - 1`` are allocatable. ``gather_slack_rows``
    widens the table (with sacrificial entries) past ``max_len`` so a
    fixed-shape prefill chunk starting at ``prompt_len - 1`` can always
    slice ``chunk`` rows out of the gathered view without clamping.
    """

    def __init__(self, *, num_blocks: int, block_size: int, num_slots: int,
                 max_len: int, prefix_cache: bool = True,
                 gather_slack_rows: int = 0):
        if block_size < 1 or (block_size & (block_size - 1)) != 0:
            raise ValueError(
                f"block_size must be a positive power of two, got "
                f"{block_size}")
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is sacrificial), got "
                f"{num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefix_cache = prefix_cache
        self.max_blocks = -(-max_len // block_size)
        ext = -(-(max_len + gather_slack_rows) // block_size)
        self.table_width = ext + 1
        self.table = np.zeros((num_slots, self.table_width), np.int32)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._cached: Dict[str, _Cached] = {}
        # refcount-0 RESIDENT digests, oldest last-touch first — the
        # eviction scan order (leaf-first within that order)
        self._lru: "OrderedDict[str, int]" = OrderedDict()
        self._slot_meta: List[Optional[_SlotMeta]] = [None] * num_slots
        self._root = RadixNode([], None)
        self._node_of: Dict[str, Tuple[RadixNode, int]] = {}
        self._clock = 0
        self._store: Optional[HostKvStore] = None
        self._read_block: Optional[Callable[[int], dict]] = None

    # -- capacity ----------------------------------------------------------

    @property
    def allocatable(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def evictable_blocks(self) -> int:
        return len(self._lru)

    @property
    def offloaded_blocks(self) -> int:
        return sum(1 for e in self._cached.values() if e.block is None)

    def demand_for(self, prompt_len: int, max_new_tokens: int) -> int:
        return block_demand(prompt_len, max_new_tokens, self.block_size)

    def attach_offload(self, store: HostKvStore,
                       read_block: Callable[[int], dict]) -> None:
        """Arm host offload: under pressure, evicted blocks spill into
        ``store`` (payload = ``read_block(physical_id)``, a dict of host
        arrays in storage dtype) instead of being dropped, and
        :meth:`admit` schedules their restore when a prompt rehits
        them."""
        self._store = store
        self._read_block = read_block

    @property
    def offload_enabled(self) -> bool:
        return self._store is not None and self._read_block is not None

    # -- prefix hashing ----------------------------------------------------

    def prefix_hashes(self, prompt: Sequence[int]) -> List[str]:
        return prefix_hashes(prompt, self.block_size)

    def _lookup(self, hashes: List[str]) -> int:
        # offloaded digests stay in ``_cached`` (block=None) and still
        # count as hits: restoring from host beats recomputing prefill
        hit = 0
        while hit < len(hashes) and hashes[hit] in self._cached:
            hit += 1
        return hit

    def cached_prefix_blocks(self, prompt: Sequence[int]) -> int:
        """Leading full blocks of ``prompt`` already in the cache
        (resident or offloaded) — the router's warm-handoff probe."""
        if not self.prefix_cache:
            return 0
        return self._lookup(self.prefix_hashes(prompt))

    def cached_prefix_entries(
            self, prompt: Sequence[int]) -> List[Tuple[str, int]]:
        """The leading RESIDENT cached full blocks of ``prompt`` as
        ``(hash, physical_block_id)`` pairs — what a KV handoff exports
        from a session's old home replica. Stops at the first offloaded
        digest (export reads device blocks)."""
        if not self.prefix_cache:
            return []
        out: List[Tuple[str, int]] = []
        for h in self.prefix_hashes(prompt):
            ent = self._cached.get(h)
            if ent is None or ent.block is None:
                break
            out.append((h, ent.block))
        return out

    # -- radix tree --------------------------------------------------------

    def _link(self, digest: str, parent: Optional[str]) -> None:
        """Insert ``digest`` as the child of ``parent`` (None = root).
        Extends the parent node's run when the parent is a childless run
        tail; otherwise splits the run after the parent (split on
        divergence) and attaches a fresh leaf."""
        if digest in self._node_of:
            return
        if parent is None or parent not in self._node_of:
            node, pos = self._root, -1
        else:
            node, pos = self._node_of[parent]
        if pos == len(node.run) - 1 and not node.children:
            node.run.append(digest)
            self._node_of[digest] = (node, len(node.run) - 1)
            return
        if pos < len(node.run) - 1:
            self._split(node, pos + 1)
        child = RadixNode([digest], node)
        node.children.append(child)
        self._node_of[digest] = (child, 0)

    def _split(self, node: RadixNode, cut: int) -> None:
        suffix = RadixNode(node.run[cut:], node)
        suffix.children = node.children
        for c in suffix.children:
            c.parent = suffix
        node.run = node.run[:cut]
        node.children = [suffix]
        for j, d in enumerate(suffix.run):
            self._node_of[d] = (suffix, j)

    def _successors(self, digest: str) -> List[str]:
        node, pos = self._node_of[digest]
        if pos + 1 < len(node.run):
            return [node.run[pos + 1]]
        return [c.run[0] for c in node.children]

    def _is_frontier(self, digest: str) -> bool:
        """No RESIDENT descendant: evicting/offloading this digest
        cannot strand a deeper block that still points through it."""
        for s in self._successors(digest):
            ent = self._cached.get(s)
            if ent is not None and ent.block is not None:
                return False
        return True

    def _drop_from(self, digest: str) -> List[str]:
        """Remove ``digest`` AND every deeper digest from the tree,
        returning all removed digests. Entry/block cleanup is the
        caller's job."""
        node, pos = self._node_of[digest]
        removed = list(node.run[pos:])
        del node.run[pos:]
        stack = node.children
        node.children = []
        while stack:
            n = stack.pop()
            removed.extend(n.run)
            stack.extend(n.children)
        for d in removed:
            self._node_of.pop(d, None)
        if node is not self._root and not node.run and not node.children:
            node.parent.children.remove(node)
        return removed

    def _path_digests(self, digest: str) -> List[str]:
        node, pos = self._node_of[digest]
        parts = [node.run[:pos + 1]]
        node = node.parent
        while node is not None:
            parts.append(node.run)
            node = node.parent
        return [d for run in reversed(parts) for d in run]

    def _radix_node_count(self) -> int:
        n = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root or node.run:
                n += 1
            stack.extend(node.children)
        return n

    def _touch(self, digest: str) -> None:
        self._clock += 1
        ent = self._cached.get(digest)
        if ent is not None:
            ent.touch = self._clock
        if digest in self._lru:
            self._lru.move_to_end(digest)

    # -- handoff import ----------------------------------------------------

    def take_blocks(self, n: int) -> List[int]:
        """Pop up to ``n`` physical blocks (free first, then block-level
        eviction/offload) for an external write — the import side of a
        KV handoff. Returns fewer than ``n`` when the pool can't cover
        it; the caller seats what fit."""
        out: List[int] = []
        for _ in range(n):
            try:
                out.append(self._alloc())
            except PoolExhausted:
                break
        return out

    def seat_prefix(self, entries: Sequence[Tuple[str, int]], *,
                    chain: Optional[Sequence[str]] = None) -> int:
        """Register externally-written blocks as cached prefix entries
        (refs=0 → evictable, exactly the state :meth:`release` leaves a
        retired slot's published blocks in). The block content must
        already be on device. ``entries`` is a leading hash chain;
        ``chain`` optionally supplies the FULL chain (when the caller
        filtered already-cached digests out of ``entries``) so tree
        parentage stays exact. Skips hashes already resident — returning
        the colliding block to the free list — and revives offloaded
        duplicates in place (the import block becomes the resident
        copy), so a handoff racing a local prefill never
        double-registers."""
        parent_of: Dict[str, Optional[str]] = {}
        seq = list(chain) if chain is not None else [h for h, _ in entries]
        prev: Optional[str] = None
        for h in seq:
            parent_of[h] = prev
            prev = h
        n = 0
        for h, bid in entries:
            if not self.prefix_cache:
                self._free.append(bid)
                continue
            ent = self._cached.get(h)
            if ent is not None:
                if ent.block is None:
                    # offloaded duplicate: the imported device copy
                    # revives it; the host payload is now redundant
                    ent.block = bid
                    if self._store is not None:
                        self._store.pop(h)
                    if ent.refs <= 0:
                        self._lru[h] = bid
                        self._lru.move_to_end(h)
                    self._touch(h)
                    n += 1
                else:
                    self._free.append(bid)
                continue
            self._cached[h] = _Cached(bid)
            self._link(h, parent_of.get(h))
            self._lru[h] = bid
            self._lru.move_to_end(h)
            self._touch(h)
            n += 1
        return n

    def invalidate(self, hashes: Sequence[str]) -> int:
        """Drop cached entries (router KV handoff: a session remapped
        off a sick home replica must not find a stale prefix here).
        Dropping a digest drops its whole subtree — a descendant whose
        ancestor is gone can never be matched again. Ref-held blocks
        merely become unshareable — they free to the free list when
        their last holder releases."""
        n = 0
        for h in hashes:
            if h not in self._cached:
                continue
            for d in self._drop_from(h):
                ent = self._cached.pop(d, None)
                if ent is None:
                    continue
                n += 1
                if ent.block is None:
                    if self._store is not None:
                        self._store.pop(d)
                elif ent.refs <= 0:
                    self._lru.pop(d, None)
                    self._free.append(ent.block)
        return n

    # -- allocation --------------------------------------------------------

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        # leaf-first, oldest-touch-first: scan the eviction clock for
        # the oldest refcount-0 digest with no resident descendant
        for h in self._lru:
            if self._is_frontier(h):
                return self._evict_one(h)
        raise PoolExhausted(
            "kv pool exhausted mid-admission (allocator bug: demand was "
            "pre-checked)", demand=1, free=0, evictable=0,
            total=self.allocatable)

    def _evict_one(self, h: str) -> int:
        reg = get_registry()
        ent = self._cached[h]
        bid = ent.block
        self._lru.pop(h, None)
        reg.counter("serve.kv.evictions").inc()
        if self.offload_enabled:
            payload = self._read_block(bid)
            nbytes = HostKvStore.payload_nbytes(payload)
            dropped = self._store.put(h, payload)
            if h in dropped:
                # a payload the store can't hold at all: hard eviction
                dropped.remove(h)
                reg.counter("serve.kv.offload_dropped").inc()
                self._hard_drop(h)
            else:
                ent.block = None
                reg.counter("serve.kv.offload_out").inc()
                reg.counter("serve.kv.offload_bytes").inc(nbytes)
            for d in dropped:
                self._drop_offloaded(d)
        else:
            self._hard_drop(h)
        return bid

    def _hard_drop(self, h: str) -> None:
        """Remove ``h`` (whose block the caller now owns) and its
        subtree from tree + cache, freeing what the drop strands."""
        for d in self._drop_from(h):
            ent = self._cached.pop(d, None)
            if ent is None or d == h:
                continue
            if ent.block is None:
                if self._store is not None:
                    self._store.pop(d)
                get_registry().counter("serve.kv.offload_dropped").inc()
            elif ent.refs <= 0:
                self._lru.pop(d, None)
                self._free.append(ent.block)

    def _drop_offloaded(self, h: str) -> None:
        """The host store aged digest ``h`` out: drop it and its whole
        subtree (deeper offloaded payloads die with it; stranded
        refcount-0 resident imports free)."""
        reg = get_registry()
        if h not in self._node_of:
            self._cached.pop(h, None)
            reg.counter("serve.kv.offload_dropped").inc()
            return
        for d in self._drop_from(h):
            ent = self._cached.pop(d, None)
            if ent is None:
                continue
            if ent.block is None:
                if self._store is not None:
                    self._store.pop(d)
                reg.counter("serve.kv.offload_dropped").inc()
            elif ent.refs <= 0:
                self._lru.pop(d, None)
                self._free.append(ent.block)

    def _plan(self, prompt_len: int, max_new_tokens: int,
              hashes: Optional[List[str]], chunk: int):
        """(demand, hit, reuse, t0, restores): how many blocks, how many
        cache hits, how many hits survive as read-only shares (vs
        forked), where prefill resumes, and how many reused digests must
        first restore from the host store. ``t0`` must still compute
        position ``prompt_len - 1`` (the first sampled token needs ``h``
        there), so a fully-cached prompt resumes at the last chunk
        boundary and forks the shared blocks its recompute tail
        rewrites."""
        bs = self.block_size
        demand = block_demand(prompt_len, max_new_tokens, bs)
        hit = self._lookup(hashes) if hashes is not None else 0
        shared_len = hit * bs
        t0 = min(shared_len, ((prompt_len - 1) // chunk) * chunk)
        reuse = min(hit, t0 // bs)
        restores = 0
        if hashes is not None:
            restores = sum(1 for i in range(reuse)
                           if self._cached[hashes[i]].block is None)
        return demand, hit, reuse, t0, restores

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  prompt: Optional[Sequence[int]] = None, *,
                  chunk: int = 1) -> bool:
        """Admission probe: can the pool cover this request right now
        (free + evictable/offloadable, minus shared-prefix hits, plus a
        fresh block per offloaded digest it must restore)? Read-only."""
        hashes = (self.prefix_hashes(prompt)
                  if prompt is not None and self.prefix_cache else None)
        demand, hit, reuse, _, restores = self._plan(
            prompt_len, max_new_tokens, hashes, chunk)
        if demand > self.max_blocks:
            return False
        need = restores + (hit - reuse) + (demand - hit)
        return need <= len(self._free) + len(self._lru)

    def admit(self, slot: int, prompt: Sequence[int],
              max_new_tokens: int, *, chunk: int = 1) -> Admission:
        """Reserve the slot's FULL block demand (no mid-decode OOM),
        reusing cached prefix blocks read-only — restoring offloaded
        ones from the host store first — and forking the ones the
        prefill recompute tail will write. Raises :class:`PoolExhausted`
        without mutating anything when the pool can't cover it."""
        if self._slot_meta[slot] is not None:
            raise RuntimeError(
                f"slot {slot} admitted twice without release (engine "
                f"bookkeeping bug)")
        plen = len(prompt)
        bs = self.block_size
        hashes = self.prefix_hashes(prompt) if self.prefix_cache else None
        demand, hit, reuse, t0, n_restores = self._plan(
            plen, max_new_tokens, hashes, chunk)
        rows = plen + max_new_tokens - 1
        need = n_restores + (hit - reuse) + (demand - hit)
        avail = len(self._free) + len(self._lru)
        if demand > self.max_blocks or need > avail:
            raise PoolExhausted(
                f"request needs {need} blocks ({demand} total, "
                f"{hit} prefix hits, {reuse} reusable) but the pool has "
                f"{len(self._free)} free + {len(self._lru)} evictable of "
                f"{self.allocatable}",
                demand=need, free=len(self._free),
                evictable=len(self._lru), total=self.allocatable)
        reg = get_registry()
        full = plen // bs
        # pin the whole hit chain so mid-admission eviction can never
        # reclaim a block this admission is about to reuse or fork from
        pinned: List[str] = []
        for i in range(hit):
            h = hashes[i]
            if self._cached[h].refs == 0 and h in self._lru:
                self._lru.pop(h)
                pinned.append(h)
        blocks: List[int] = []
        meta_blocks: List[Tuple[int, Optional[str]]] = []
        forks: List[Tuple[int, int]] = []
        restores: List[Tuple[int, dict]] = []
        registered = set()
        for i in range(reuse):                       # read-only shares
            h = hashes[i]
            ent = self._cached[h]
            if ent.block is None:                    # restore from host
                dst = self._alloc()
                payload = (self._store.pop(h)
                           if self._store is not None else None)
                if payload is None:
                    raise RuntimeError(
                        f"offloaded kv block {h[:12]} has no host "
                        f"payload (allocator bug)")
                ent.block = dst
                restores.append((dst, payload))
            ent.refs += 1
            self._touch(h)
            blocks.append(ent.block)
            meta_blocks.append((ent.block, h))
        for i in range(reuse, hit):                  # copy-on-write forks
            h = hashes[i]
            ent = self._cached[h]
            dst = self._alloc()
            if ent.block is None:
                # fork of an offloaded block: fill the private copy
                # straight from the host payload (the cached original
                # stays offloaded, payload retained)
                payload = (self._store.get(h)
                           if self._store is not None else None)
                if payload is None:
                    raise RuntimeError(
                        f"offloaded kv block {h[:12]} has no host "
                        f"payload (allocator bug)")
                restores.append((dst, payload))
            else:
                forks.append((ent.block, dst))
            self._touch(h)
            blocks.append(dst)
            meta_blocks.append((dst, None))
        for i in range(hit, demand):                 # fresh blocks
            bid = self._alloc()
            h = None
            if hashes is not None and i < full:
                # a full prompt block this prefill writes end-to-end:
                # publish it (the write completes before any other
                # admission can hit the entry — single-threaded tick)
                h = hashes[i]
                ent = _Cached(bid, tokens=np.asarray(
                    prompt[i * bs:(i + 1) * bs], np.int64))
                ent.refs = 1
                self._cached[h] = ent
                self._link(h, hashes[i - 1] if i > 0 else None)
                self._touch(h)
                registered.add(h)
            blocks.append(bid)
            meta_blocks.append((bid, h))
        for h in pinned:                             # unpin fork sources
            ent = self._cached.get(h)
            if ent is not None and ent.refs == 0 and ent.block is not None:
                self._lru[h] = ent.block
                self._lru.move_to_end(h)
        row = np.zeros(self.table_width, np.int32)
        row[:demand] = blocks
        self.table[slot, :] = row
        self._slot_meta[slot] = _SlotMeta(meta_blocks, rows, registered)
        if hit:
            reg.counter("serve.kv.prefix_hits").inc(hit)
        if hashes is not None and full > hit:
            reg.counter("serve.kv.prefix_misses").inc(full - hit)
        if hit and full and hit == full:
            # counterfactual gen-1 baseline: a whole-prefix cache (exact
            # full-block prefix match only) would have hit these blocks
            # too; partial hits below are radix-only wins
            reg.counter("serve.kv.prefix_whole_hits").inc(hit)
        if forks:
            reg.counter("serve.kv.cow_forks").inc(len(forks))
        if restores:
            reg.counter("serve.kv.offload_restores").inc(len(restores))
        return Admission(slot=slot, table=row, resume_from=t0,
                         shared_len=hit * bs, prefix_hits=hit,
                         cow_forks=forks, blocks=blocks, rows_needed=rows,
                         restores=restores)

    def release(self, slot: int, *, failed: bool = False) -> None:
        """Retire a slot: zero its table row (the dead slot decodes into
        the sacrificial block from now on), free private blocks, decref
        shared ones — refcount-0 cached blocks become evictable, not
        free (a future prompt may hit them). ``failed=True`` (prefill
        raised mid-write) unpublishes the hashes this admission
        registered: their content is garbage."""
        meta = self._slot_meta[slot]
        self.table[slot, :] = SACRIFICIAL
        if meta is None:
            return
        self._slot_meta[slot] = None
        for bid, h in meta.blocks:
            ent = self._cached.get(h) if h is not None else None
            if ent is not None and ent.block == bid:
                ent.refs -= 1
                if ent.refs <= 0:
                    if failed and h in meta.registered:
                        self._unpublish(h)
                        self._free.append(bid)
                    else:
                        self._lru[h] = bid
                        self._touch(h)
            else:
                self._free.append(bid)

    def _unpublish(self, h: str) -> None:
        """A failed prefill's half-written publish: drop the digest and
        its subtree. The caller frees ``h``'s own block; deeper entries
        are either held by this same slot (freed as their meta entries
        decref to None-cached) or refcount-0 leftovers."""
        if h not in self._node_of:
            self._cached.pop(h, None)
            return
        for d in self._drop_from(h):
            ent = self._cached.pop(d, None)
            if ent is None or d == h:
                continue
            if ent.block is None:
                if self._store is not None:
                    self._store.pop(d)
            elif ent.refs <= 0:
                self._lru.pop(d, None)
                self._free.append(ent.block)

    # -- fleet directory ---------------------------------------------------

    def prefix_digest_summary(self, *, limit: int = 512) -> dict:
        """What a replica advertises over obs frames: resident (and
        offloaded) prefix digests plus occupancy — the fleet placement
        scorer matches an incoming prompt's hash chain against
        ``digests`` and weighs depth by headroom."""
        s = self.stats()
        return {
            "block_size": self.block_size,
            "digests": list(self._cached.keys())[:limit],
            "occupancy": s["occupancy"],
            "blocks_free": s["blocks_free"],
            "blocks_total": s["blocks_total"],
        }

    def hot_prefixes(self, min_refs: int, *, limit: int = 4) -> List[dict]:
        """Digests shared by at least ``min_refs`` live slots, deepest
        first, with the full token chain from the root (reconstructable
        only for locally-published blocks — imports carry no tokens).
        The fleet controller replicates these to siblings proactively."""
        cands = sorted(
            (d for d, e in self._cached.items()
             if e.refs >= min_refs and e.block is not None
             and d in self._node_of),
            key=lambda d: (-self._cached[d].refs,
                           -len(self._path_digests(d))))
        out: List[dict] = []
        covered: set = set()
        for d in cands:
            if len(out) >= limit:
                break
            if d in covered:
                continue
            path = self._path_digests(d)
            toks: List[int] = []
            ok = True
            for p in path:
                ent = self._cached.get(p)
                if ent is None or ent.tokens is None:
                    ok = False
                    break
                toks.extend(int(t) for t in ent.tokens)
            if not ok:
                continue
            covered.update(path)
            out.append({"digest": d, "refs": self._cached[d].refs,
                        "depth": len(path), "tokens": toks})
        return out

    # -- metrics -----------------------------------------------------------

    def stats(self) -> dict:
        total = self.allocatable
        live = [m for m in self._slot_meta if m is not None]
        reserved = sum(len(m.blocks) for m in live)
        needed = sum(m.rows_needed for m in live)
        in_use = total - len(self._free) - len(self._lru)
        resident = sum(1 for e in self._cached.values()
                       if e.block is not None)
        return {
            "blocks_total": total,
            "blocks_free": len(self._free),
            "blocks_evictable": len(self._lru),
            "blocks_in_use": in_use,
            "blocks_offloaded": len(self._cached) - resident,
            "occupancy": in_use / total if total else 0.0,
            # internal fragmentation: reserved rows the live requests can
            # never write (tail of each slot's last block)
            "fragmentation": (1.0 - needed / (reserved * self.block_size)
                              if reserved else 0.0),
            "cached_blocks": resident,
            "shared_blocks": sum(
                1 for e in self._cached.values()
                if e.refs > 1 and e.block is not None),
            "radix_nodes": self._radix_node_count(),
            "host_kv_bytes": (self._store.nbytes
                              if self._store is not None else 0),
        }

    def observe(self) -> None:
        reg = get_registry()
        for k, v in self.stats().items():
            reg.gauge(f"serve.kv.{k}").set(float(v))


# -- device-side indexing (run inside the backend's captured programs) -----

def storage_for(proto, n_layers: int, num_blocks: int, block_size: int, *,
                kv_dtype: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Pool device arrays ``[n_layers, num_blocks, block_size, heads,
    head_dim]`` from one layer's attention-cache prototype
    (``make_cache(1, L)``), on its device. ``kv_dtype="int8"`` stores int8
    codes plus one float32 scale per row per head (``k_scale``/``v_scale``,
    last dim 1)."""
    if not (isinstance(proto, dict) and set(proto) == {"k", "v"}):
        raise TypeError(
            "paged KV needs a {'k','v'} attention cache prototype, got "
            f"{type(proto).__name__} with "
            f"{sorted(proto) if isinstance(proto, dict) else '?'}")
    out = {}
    for name, a in proto.items():
        shape = (n_layers, num_blocks, block_size) + tuple(a.shape[2:])
        if kv_dtype is None:
            out[name] = torch.zeros(shape, dtype=a.dtype, device=a.device)
        elif kv_dtype == "int8":
            out[name] = torch.zeros(shape, dtype=torch.int8,
                                    device=a.device)
            out[name + "_scale"] = torch.zeros(
                shape[:-1] + (1,), dtype=torch.float32, device=a.device)
        else:
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    return out


def flat_row_index(table_row: torch.Tensor, positions: torch.Tensor,
                   block_size: int) -> torch.Tensor:
    """Physical flat row index for each position: block-table gather with
    the block index CLAMPED to the trailing sacrificial entry, so any
    position past the reserved region maps into block 0. ``table_row`` is
    ``[W]`` with ``positions`` of any shape, or ``[S, W]`` with
    ``positions [S, n]`` (one table row per slot)."""
    mb = table_row.shape[-1] - 1
    bi = torch.clamp(positions // block_size, max=mb)
    blocks = (table_row[bi] if table_row.dim() == 1
              else torch.gather(table_row, 1, bi))
    return blocks * block_size + positions % block_size


def gather_block_cache(pool_layer: Dict[str, torch.Tensor],
                       table_row: torch.Tensor, *, block_size: int,
                       compute_dtype) -> Dict[str, torch.Tensor]:
    """Rows of the first ``W - 1`` table entries as a contiguous ``{'k',
    'v'}`` cache ``[1, R, heads, head_dim]`` for a table row ``[W]``
    (``[S, R, ...]`` for tables ``[S, W]``), R = ``(W - 1) * block_size``.
    The layer's ``decode`` runs on it unchanged: rows from sacrificial or
    unwritten blocks sit at positions the causal mask kills. int8 pools
    dequantize here."""
    mb = table_row.shape[-1] - 1
    idx = table_row[..., :mb]
    lead = idx.shape[:-1] if table_row.dim() > 1 else (1,)

    def g(name):
        rows = pool_layer[name][idx]             # [..., mb, bs, ...]
        return rows.reshape(lead + (mb * block_size,) + rows.shape[-2:])

    if "k_scale" in pool_layer:
        return {name: (g(name).to(torch.float32)
                       * g(name + "_scale")).to(compute_dtype)
                for name in ("k", "v")}
    return {name: g(name) for name in ("k", "v")}


def scatter_block_rows(pool_layer: Dict[str, torch.Tensor],
                       flat_idx: torch.Tensor,
                       rows: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Write new KV rows ``{'k': [M, heads, head_dim], 'v': ...}`` at
    physical flat indices ``[M]``, in place, and return ``pool_layer``.
    Duplicate indices occur only in the sacrificial block, whose content
    is never read unmasked, so any winner is fine. int8 pools quantize per
    row per head on the way in."""
    from ..inference.quant import quantize_kv_rows

    def flat(a):
        return a.view((a.shape[0] * a.shape[1],) + a.shape[2:])

    for name in ("k", "v"):
        a = pool_layer[name]
        if name + "_scale" in pool_layer:
            q, s = quantize_kv_rows(rows[name])
            flat(a).index_copy_(0, flat_idx, q)
            flat(pool_layer[name + "_scale"]).index_copy_(0, flat_idx, s)
        else:
            flat(a).index_copy_(0, flat_idx, rows[name].to(a.dtype))
    return pool_layer


def copy_block(pool: Dict[str, torch.Tensor], src, dst, *,
               block_axis: int = 1) -> Dict[str, torch.Tensor]:
    """COW fork: copy physical block ``src`` to ``dst`` across every array
    of the pool (all layers at once: a block is ``block_size`` rows of
    every layer under one table entry), in place. ``src``/``dst`` are
    ints or int64 tensors ``[1]`` (a captured program's buffers)."""
    for a in pool.values():
        dev = a.device
        s = torch.as_tensor(src, dtype=torch.int64, device=dev).reshape(1)
        d = torch.as_tensor(dst, dtype=torch.int64, device=dev).reshape(1)
        a.index_copy_(block_axis, d, a.index_select(block_axis, s))
    return pool
