"""Per-dtype flat packing of parameter trees: the stage-sharded layout.

Counterpart of ``pipe_tpu/core/packing.py``. A :class:`PackPlan` lays one
tree's leaves out in per-dtype 1-D buffers; a :class:`StageParamPack` lays
each stage's tree out as one row of per-dtype ``[n, capacity]`` arrays, the
capacity the largest stage's, so row ``j`` is all that stage ``j``'s rank
holds (``Pipe(mesh=...).shard_params``). Trees are nested dicts (keys
sorted), lists and tuples of tensors or arrays, flattened in
``jax.tree_util`` order, so the same numpy trees give ``pipe_tpu``'s rows
byte for byte. The in-program views of the JAX class (``unpack_stage`` under
``lax.switch``) have no counterpart: a rank holds its own stage's modules.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PackPlan", "StageParamPack", "tree_leaves", "tree_flatten",
           "tree_unflatten", "tree_map"]


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in ``jax.tree_util`` order: dict keys sorted,
    lists and tuples in order, None an empty subtree."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", keys, [d for _, d in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(v) for v in tree]
        return ([l for ls, _ in parts for l in ls],
                (type(tree).__name__, len(tree), [d for _, d in parts]))
    return [tree], "leaf"


def _count(treedef) -> int:
    if treedef is None:
        return 0
    if treedef == "leaf":
        return 1
    return sum(_count(d) for d in treedef[2])


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "leaf":
            return next(it)
        kind, keys, subs = d
        vals = [build(s) for s in subs]
        if kind == "dict":
            return dict(zip(keys, vals))
        return tuple(vals) if kind == "tuple" else list(vals)

    return build(treedef)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(getattr(x, "dtype", np.asarray(x).dtype)).name


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class PackPlan:
    """Static layout of one tree's leaves (given as anything with
    ``.shape`` and ``.dtype``) inside per-dtype 1-D buffers."""

    def __init__(self, specs: Sequence[Any]):
        self.specs = [tuple(s.shape) for s in specs]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.specs]
        self.dtypes = [_dtype_name(s) for s in specs]
        self.per_dtype: Dict[str, int] = {}
        for size, dt in zip(self.sizes, self.dtypes):
            self.per_dtype[dt] = self.per_dtype.get(dt, 0) + size

    def pack_np(self, values: Sequence[Any], capacities: Dict[str, int]
                ) -> Dict[str, np.ndarray]:
        """values (in spec order) -> ``{dtype: 1-D zero-padded buffer}``."""
        out = {dt: np.zeros((cap,), dtype=np.dtype(dt))
               for dt, cap in capacities.items()}
        off = {dt: 0 for dt in capacities}
        for v, size, dt in zip(values, self.sizes, self.dtypes):
            out[dt][off[dt]:off[dt] + size] = np.ravel(_numpy(v))
            off[dt] += size
        return out

    def unpack_np(self, carrier: Dict[str, Any]) -> List[np.ndarray]:
        off = {dt: 0 for dt in carrier}
        values = []
        for shape, size, dt in zip(self.specs, self.sizes, self.dtypes):
            flat = _numpy(carrier[dt])[off[dt]:off[dt] + size]
            off[dt] += size
            values.append(np.reshape(flat, shape))
        return values

    def pack(self, values: Sequence[torch.Tensor],
             capacities: Dict[str, int]) -> Dict[str, torch.Tensor]:
        """values (tensors, in spec order) -> ``{dtype: 1-D buffer}`` on the
        values' device."""
        dev = values[0].device if values else torch.device("cpu")
        out = {dt: torch.zeros((cap,), dtype=getattr(torch, dt), device=dev)
               for dt, cap in capacities.items()}
        off = {dt: 0 for dt in capacities}
        for v, size, dt in zip(values, self.sizes, self.dtypes):
            out[dt][off[dt]:off[dt] + size] = v.detach().reshape(-1)
            off[dt] += size
        return out

    def unpack(self, carrier: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Views of the per-dtype buffers, one per spec."""
        off = {dt: 0 for dt in carrier}
        values = []
        for shape, size, dt in zip(self.specs, self.sizes, self.dtypes):
            values.append(carrier[dt][off[dt]:off[dt] + size].view(shape))
            off[dt] += size
        return values


class StageParamPack:
    """Plans and capacities mapping per-stage trees to per-dtype
    ``{dtype: [n, cap]}`` rows (module docstring)."""

    def __init__(self, params_per_stage: Sequence[Any]):
        self.n = len(params_per_stage)
        flat = [tree_flatten(p) for p in params_per_stage]
        self.treedefs = [d for _, d in flat]
        self.plans = [PackPlan(leaves) for leaves, _ in flat]
        self.capacities: Dict[str, int] = {}
        for plan in self.plans:
            for dt, sz in plan.per_dtype.items():
                self.capacities[dt] = max(self.capacities.get(dt, 0), sz)
        if not self.capacities:     # parameterless model: keep one leaf
            self.capacities = {"float32": 1}

    def rows_np(self, params_per_stage: Sequence[Any]
                ) -> Dict[str, np.ndarray]:
        """Every stage's row: ``{dtype: [n, cap]}`` host arrays (what
        ``pipe_tpu``'s ``shard`` places row by row on the mesh)."""
        if len(params_per_stage) != self.n:
            raise ValueError(
                f"{len(params_per_stage)} stages for an {self.n}-stage pack")
        rows = [plan.pack_np(tree_leaves(tree), self.capacities)
                for plan, tree in zip(self.plans, params_per_stage)]
        return {dt: np.stack([r[dt] for r in rows])
                for dt in self.capacities}

    def row(self, s: int, tree: Any, device=None) -> Dict[str, torch.Tensor]:
        """Stage ``s``'s row ``{dtype: [cap]}`` as tensors (on ``device``,
        else the leaves')."""
        leaves = [torch.as_tensor(_numpy(l)) if not isinstance(l, torch.Tensor)
                  else l for l in tree_leaves(tree)]
        row = self.plans[s].pack(leaves, self.capacities)
        return {dt: r.to(device) for dt, r in row.items()} if device else row

    def unshard(self, packed: Dict[str, Any]) -> List[Any]:
        """``{dtype: [n, cap]}`` rows (params or their gradients) back to
        per-stage trees of numpy copies."""
        self.check_packed(packed)
        return [self.unpack_row(s, {dt: _numpy(packed[dt])[s]
                                    for dt in self.capacities})
                for s in range(self.n)]

    def unpack_row(self, s: int, row: Dict[str, Any]) -> Any:
        """Stage ``s``'s tree (numpy copies) from its row."""
        leaves = [np.array(l) for l in self.plans[s].unpack_np(row)]
        return tree_unflatten(self.treedefs[s], leaves)

    def check_packed(self, packed: Dict[str, Any]) -> None:
        """Fail fast on a packed dict of another layout (``pipe_tpu``'s
        check: the dtype keys and every ``[n, cap]`` shape)."""
        if set(packed) != set(self.capacities):
            raise ValueError(
                f"packed params have dtypes {sorted(packed)} but this pack "
                f"expects {sorted(self.capacities)}")
        for dt, cap in self.capacities.items():
            got = tuple(np.shape(packed[dt]))
            if got != (self.n, cap):
                raise ValueError(
                    f"packed[{dt!r}] has shape {got}, expected "
                    f"{(self.n, cap)} — params packed by a different "
                    f"Pipe/balance?")

    def per_device_bytes(self) -> int:
        """Bytes each rank holds: one row of every per-dtype buffer."""
        return sum(cap * np.dtype(dt).itemsize
                   for dt, cap in self.capacities.items())

    def total_param_bytes(self) -> int:
        return sum(sz * np.dtype(dt).itemsize
                   for plan in self.plans
                   for sz, dt in zip(plan.sizes, plan.dtypes))


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    return tree_unflatten(treedef, [fn(*ls) for ls in zip(*[f[0]
                                                            for f in flat])])
