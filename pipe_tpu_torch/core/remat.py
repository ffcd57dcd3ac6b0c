"""Activation-checkpoint (rematerialization) policy.

Counterpart of the checkpoint modes of ``pipe_tpu/core/remat.py``:
``always`` / ``except_last`` / ``never`` remat micro-batches ``[0, m)`` /
``[0, m-1)`` / ``[]``, computed against the number of micro-batches that
``scatter`` actually produced. Eval mode turns checkpointing off. A stage body
is wrapped in ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``;
dropout replays identically because its seed is an argument of the body.
:func:`split_backward_stage` derives the structural B/W split of a stage
body (notes above :class:`SplitUnsupported`).

**Selective remat** (``remat_policy``): :data:`checkpoint_policies` names the
``jax.checkpoint_policies`` members the port has, each a selective-checkpoint
policy over aten ops (``torch.utils.checkpoint.create_selective_checkpoint_contexts``):
``dots_saveable`` saves the outputs of ``mm``, ``addmm``, ``bmm`` and
``baddbmm`` (JAX's ``dot_general``); ``dots_with_no_batch_dims_saveable``
those of ``mm`` and ``addmm`` only; ``nothing_saveable`` and
``everything_saveable`` save nothing and everything. The backward of a
checkpointed body still re-runs its forward, but a saved op hands back its
stored output instead of computing it again. The flash-attention kernels are
ctypes calls inside an ``autograd.Function``, not aten ops, so no policy can
save their outputs: they are recomputed at the backward under every policy,
as ``pipe_tpu``'s ``dots_saveable`` recomputes the Pallas calls, and a
recompute micro-batch launches the forward kernel as often as without a
policy.
"""

from __future__ import annotations

import contextlib
import functools
import types
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["CHECKPOINT_MODES", "validate_mode", "checkpoint_stop",
           "apply_remat", "checkpoint_policies", "resolve_policy",
           "count_dots", "SplitUnsupported", "split_backward_stage"]

CHECKPOINT_MODES = ("always", "except_last", "never")

_aten = torch.ops.aten
# The aten ops of a matrix product: with a batch dimension, and without.
_BATCHED_DOTS = frozenset({_aten.bmm.default, _aten.baddbmm.default})
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default}) | _BATCHED_DOTS


class RematPolicy:
    """A named selective-checkpoint policy: ``MUST_SAVE`` for the ops it
    saves, ``PREFER_RECOMPUTE`` for the rest. Called as
    ``policy(ctx, op, *args, **kwargs)`` by ``torch.utils.checkpoint``."""

    def __init__(self, name: str, saves: Callable[[object], bool]):
        self.name = name
        self._saves = saves

    def __call__(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        return (CheckpointPolicy.MUST_SAVE if self._saves(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def __repr__(self) -> str:
        return f"checkpoint_policies.{self.name}"


checkpoint_policies = types.SimpleNamespace(
    dots_saveable=RematPolicy("dots_saveable", lambda op: op in _DOTS),
    dots_with_no_batch_dims_saveable=RematPolicy(
        "dots_with_no_batch_dims_saveable",
        lambda op: op in _DOTS and op not in _BATCHED_DOTS),
    nothing_saveable=RematPolicy("nothing_saveable", lambda op: False),
    everything_saveable=RematPolicy("everything_saveable", lambda op: True),
)


def resolve_policy(policy) -> Optional[RematPolicy]:
    """``policy`` as a :class:`RematPolicy`: one of :data:`checkpoint_policies`
    or its name; None stays None. Anything else raises ``ValueError``."""
    if policy is None or isinstance(policy, RematPolicy):
        return policy
    names = sorted(vars(checkpoint_policies))
    if isinstance(policy, str) and policy in names:
        return getattr(checkpoint_policies, policy)
    raise ValueError(f"remat_policy must be one of {' | '.join(names)} "
                     f"(or pipe_tpu_torch.core.remat.checkpoint_policies."
                     f"<name>), got {policy!r}")


def validate_mode(checkpoint: str) -> str:
    if checkpoint not in CHECKPOINT_MODES:
        raise ValueError(
            f"checkpoint is not one of {' | '.join(CHECKPOINT_MODES)!r}: "
            f"{checkpoint!r}")
    return checkpoint


def checkpoint_stop(checkpoint: str, num_microbatches: int, train: bool) -> int:
    """First micro-batch index NOT rematerialized (0 in eval mode)."""
    validate_mode(checkpoint)
    if not train:
        return 0
    m = num_microbatches
    return {"always": m, "except_last": max(m - 1, 0), "never": 0}[checkpoint]


def apply_remat(fn: Callable, *, enabled: bool, policy=None) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` when enabled: its activations
    are dropped after the forward and recomputed in the backward, all of
    them, or under ``policy`` (a :data:`checkpoint_policies` member or its
    name) all but what the policy saves."""
    policy = resolve_policy(policy)
    if not enabled:
        return fn
    if policy is None:
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     policy))


class _DotCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in _DOTS
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def count_dots() -> Iterator[_DotCounter]:
    """Count the matrix products (the ops ``dots_saveable`` saves) dispatched
    inside the block, backward passes it runs included: ``.count``."""
    counter = _DotCounter()
    with counter:
        yield counter


# ---------------------------------------------------------------------------
# The structural B/W split: B takes only input cotangents, W only weight
# gradients.
#
# Counterpart of ``pipe_tpu/core/remat.py``'s ``split_backward_stage``, in
# torch's idiom instead of jaxpr surgery. For the tapped forward the module's
# parameters are swapped for views of a tensor subclass, ``_ParamSide``, so
# every torch call that takes a parameter-side tensor comes to its
# ``__torch_function__`` and every other call runs as it always does (the
# flash kernels' ``autograd.Function`` and its launches among them). The
# classification is positive: a tensor is PARAMETER-SIDE if it is a
# parameter, or if every tensor input of the call that made it was
# parameter-side (casts, slices, reshapes of weights: the CHAIN, whose
# outputs stay ``_ParamSide``); every other tensor is DATA-SIDE. A call
# taking both is a REGION op (``F.linear``, ``F.embedding``,
# ``F.layer_norm``'s affine, a broadcast add or multiply of a parameter):
# its parameter-side inputs enter detached, so the graph from the stage
# input to its output holds no weight path; its data-side inputs are kept as
# taps, and its float outputs are the points where B takes cotangents (JAX's
# ``zs``: ``torch.autograd.grad`` at a non-leaf replaces the zero
# injection). W turns (taps, cotangents) into the gradients of the region's
# parameter-side inputs by a closed-form rule per op (``g_W = g_yᵀ x``,
# ``Σ g_y``, the embedding's index-add, ``Σ g_y x̂``) and runs autograd back
# through the chain to the leaves. Every region output is a cut point, so a
# region op feeding another (a norm scale into a linear) stays exact: the
# cotangent B hands W at an output is already the whole ``dL/dy``. A region
# op without a closed-form rule is differentiated at W by re-running it on
# its taps (exact for a deterministic op). Unlike JAX's ``linear_transpose``,
# a parameter may enter the chain nonlinearly (``exp(w)``): W differentiates
# the chain by autograd.
# ---------------------------------------------------------------------------


class SplitUnsupported(ValueError):
    """The stage body cannot be split exactly: it returns a parameter-side
    value, modifies a tensor in place at a region op, or a parameter reaches
    its output by a path the split cannot see. The message says which."""


_CHAIN, _REGION = "chain", "region"
_F = torch.nn.functional
_T = torch.Tensor


def _tensors(args, kwargs) -> list:
    """The tensors among a call's arguments, one level of lists deep."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(b for b in a if isinstance(b, torch.Tensor))
    return out


def _outputs(out) -> list:
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(t, torch.Tensor)]


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


# --- W's closed-form rules: (bound args, parameter-side names, output
# cotangent) -> {name: gradient}; the data operands each rule reads ---

def _w_linear(a, pn, g):
    g2 = g.reshape(-1, g.shape[-1])
    out = {}
    if "weight" in pn:
        x = a["input"]
        out["weight"] = g2.t().mm(x.reshape(-1, x.shape[-1]))
    if "bias" in pn:
        out["bias"] = g2.sum(0)
    if "input" in pn:
        out["input"] = g.matmul(a["weight"])
    return out


def _w_layer_norm(a, pn, g):
    shape = tuple(a["normalized_shape"])
    dims = tuple(range(g.dim() - len(shape)))
    out = {}
    if "weight" in pn:
        xhat = _F.layer_norm(a["input"], shape, None, None, a.get("eps", 1e-5))
        out["weight"] = (g * xhat).sum(dims)
    if "bias" in pn:
        out["bias"] = g.sum(dims)
    return out


def _w_embedding(a, pn, g):
    w = a["weight"]
    pad = a.get("padding_idx")
    pad = -1 if pad is None else pad % w.shape[0]
    return {"weight": torch.ops.aten.embedding_dense_backward(
        g, a["input"], w.shape[0], pad, bool(a.get("scale_grad_by_freq")))}


def _w_add(a, pn, g):
    out = {}
    if "input" in pn:
        out["input"] = g
    if "other" in pn:
        c = a.get("alpha", 1)
        out["other"] = g if c == 1 else g * c
    return out


def _w_mul(a, pn, g):
    out = {}
    if "input" in pn:
        out["input"] = g * a["other"]
    if "other" in pn:
        out["other"] = g * a["input"]
    return out


def _w_matmul(a, pn, g):
    x, w = a["input"], a["other"]
    if "other" in pn:
        return {"other": x.reshape(-1, x.shape[-1]).t().mm(
            g.reshape(-1, g.shape[-1]))}
    return {"input": g.mm(w.t())}


def _linear_ok(a, pn):
    return "input" not in pn or a["weight"].dim() == 2


def _layer_norm_ok(a, pn):
    return "input" not in pn


def _embedding_ok(a, pn):
    if a.get("max_norm") is not None or a.get("sparse"):
        raise SplitUnsupported(
            "F.embedding with max_norm or sparse=True at a region op: "
            "max_norm renormalizes the weight in place and sparse gradients "
            "do not accumulate into a dense chain")
    return pn == {"weight"}


def _matmul_ok(a, pn):
    x, w = a["input"], a["other"]
    if pn == {"other"}:
        return w.dim() == 2 and x.dim() >= 2
    return pn == {"input"} and x.dim() == 2 and w.dim() == 2


def _always(a, pn):
    return True


# func -> (argument names, applies(bound, pnames), rule, data operands kept)
_RULES: Dict[Any, tuple] = {}
for _f in (_F.linear, torch._C._nn.linear):
    _RULES[_f] = (("input", "weight", "bias"), _linear_ok, _w_linear,
                  {"weight": ("input",), "input": ("weight",)})
for _f in (_F.layer_norm, torch.layer_norm):
    _RULES[_f] = (("input", "normalized_shape", "weight", "bias", "eps"),
                  _layer_norm_ok, _w_layer_norm, {"weight": ("input",)})
_RULES[_F.embedding] = (("input", "weight", "padding_idx", "max_norm",
                         "norm_type", "scale_grad_by_freq", "sparse"),
                        _embedding_ok, _w_embedding,
                        {"weight": ("input", "weight")})   # its row count
for _f in (torch.add, _T.add, _T.__add__):
    _RULES[_f] = (("input", "other", "alpha"), _always, _w_add, {})
for _f in (torch.mul, _T.mul, _T.__mul__):
    _RULES[_f] = (("input", "other"), _always, _w_mul,
                  {"input": ("other",), "other": ("input",)})
for _f in (torch.matmul, _T.matmul, _T.__matmul__):
    _RULES[_f] = (("input", "other"), _matmul_ok, _w_matmul,
                  {"input": ("other",), "other": ("input",)})
del _f


_INPLACE_DUNDERS = frozenset(
    f"__i{op}__" for op in ("add", "sub", "mul", "truediv", "floordiv", "mod",
                            "pow", "matmul", "and", "or", "xor", "lshift",
                            "rshift"))


def _inplace(func, kwargs) -> bool:
    name = getattr(func, "__name__", "")
    return ("out" in kwargs or name in _INPLACE_DUNDERS
            or (name.endswith("_") and not name.startswith("_")))


class _Region:
    """One region op of a tapped forward: what W needs of it. ``params``
    maps an argument (a name, or a leaf index for a call without a rule) to
    its parameter-side tensor (:func:`_source`);
    ``args`` holds the detached operands W reads, with their versions at
    the call."""

    __slots__ = ("func", "rule", "args", "params", "n_out", "versions")

    def __init__(self, func, rule, args, params, n_out):
        self.func, self.rule, self.args = func, rule, args
        self.params, self.n_out = params, n_out
        self.versions = [(t, t._version) for t in self._tap_tensors()]

    def _tap_tensors(self):
        vals = self.args[0] if self.rule is None else self.args.values()
        return [t for t in vals if isinstance(t, torch.Tensor)]

    def wgrad(self, gs) -> list:
        """``[(parameter-side tensor, its gradient)]`` from the cotangents
        ``gs`` of this op's float outputs (None where none reached)."""
        if all(g is None for g in gs):
            return []
        for t, v in self.versions:
            if t._version != v:
                raise SplitUnsupported(
                    f"a data input of {_name(self.func)} was modified in "
                    f"place after the call: W would read the new value")
        if self.rule is None:
            return self._wgrad_by_rerun(gs)
        grads = self.rule(self.args, set(self.params), gs[0])
        return [(p, _fit(grads[k], p)) for k, p in self.params.items()]

    def _wgrad_by_rerun(self, gs) -> list:
        leaves, spec = self.args
        leaves = list(leaves)
        fresh = {}
        for j, p in self.params.items():
            leaves[j] = fresh[j] = p.detach().requires_grad_(True)
        a, kw = pytree.tree_unflatten(leaves, spec)
        with torch.enable_grad():
            ys = [y for y in _outputs(self.func(*a, **kw)) if _is_float(y)]
        pairs = [(y, g) for y, g in zip(ys, gs) if g is not None]
        got = torch.autograd.grad([y for y, _ in pairs], list(fresh.values()),
                                  [g for _, g in pairs], allow_unused=True)
        return [(self.params[j], g) for j, g in zip(fresh, got)
                if g is not None]


def _fit(g, p):
    """``g`` summed to ``p``'s shape (a broadcast operand) in its dtype."""
    if g.shape != p.shape:
        g = g.sum_to_size(p.shape)
    return g if g.dtype == p.dtype else g.to(p.dtype)


def _name(func) -> str:
    return getattr(func, "__qualname__", None) or repr(func)


class _ParamSide(torch.Tensor):
    """A parameter-side tensor of a tapped forward (module notes above):
    its calls go to the :class:`_Recorder` of that forward (``_tap``, a weak
    reference: the recorder holds the region outputs, and W's tensors must
    not keep them alive) while it records; after, they run as a plain
    tensor's (W's backward through the chain)."""

    _tap = None
    _leaf = None        # the parameter, on the view the swap made of it

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ts = _tensors(args, kwargs)
        side = [t for t in ts if isinstance(t, _ParamSide)]
        tap = side[0]._tap if side else None
        rec = tap() if tap is not None else None
        with torch._C.DisableTorchFunctionSubclass():
            if rec is None or not rec.active:
                return func(*args, **kwargs)
            if len(side) == len(ts):
                return rec.chain(func, args, kwargs)
            return rec.region(func, args, kwargs, side)


def _source(p: "_ParamSide") -> torch.Tensor:
    """What W hands to autograd for ``p``: the parameter itself when ``p``
    is its view, else a plain alias of ``p`` in its chain's graph (call with
    ``__torch_function__`` off)."""
    return p._leaf if p._leaf is not None else p.as_subclass(torch.Tensor)


def _plain(x):
    """``x`` detached as a plain tensor if parameter-side (call with
    ``__torch_function__`` off)."""
    return x.detach() if isinstance(x, _ParamSide) else x


class _Recorder:
    """The calls of one tapped forward that take a parameter-side tensor:
    ``calls`` their (function, kind), ``regions`` what W needs of each
    region op, ``ys`` the region outputs. Its methods run with
    ``__torch_function__`` off."""

    def __init__(self):
        self.active = True
        self.calls: list = []
        self.regions: List[_Region] = []
        self.ys: List[torch.Tensor] = []
        self._ref = weakref.ref(self)

    def side(self, p: torch.Tensor) -> "_ParamSide":
        v = p.as_subclass(_ParamSide)
        v._tap = self._ref
        return v

    def chain(self, func, args, kwargs):
        """A call whose tensors are all parameter-side: its tensor outputs
        are too."""
        self.calls.append((func, _CHAIN))
        out = func(*args, **kwargs)
        if isinstance(out, (tuple, list)):
            return type(out)(self._side_of(t) for t in out)
        return self._side_of(out)

    def _side_of(self, t):
        if isinstance(t, torch.Tensor) and not isinstance(t, _ParamSide):
            return self.side(t)
        return t

    def region(self, func, args, kwargs, side):
        """A call taking parameter-side tensors ``side`` and data-side ones:
        run with the former detached, recorded for W."""
        self.calls.append((func, _REGION))
        a = [_plain(t) for t in args]
        kw = {k: _plain(v) for k, v in kwargs.items()} if kwargs else kwargs
        if any(isinstance(x, (tuple, list)) and any(
                isinstance(t, _ParamSide) for t in x)
               for x in (*a, *kw.values())):
            leaves, spec = pytree.tree_flatten((args, kwargs))
            a, kw = pytree.tree_unflatten([_plain(t) for t in leaves], spec)
        if not torch.is_grad_enabled() or not any(t.requires_grad
                                                  for t in side):
            return func(*a, **kw)           # no weight gradient flows here
        if _inplace(func, kwargs):
            raise SplitUnsupported(
                f"{_name(func)} modifies a tensor in place with a parameter "
                f"operand: the split needs the op's output as a new value")
        out = func(*a, **kw)
        ys = [y for y in _outputs(out) if _is_float(y)]
        if not ys:
            return out                      # no cotangent reaches an int
        for y in ys:
            if not y.requires_grad:
                y.requires_grad_(True)
        self.regions.append(_record(func, args, kwargs, a, kw, len(ys)))
        self.ys.extend(ys)
        return out


def _record(func, args, kwargs, a, kw, n_out) -> _Region:
    """What W needs of a region op ``func(*args, **kwargs)`` (run as
    ``func(*a, **kw)``, its parameter-side inputs detached): its rule's
    arguments (the operands it reads, detached) and parameter-side inputs,
    or for a call without a rule all its operands, to re-run it."""
    entry = _RULES.get(func)
    if entry is not None:
        names, ok, rule, keeps = entry
        bound = dict(zip(names, args), **kwargs)
        pn = {n for n, v in bound.items()
              if type(v) is _ParamSide and v.requires_grad}
        if ok(bound, pn):
            kept = {n for p in pn for n in keeps.get(p, ())}
            args_w = dict(zip(names, a), **kw)
            for n, v in args_w.items():
                if isinstance(v, torch.Tensor):
                    args_w[n] = v.detach() if n in kept else None
            return _Region(func, rule, args_w,
                           {n: _source(bound[n]) for n in pn}, n_out)
    leaves, spec = pytree.tree_flatten((args, kwargs))
    run = pytree.tree_leaves((a, kw))
    taps = [t.detach() if isinstance(t, torch.Tensor) else t for t in run]
    return _Region(func, None, (taps, spec),
                   {j: _source(t) for j, t in enumerate(leaves)
                    if isinstance(t, _ParamSide) and t.requires_grad}, n_out)


class _Swap:
    """Swaps ``module``'s parameters for ``_ParamSide`` views during a tapped
    forward. The parameter slots are listed once; a parameter's view is kept
    from one forward to the next, and made anew when the parameter object,
    its storage, shape, dtype or grad flag changed."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self.slots: Optional[list] = None
        self.views: dict = {}

    def _view(self, p, views: dict) -> "_ParamSide":
        got = self.views.get(id(p))
        if got is None or got[0] is not p or not (
                got[1].data_ptr() == p.data_ptr() and got[1].shape == p.shape
                and got[1].dtype == p.dtype
                and got[1].requires_grad == p.requires_grad):
            got = (p, p.as_subclass(_ParamSide))
            got[1]._leaf = p
        views[id(p)] = got
        return got[1]

    @contextlib.contextmanager
    def __call__(self, rec: _Recorder):
        if self.slots is None:
            self.slots = [(mod, name) for mod in self.module.modules()
                          for name in mod._parameters]
        swapped, views = [], {}
        with torch._C.DisableTorchFunctionSubclass():
            for mod, name in self.slots:
                p = mod._parameters.get(name)
                if p is None or p.device.type == "meta":
                    continue
                v = self._view(p, views)
                v._tap = rec._ref
                swapped.append((mod, name, p))
                mod._parameters[name] = v
        self.views = views
        try:
            yield
        finally:
            rec.active = False
            for mod, name, p in swapped:
                mod._parameters[name] = p


def _reaches_param(outs, stop, params: set) -> bool:
    """Whether the autograd graph of ``outs`` reaches a parameter's
    accumulator, not walking past the nodes in ``stop``."""
    seen = set()
    stack = [o.grad_fn for o in outs if o.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node is None or node in seen or node in stop:
            continue
        seen.add(node)
        if id(getattr(node, "variable", None)) in params:
            return True
        stack.extend(n for n, _ in node.next_functions)
    return False


def _signature(s: int, h, ctx) -> tuple:
    leaves = h if isinstance(h, (tuple, list)) else (h,)
    return (s, tuple((tuple(t.shape), t.dtype, t.requires_grad)
                     if isinstance(t, torch.Tensor) else type(t)
                     for t in leaves),
            ctx.train, ctx.microbatch, ctx.stage, ctx.seed is None, ctx.rows,
            ctx.data_axis is None)


def split_backward_stage(stage_fn: Callable, module: torch.nn.Module):
    """Derive a ``SplitBackwardStage`` for ``stage_fn(s, h, ctx) -> h_out``,
    whose weights are ``module``'s parameters (module notes above).
    ``ScheduledPipeline(split_stage="auto")`` calls this on its own
    ``stage_fn`` and ``module``.

    ``tapped_fn(s, h, ctx) -> (h_out, ys, taps)`` runs the body once; B is
    ``torch.autograd.grad`` of the output at ``h`` and ``ys``, and
    ``wgrad_fn(s, taps, g_ys)`` returns ``[(tensor, gradient)]`` for
    ``torch.autograd.backward``. The classification is cached per signature
    (stage, the shapes, dtypes and grad flags of ``h``, and the ctx's
    train flag, micro-batch, stage, rows and whether it has a seed and a
    data group): the first run of a signature records every call that took
    a parameter-side tensor, with its kind, and proves that no parameter
    reaches the output by a path the interception did not see; a later run
    whose calls match the plan (``tapped_fn.plans``) skips the proof, and
    one whose calls differ proves again and replaces it.

    Raises :class:`SplitUnsupported` where the split cannot be exact: a
    stage output that is parameter-side, an in-place region op, a parameter
    reaching the output unseen (inside a custom ``autograd.Function``, or
    nested deeper than a list in a call's arguments).
    """
    plans: Dict[tuple, list] = {}
    swap = _Swap(module)

    def tapped_fn(s, h, ctx):
        key = _signature(s, h, ctx)
        rec = _Recorder()
        with torch.enable_grad(), swap(rec):
            out = stage_fn(s, h, ctx)
        outs = _outputs(out)
        if any(isinstance(t, _ParamSide) for t in outs):
            raise SplitUnsupported(
                "stage fn returns a params-only value; its cotangent would "
                "be dropped by the params-constant B pass")
        if plans.get(key) != rec.calls:
            stop = {t.grad_fn for t in _outputs(h) if t.grad_fn is not None}
            params = {id(p) for p in module.parameters()}
            if _reaches_param([t for t in outs if t.requires_grad], stop,
                              params):
                raise SplitUnsupported(
                    "a parameter reaches the stage output by a path the "
                    "split cannot see (a call nesting it deeper than a list, "
                    "or a custom autograd.Function given a weight): B would "
                    "drop its gradient")
            plans[key] = rec.calls
        return out, rec.ys, rec.regions

    def wgrad_fn(s, taps, g_ys):
        pairs, k = [], 0
        for region in taps:
            pairs += region.wgrad(g_ys[k:k + region.n_out])
            k += region.n_out
        return pairs

    tapped_fn.plans = plans
    from ..parallel.scheduled import SplitBackwardStage
    return SplitBackwardStage(tapped_fn=tapped_fn, wgrad_fn=wgrad_fn)
