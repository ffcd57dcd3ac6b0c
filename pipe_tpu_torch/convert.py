"""Carry ``pipe_tpu`` weights into this package's modules.

``pipe_tpu``'s ``Pipe.init`` returns one param list per stage, one entry per
layer (a dict of arrays, a nested dict for a block, ``{}`` for a
parameterless layer). :func:`load_stage_params` copies such a list, as numpy
arrays (or anything ``np.asarray`` takes), into a :class:`~pipe_tpu_torch.Pipe`
layer by layer. The layouts that differ:

* ``Linear``: ``pipe_tpu`` stores ``w [in, out]``; here ``weight [out, in]``,
  so it is transposed;
* ``MultiHeadAttention``: ``wq/wk/wv/wo [d, d]`` plus ``bq/bk/bv/bo``; each
  becomes a ``Linear`` (transposed). Heads are contiguous slices of the
  output dim in both packages, so no head permutation is needed;
* ``LayerNorm``: ``g/b`` become ``weight/bias``; ``Embedding``: ``table``
  becomes ``weight``;
* GPT-2: ``GPT2Embed``'s ``wte``/``wpe`` keep their names, ``GPT2Head``'s
  ``ln_f``/``proj`` map as a ``LayerNorm`` and a bias-free ``Linear``; the
  ``@skippable`` stash/pop layers take ``{}``;
* BERT: ``BertEmbed``'s ``word``/``pos`` keep their names and its ``ln`` is
  a ``LayerNorm``; ``MLMHead``'s ``dense``/``ln``/``proj`` map as a
  ``Linear``, a ``LayerNorm`` and a ``Linear``;
* ViT: ``PatchEmbed``'s ``proj`` is a ``Linear`` and ``cls``/``pos`` keep
  their names; ``ViTHead``'s ``ln``/``proj`` map as a ``LayerNorm`` and a
  ``Linear``;
* ``BatchNorm``: ``scale``/``bias`` go to the parameters, the running
  ``mean``/``var`` to the buffers of the same names.

:func:`load_pipelined_lm_params` copies the JAX ``Trainer``'s params, the
``PipelinedLM`` triple ``(stage_params, pre_params, post_params)``, into a
``Pipe`` over the tutorial LM cut by ``pipelined_lm_balance``;
:func:`load_pipelined_lm` copies the same triple (of a ``PipelinedLM``,
``PipelinedGPT2``, ``PipelinedBERT`` or ``PipelinedViT``) into the port's
model of the same family.
:func:`pipelined_lm_arrays` maps such a triple (params, or the gradients
``pipe_tpu``'s ``ScheduledPipeline.loss_and_grad`` returns) onto a port
model's parameter names, as numpy, without copying anything in.

The mesh layouts: the triple's ``stage_params`` may be stage-stacked
(``stack_stage_params``) or stacked device-major for an interleaved
placement (``stack_interleaved_params``; pass ``interleaved_devices``);
:func:`load_packed_rows` carries ``pipe_tpu``'s ``StageParamPack`` rows
(``Pipe(mesh=...).shard_params``) into a ``Pipe``'s partitions;
:func:`load_ring_stage` gives one rank of a stage ring its stage of the
stage-stacked triple the ring decoders take (``QuantLeaf`` int8 leaves
included). A rank of a
mesh holds only its own partitions: the others' parameters sit on the
``meta`` device and every loader here passes them by. Back the other way,
:func:`stage_trees` and :func:`pipelined_lm_tree` put arrays named as the
port names them (a rank's gradients, gathered) into ``pipe_tpu``'s layouts.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .extras.norm import BatchNorm
from .inference.quant import QuantLinear
from .extras.skip import Skippable
from .models.bert import BertEmbed, MLMHead
from .models.gpt2 import GPT2Embed, GPT2Head
from .models.vit import PatchEmbed, ViTHead
from .ops.layers import (Decoder, Dropout, Embedding, LayerNorm, Lambda,
                         Linear, MultiHeadAttention, PositionalEncoding,
                         Sequential, _TransformerBlockBase)

__all__ = ["load_params", "load_stage_params", "load_pipelined_lm_params",
           "load_pipelined_lm", "load_ring_stage", "pipelined_lm_arrays", "stage_arrays",
           "load_packed_rows", "stage_trees", "pipelined_lm_tree"]


def _array(dst: torch.Tensor, src: Any, transpose: bool = False
           ) -> Tuple[torch.Tensor, np.ndarray]:
    arr = np.asarray(src)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: pipe_tpu array {arr.shape} -> "
                         f"parameter {tuple(dst.shape)}")
    return dst, arr


def _is_quant(w: Any) -> bool:
    """``pipe_tpu``'s ``QuantLeaf`` (int8 codes ``q`` and float32 scales
    ``scale``), told by its fields: this package imports no JAX."""
    return hasattr(w, "q") and hasattr(w, "scale")


def _linear(lin, w, b) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """A ``Linear``'s weight (transposed) and bias; a ``QuantLinear``'s
    codes and scales from a ``QuantLeaf`` (``q [in, out]`` and ``scale
    [1, out]``, both transposed)."""
    if isinstance(lin, QuantLinear):
        if not _is_quant(w):
            raise TypeError("a QuantLinear takes pipe_tpu's QuantLeaf "
                            "(quantize_params' int8 codes and scales)")
        yield _array(lin.q, w.q, transpose=True)
        yield _array(lin.scale, w.scale, transpose=True)
    else:
        if _is_quant(w):
            raise TypeError("int8 QuantLeaf params need a quantized model "
                            "(inference.quantize_params)")
        yield _array(lin.weight, w, transpose=True)
    if lin.bias is not None:
        yield _array(lin.bias, b)


def _pairs(layer: nn.Module, params: Any
           ) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """``(parameter, array in its layout)`` for one layer's ``pipe_tpu``
    params."""
    if isinstance(layer, Sequential):
        if len(params) != len(layer):
            raise ValueError(f"Sequential of {len(layer)} layers got "
                             f"{len(params)} param entries")
        for sub, p in zip(layer, params):
            yield from _pairs(sub, p)
    elif isinstance(layer, (Linear, QuantLinear)):
        yield from _linear(layer, params["w"], params.get("b"))
    elif isinstance(layer, Decoder):
        yield from _linear(layer.proj, params["w"], params.get("b"))
    elif isinstance(layer, Embedding):
        yield _array(layer.weight, params["table"])
    elif isinstance(layer, LayerNorm):
        yield _array(layer.weight, params["g"])
        yield _array(layer.bias, params["b"])
    elif isinstance(layer, MultiHeadAttention):
        for name in ("q", "k", "v", "o"):
            yield from _linear(getattr(layer, "w" + name), params["w" + name],
                               params["b" + name])
    elif isinstance(layer, _TransformerBlockBase):
        for name in ("attn", "ff1", "ff2", "ln1", "ln2"):
            yield from _pairs(getattr(layer, name), params[name])
    elif isinstance(layer, GPT2Embed):
        yield _array(layer.wte, params["wte"])
        yield _array(layer.wpe, params["wpe"])
    elif isinstance(layer, GPT2Head):
        yield from _pairs(layer.ln_f, params["ln_f"])
        yield from _linear(layer.proj, params["proj"]["w"], None)
    elif isinstance(layer, BertEmbed):
        yield _array(layer.word, params["word"])
        yield _array(layer.pos, params["pos"])
        yield from _pairs(layer.ln, params["ln"])
    elif isinstance(layer, PatchEmbed):
        yield from _pairs(layer.proj, params["proj"])
        yield _array(layer.cls, params["cls"])
        yield _array(layer.pos, params["pos"])
    elif isinstance(layer, (MLMHead, ViTHead)):
        for name in (("dense", "ln", "proj") if isinstance(layer, MLMHead)
                     else ("ln", "proj")):
            yield from _pairs(getattr(layer, name), params[name])
    elif isinstance(layer, BatchNorm):
        for name in ("scale", "bias", "mean", "var"):
            yield _array(getattr(layer, name), params[name])
    elif isinstance(layer, (PositionalEncoding, Dropout, Lambda, Skippable)):
        if params:
            raise ValueError(f"{type(layer).__name__} has no parameters, got "
                             f"{sorted(params)}")
    else:
        raise TypeError(f"no pipe_tpu layout known for {type(layer).__name__}")


def _copy_in(pairs) -> None:
    with torch.no_grad():
        for dst, arr in list(pairs):
            if dst.device.type != "meta":           # another rank's
                dst.copy_(torch.from_numpy(np.array(arr)))  # a writable copy


def load_params(layer: nn.Module, params: Any) -> None:
    """Copy one layer's ``pipe_tpu`` params into ``layer`` in place (running
    statistics into its buffers)."""
    _copy_in(_pairs(layer, params))


def load_stage_params(pipe, params_per_stage: Sequence[Any]) -> None:
    """Copy ``pipe_tpu``'s per-stage params (``Pipe.init``'s result) into
    ``pipe``, whose partitions must have the same balance."""
    if len(params_per_stage) != len(pipe.partitions):
        raise ValueError(f"{len(params_per_stage)} stages of params for a "
                         f"Pipe of {len(pipe.partitions)} stages")
    for part, params in zip(pipe.partitions, params_per_stage):
        load_params(part, params)


def stage_arrays(pipe, trees: Sequence[Any]) -> Dict[str, np.ndarray]:
    """``{name: array}`` over ``pipe``'s parameter and buffer names, from
    per-stage trees of ``pipe_tpu``'s ``Pipe`` (its params, or gradients of
    them), each array in the port's layout. Names follow
    ``named_parameters()`` and ``named_buffers()`` of ``pipe``."""
    if len(trees) != len(pipe.partitions):
        raise ValueError(f"{len(trees)} stages of trees for a Pipe of "
                         f"{len(pipe.partitions)} stages")
    names = {id(t): name for name, t in (*pipe.named_parameters(),
                                         *pipe.named_buffers())}
    return {names[id(dst)]: arr
            for part, tree in zip(pipe.partitions, trees)
            for dst, arr in _pairs(part, tree)}


def load_pipelined_lm_params(pipe, params: Sequence[Any],
                             interleaved_devices: int = None) -> None:
    """Copy ``pipe_tpu``'s ``PipelinedLM`` params into ``pipe``, a ``Pipe``
    over ``build_sequential`` with the ``pipelined_lm_balance`` cut.

    ``params`` is ``(stage_params, pre_params, post_params)`` as numpy arrays
    (or anything ``np.asarray`` takes): ``pre_params["embed"]`` goes to the
    embedding, ``post_params["decoder"]`` to the decoder, and block ``l`` of
    stage ``s`` to that stage's ``l``-th transformer block. ``stage_params``
    is stage-stacked (a list of blocks whose leaves lead with the stage axis,
    as ``stack_stage_params`` leaves them), stacked device-major over
    ``interleaved_devices`` devices (``stack_interleaved_params``), or a
    per-stage list of block lists.
    """
    stage_params, pre, post = _unstacked(params, interleaved_devices)
    blocks = _flat_blocks(stage_params)
    layers = list(pipe)
    if len(layers) != len(blocks) + 3:
        raise ValueError(
            f"a Pipe of {len(layers)} layers over {len(pipe.partitions)} "
            f"stages does not hold {len(blocks)} blocks plus embedding, "
            f"positions and decoder")
    load_params(layers[0], pre["embed"])
    for layer, block in zip(layers[2:-1], blocks):
        load_params(layer, block)
    load_params(layers[-1], post["decoder"])


def _unstacked(params: Sequence[Any], interleaved_devices) -> tuple:
    """The triple with an interleaved stacking put back in virtual-stage
    order (a per-stage list)."""
    stage_params, pre, post = params
    if interleaved_devices:
        from .parallel.interleaved import unstack_interleaved_params
        stage_params = unstack_interleaved_params(stage_params,
                                                  interleaved_devices)
    return stage_params, pre, post


def _pipelined_lm_pairs(model, params: Sequence[Any]
                        ) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    stage_params, pre, post = params
    blocks = _flat_blocks(stage_params)
    if len(blocks) != len(model.blocks):
        raise ValueError(f"{len(blocks)} blocks of params for a model of "
                         f"{len(model.blocks)} blocks")
    yield from _pairs(model.embed, pre["embed"])
    for layer, block in zip(model.blocks, blocks):
        yield from _pairs(layer, block)
    yield from _pairs(model.head, post[model.post_key])


def load_pipelined_lm(model, params: Sequence[Any],
                      interleaved_devices: int = None) -> None:
    """Copy ``pipe_tpu``'s ``PipelinedLM`` (or ``PipelinedGPT2``,
    ``PipelinedBERT``, ``PipelinedViT``) params, the triple of
    :func:`load_pipelined_lm_params` in any of its stage layouts, into
    ``model``, the port's model of that family (any stage count: the blocks
    go in layer order)."""
    _copy_in(_pipelined_lm_pairs(model, _unstacked(params,
                                                    interleaved_devices)))


def load_ring_stage(model, params: Sequence[Any], stage: int,
                    n_stages: int, device=None) -> None:
    """One rank's share of ``pipe_tpu``'s ring layout: ``params`` is the
    ``PipelinedLM`` triple with ``stage_params`` stage-stacked
    (``stack_stage_params``: leaves lead with the stage axis, as
    ``PipelinedGenerator`` and ``RingSlotBackend`` take them sharded over
    ``stage``), or per-stage lists, float or ``quantize_params``' int8
    ``QuantLeaf`` form (then ``model`` is the port's ``quantize_params``
    copy). Stage ``stage`` of ``n_stages`` keeps its own blocks, the
    embedding on stage 0 and the head on stage n-1
    (:func:`~.inference.pipelined.stage_modules`) on ``device`` (default:
    the model's); the rest of ``model`` goes to the ``meta`` device."""
    from .inference.pipelined import stage_modules
    from .parallel.mesh import localize

    stage_params, pre, post = params
    keep = stage_modules(model, stage, n_stages)
    if device is None:
        device = next(p.device for p in model.parameters()
                      if p.device.type != "meta")
    localize(model, keep, device)
    _copy_in(_pipelined_lm_pairs(model, (stage_params, pre, post)))


def pipelined_lm_arrays(model, params: Sequence[Any]) -> Dict[str, np.ndarray]:
    """``{name: array}`` over the parameter names of ``model`` (a port
    ``PipelinedTransformer``: the LM, GPT-2, BERT or ViT), from a
    ``pipe_tpu`` triple of the same family in either stage layout:
    its params, or the ``(g_stage, g_pre, g_post)`` gradients of
    ``ScheduledPipeline.loss_and_grad``. Each array is in the port's layout
    (``Linear`` weights transposed), so it compares name by name with the
    port's parameters or with ``ScheduledPipeline.loss_and_grad``'s grads.
    An interleaved stacking must be unstacked to per-stage lists first."""
    names = {id(p): name for name, p in model.named_parameters()}
    return {names[id(dst)]: arr
            for dst, arr in _pipelined_lm_pairs(model, params)}


def load_packed_rows(pipe, rows: Dict[str, Any], templates: Sequence[Any],
                     v: int = 1) -> None:
    """Copy ``pipe_tpu``'s packed stage rows (``{dtype: [S, cap]}``, as
    ``Pipe(mesh=...).shard_params`` returns them, here as numpy) into
    ``pipe``'s partitions. ``templates``: the per-partition param trees the
    rows were packed from (``Pipe.init``'s, any values: they give the
    layout); ``v``: the interleave depth, whose rows are device-major (row
    ``p * v + g`` holds partition ``g * d + p``)."""
    from .core.packing import StageParamPack

    S = len(templates)
    d = S // v
    of_row = [(r % v) * d + r // v for r in range(S)]
    trees = StageParamPack([templates[s] for s in of_row]).unshard(rows)
    for r, tree in enumerate(trees):
        load_params(pipe.partitions[of_row[r]], tree)


def _filled(pairs, named: Dict[str, Any], names) -> None:
    """Write each port-named array into the template leaf ``_pairs`` reads
    it from (a transposed view writes through)."""
    for dst, arr in list(pairs):
        arr[...] = np.asarray(named[names[id(dst)]])


def _writable(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _writable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_writable(v) for v in tree)
    return np.array(tree)


def stage_trees(pipe, named: Dict[str, Any], templates: Sequence[Any]
                ) -> list:
    """Per-partition trees in ``pipe_tpu``'s layout (``Pipe.init``'s, the
    shapes of ``templates``) holding the arrays ``named`` by ``pipe``'s
    parameter names (gradients gathered from the ranks, say)."""
    names = {id(t): n for n, t in (*pipe.named_parameters(),
                                   *pipe.named_buffers())}
    out = _writable(list(templates))
    for part, tree in zip(pipe.partitions, out):
        _filled(_pairs(part, tree), named, names)
    return out


def pipelined_lm_tree(model, named: Dict[str, Any], template: Sequence[Any]
                      ) -> tuple:
    """The ``(stage_params, pre, post)`` triple in ``pipe_tpu``'s layout of
    ``template`` (a per-stage list of block lists, or stage-stacked) holding
    the arrays ``named`` by ``model``'s parameter names."""
    names = {id(p): n for n, p in model.named_parameters()}
    triple = _writable(tuple(template))
    # a stage-stacked template is read through views of its stage rows,
    # which write through
    _filled(_pipelined_lm_pairs(model, triple), named, names)
    return triple


def _flat_blocks(stage_params: Sequence[Any]) -> list:
    """Every block's params in layer order, from a per-stage list of block
    lists or from stage-stacked blocks (leaves lead with the stage axis)."""
    if isinstance(stage_params[0], (list, tuple)):
        return [block for stage in stage_params for block in stage]
    n = len(_first_leaf(stage_params[0]))
    return [_take(block, j) for j in range(n) for block in stage_params]


def _first_leaf(tree: Any):
    while isinstance(tree, dict) or _is_quant(tree):
        tree = tree.q if _is_quant(tree) else next(iter(tree.values()))
    return np.asarray(tree)


class _Quant:
    """One stage's slice of a stacked ``QuantLeaf``."""

    def __init__(self, q, scale):
        self.q, self.scale = q, scale


def _take(tree: Any, j: int) -> Any:
    """Index ``j`` of the leading (stage) axis of every leaf of ``tree``
    (a ``QuantLeaf``'s codes and scales both)."""
    if isinstance(tree, dict):
        return {k: _take(v, j) for k, v in tree.items()}
    if _is_quant(tree):
        return _Quant(np.asarray(tree.q)[j], np.asarray(tree.scale)[j])
    return np.asarray(tree)[j]
