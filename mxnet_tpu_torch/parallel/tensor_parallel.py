"""Parameters sharded over the ``tp`` and ``pp`` axes, and the Megatron
collectives of tensor parallelism.

The JAX package gives a parameter a ``NamedSharding`` from its rule and
lets GSPMD insert the collectives.  The port runs one process per card,
so a rule becomes a placement of the parameter's local shard
(:class:`ParamShard`): at construction the step keeps, of each matched
parameter and of its optimizer slots, the block its process holds, and
the layers run Megatron's pattern with explicit collectives over the
``tp`` slice of the mesh, each a ``torch.autograd.Function`` (forward /
backward):

  :func:`copy_to_tp`      identity / all-reduce   (into a column-parallel
                          product: ``qkv``, ``ffn1``, the decoder)
  :func:`reduce_from_tp`  all-reduce / identity   (out of a row-parallel
                          product: ``proj``, ``ffn2``; and the
                          vocab-parallel embedding)
  :func:`gather_from_tp`  all-gather of the last dimension / this rank's
                          columns (the decoder's logits, so the loss sees
                          the whole vocabulary, as the JAX loss does)

A slice of one process runs the same code with no collective (each is the
identity there).  A layer holds a tensor-parallel form only where it
declares one: a module class's ``_SHARD_FORMS`` maps a parameter's path
in the module to the specs it can run and the number of fused blocks along
its sharded dimension (3 for the fused ``qkv`` projection, whose local
shard holds this rank's heads of q, k and v: rows ``[q_r; k_r; v_r]``).
:func:`shard_parameters` raises for a rule that puts an axis of more than
one process on a parameter without such a form.

A dimension that does not divide by its parts is cut as GSPMD pads it:
blocks of ``ceil(n / parts)``, the last ones shorter (30,522 vocabulary
rows over 4: three of 7,631 and one of 7,629).  :meth:`ParamShard.gather`
puts the whole array back together in the JAX layout on every process of
the slice (one all-gather of padded blocks).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..base import MXNetError

__all__ = ["ParamShard", "shard_parameters", "shard_of", "copy_to_tp",
           "reduce_from_tp", "gather_from_tp", "column_parallel",
           "row_parallel", "vocab_parallel_embedding", "tp_size",
           "A94"]

A94 = "ROADMAP A.9 part 4"
_MODEL_AXES = ("tp", "pp")


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _cut(n: int, parts: int, idx: int) -> Tuple[int, int]:
    """[start, stop) of block ``idx`` of ``parts`` of a length ``n``,
    blocks of ceil(n / parts) as GSPMD pads them."""
    chunk = -(-n // parts)
    start = min(n, idx * chunk)
    return start, min(n, start + chunk)


class ParamShard:
    """Where a process's local tensor sits in the global parameter.

    ``spec`` is the rule's spec padded to the parameter's rank (the JAX
    ``PartitionSpec``), ``shape`` the global shape, ``fused`` the number of
    fused blocks along the sharded dimension (each cut alike)."""

    def __init__(self, mesh, spec: Sequence, shape: Sequence[int],
                 fused: int = 1):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(int(n) for n in shape)
        self.fused = int(fused)
        self.axes = tuple(a for entry in self.spec for a in _axes_of(entry)
                          if mesh.axis_size(a) > 1)
        sharded = [d for d, e in enumerate(self.spec) if _axes_of(e)]
        if self.fused > 1:
            if len(sharded) != 1:
                raise MXNetError(f"a fused parameter is cut along one "
                                 f"dimension, spec {self.spec}")
            d = sharded[0]
            parts = self._parts(self.spec[d])
            if self.shape[d] % (self.fused * parts):
                raise MXNetError(
                    f"{self.fused} fused blocks of {self.shape[d]} rows do "
                    f"not divide by {self.spec[d]}={parts}")

    def _parts(self, entry, coords=None):
        n, idx = 1, 0
        for a in _axes_of(entry):
            n *= self.mesh.axis_size(a)
            if coords is not None:
                idx = idx * self.mesh.axis_size(a) + coords.get(a, 0)
        return n if coords is None else (n, idx)

    def blocks(self, rank: Optional[int] = None):
        """[(global slices, local slices)] of ``rank``'s (default: this
        process's) shard."""
        coords = self.mesh.coords(rank)
        glob, loc = [[]], [[]]
        for d, n in enumerate(self.shape):
            entry = self.spec[d] if d < len(self.spec) else None
            parts, idx = self._parts(entry, coords)
            if self.fused > 1 and _axes_of(entry):
                third = n // self.fused
                start, stop = _cut(third, parts, idx)
                width = stop - start
                glob = [g + [slice(f * third + start, f * third + stop)]
                        for g in glob for f in range(self.fused)]
                loc = [l + [slice(f * width, (f + 1) * width)]
                       for l in loc for f in range(self.fused)]
            else:
                start, stop = _cut(n, parts, idx)
                glob = [g + [slice(start, stop)] for g in glob]
                loc = [l + [slice(0, stop - start)] for l in loc]
        return [(tuple(g), tuple(l)) for g, l in zip(glob, loc)]

    def local_shape(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        out = [0] * len(self.shape)
        for _, loc in self.blocks(rank):
            for d, s in enumerate(loc):
                out[d] = max(out[d], s.stop)
        return tuple(out)

    def row_range(self, dim: int = 0) -> Tuple[int, int]:
        """[start, stop) of this process's block along ``dim`` (an unfused
        dimension)."""
        g, _ = self.blocks()[0]
        return g[dim].start, g[dim].stop

    def local(self, whole: torch.Tensor) -> torch.Tensor:
        """This process's shard of the global ``whole``, a new tensor."""
        out = whole.new_empty(self.local_shape())
        for g, l in self.blocks():
            out[l] = whole[g]
        return out

    def _max_shape(self) -> Tuple[int, ...]:
        ranks = self.mesh.slice_ranks(self.axes) if self.axes else [None]
        shapes = [self.local_shape(r) for r in ranks]
        return tuple(max(s[d] for s in shapes)
                     for d in range(len(self.shape)))

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global array from every process's ``local`` shard (a
        collective over the slice of this parameter's axes)."""
        local = local.detach()
        if not self.axes:
            return local.clone()
        import torch.distributed as tdist

        group = self.mesh.group(self.axes)
        ranks = sorted(self.mesh.slice_ranks(self.axes))
        big = self._max_shape()
        pad = local.new_zeros(big)
        pad[tuple(slice(0, n) for n in local.shape)] = local
        pieces = [torch.empty_like(pad) for _ in ranks]
        tdist.all_gather(pieces, pad.contiguous(), group=group)
        whole = local.new_empty(self.shape)
        for r, piece in zip(ranks, pieces):
            for g, l in self.blocks(r):
                whole[g] = piece[l]
        return whole

    def __repr__(self):
        return (f"ParamShard(spec={self.spec}, shape={self.shape}, "
                f"fused={self.fused})")


def shard_of(t) -> Optional[ParamShard]:
    """The placement a step gave tensor ``t``, or None (whole)."""
    return getattr(t, "_mx_shard", None)


def _forms(block) -> Dict[int, Tuple[str, object]]:
    """id(tensor) -> (path in its module, form) over every module of
    ``block`` that declares ``_SHARD_FORMS``."""
    out = {}
    for m in block.modules():
        forms = getattr(type(m), "_SHARD_FORMS", None)
        if not forms:
            continue
        if callable(forms):
            forms = forms(m)
        for path, form in forms.items():
            obj = m
            for part in path.split("."):
                obj = getattr(obj, part, None)
            if isinstance(obj, torch.Tensor):
                out[id(obj)] = (path, form)
    return out


def _allowed(form, spec) -> Optional[int]:
    """The fused count when ``spec`` is one of ``form``'s specs, else
    None.  A form is ``(specs, fused)``; a spec matches when it names the
    same axes at the same dimensions (padding with None ignored)."""
    specs, fused = form
    want = tuple(tuple(_axes_of(e)) for e in spec)
    for s in specs:
        s = tuple(s) + (None,) * (len(spec) - len(s))
        if tuple(tuple(_axes_of(e)) for e in s) == want:
            return fused
    return None


def shard_parameters(block, mesh, rules, entries) -> Dict[int, ParamShard]:
    """Placements of the parameters ``rules`` shard over the model axes
    of ``mesh``: ``entries`` are (rule name, tensor) pairs; returns
    id(tensor) -> :class:`ParamShard`.  A parameter no rule matches stays
    whole.  An axis of one process shards nothing, unless the layer has a
    form for it (its shard is then the whole tensor, and its layers run
    their tensor-parallel code).  Raises :class:`MXNetError` naming the
    parameter, the rule and ROADMAP A.9 part 4 for what the port cannot
    run."""
    forms = _forms(block)
    out = {}
    for name, t in entries:
        spec = tuple(rules.spec_for(name, t.dim()))
        named = [a for e in spec for a in _axes_of(e)]
        if not named:
            continue
        pattern = rules.pattern_for(name)
        missing = [a for a in named if a not in mesh.axis_names]
        if missing:
            raise MXNetError(f"{name}: rule {pattern!r} -> {spec} names "
                             f"axes {missing} the mesh {dict(mesh.shape)} "
                             "has not")
        live = [a for a in named if mesh.axis_size(a) > 1]
        bad = [a for a in live if a not in _MODEL_AXES]
        if bad:
            raise MXNetError(
                f"{name}: rule {pattern!r} -> {spec} shards a parameter over "
                f"the data axes {bad}; the port shards parameters over tp "
                f"and pp only ({A94})")
        form = forms.get(id(t))
        fused = None if form is None else _allowed(form[1], spec)
        if fused is None:
            if live:
                raise MXNetError(
                    f"{name}: rule {pattern!r} -> {spec} has no "
                    f"tensor-parallel form in the port's "
                    f"{type(t).__name__ if form is None else form[0]} "
                    f"layer ({A94})")
            continue
        out[id(t)] = ParamShard(mesh, spec, tuple(t.shape), fused)
    return out


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
def tp_size() -> int:
    """The tp extent of the active tensor-parallel scope (raises
    without one)."""
    return _tp_group()[1]


def _tp_group():
    from .scope import tp_scope

    mesh = tp_scope()
    if mesh is None:
        raise MXNetError(
            "a tensor-parallel layer ran outside a step's tensor-parallel "
            "scope: its parameters are shards, so call it through the "
            "step (DataParallelStep)")
    if mesh.axis_size("tp") == 1:
        return None, 1, mesh
    return mesh.group("tp"), mesh.axis_size("tp"), mesh


def _all_reduce(x, tp=None):
    """``x`` summed over the ``tp`` slice; ``tp`` is ``_tp_group()`` as a
    forward captured it (a backward may run on autograd's device thread,
    which does not see the step's thread-local scope)."""
    import torch.distributed as tdist

    group, n, _ = _tp_group() if tp is None else tp
    if n == 1:
        return x
    x = x.contiguous().clone()
    tdist.all_reduce(x, group=group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.tp = _tp_group()
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromTP(torch.autograd.Function):
    """All-gather of the last dimension: every process's block of a
    global width ``total`` (cut as :func:`_cut`), in mesh order."""

    @staticmethod
    def forward(ctx, x, total):
        import torch.distributed as tdist

        group, n, mesh = _tp_group()
        idx = mesh.axis_index("tp")
        ctx.cut = _cut(total, n, idx)
        if n == 1:
            return x
        ranks = mesh.slice_ranks("tp")
        chunk = -(-total // n)
        pad = x.new_zeros(x.shape[:-1] + (chunk,))
        pad[..., :x.shape[-1]] = x
        pieces = [torch.empty_like(pad) for _ in ranks]
        tdist.all_gather(pieces, pad, group=group)
        order = sorted(ranks)
        parts = []
        for i, r in enumerate(ranks):
            start, stop = _cut(total, n, i)
            parts.append(pieces[order.index(r)][..., :stop - start])
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.cut
        if g.shape[-1] == stop - start:
            return g, None
        return g[..., start:stop].contiguous(), None


def copy_to_tp(x):
    return _CopyToTP.apply(x)


def reduce_from_tp(x):
    return _ReduceFromTP.apply(x)


def gather_from_tp(x, total: int):
    return _GatherFromTP.apply(x, int(total))


# ---------------------------------------------------------------------------
# the layers' tensor-parallel forms
# ---------------------------------------------------------------------------
def column_parallel(dense, x, gather: bool = False):
    """``dense`` (a Gluon ``Dense(flatten=False)``) with its weight and
    bias cut along the output dimension: its local columns, or with
    ``gather`` all of them."""
    out = dense(copy_to_tp(x))
    if gather:
        out = gather_from_tp(out, shard_of(dense.weight).shape[0])
    return out


def row_parallel(dense, x):
    """``dense`` with its weight cut along the input dimension: the
    partial product all-reduced over ``tp``, then the (whole) bias, added
    once."""
    from ..gluon.nn.basic_layers import _linear_site
    from ..precision import runtime as _prec

    x, w = _prec.cast_inputs("FullyConnected", x, dense.weight)
    out = reduce_from_tp(_linear_site(x, w, None))
    if dense.bias is not None:
        out = out + dense.bias.to(out.dtype)
    return out if dense.act is None else _activation(out, dense.act)


def _activation(x, act):
    from ..ops import nn as _nn

    return _nn.activation(x, act)


def vocab_parallel_embedding(embed, ids):
    """``embed`` with its rows cut over ``tp``: ids outside this rank's
    rows give zeros, then the sum over ``tp``."""
    from ..ops import indexing as _indexing

    start, stop = shard_of(embed.weight).row_range(0)
    local = ids.long() - start
    inside = (local >= 0) & (local < stop - start)
    out = _indexing.embedding(torch.where(inside, local, 0), embed.weight)
    out = out.masked_fill(~inside.unsqueeze(-1), 0)
    return reduce_from_tp(out)
