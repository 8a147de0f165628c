"""Sharding rules as data, and which block of a global array a rank holds.

Counterpart of ``mxnet_tpu/parallel/sharding.py``.  A
:class:`ShardingRules` is the same ordered table of (name pattern,
partition spec) pairs, with ``spec_for``, ``to_json`` / ``from_json`` and
equality; a spec is a tuple of mesh-axis names (or tuples of them, or
None) per dimension, the JAX ``PartitionSpec``'s contents.  The step
applies them over the ``tp`` and ``pp`` axes: each matched parameter
keeps the block its process holds (``tensor_parallel.ParamShard``).

``replicated``, ``shard_batch`` and ``shard_batch_seq`` return a
:class:`Placement`: the spec of the JAX function's ``NamedSharding`` and,
through :meth:`Placement.local`, the block of a global array that a rank
of the mesh holds under it, which is what the step slices out of the
global batch.  ``shard_map_compat`` has no counterpart: the port's
sequence-parallel routes call their collectives directly.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["ShardingRules", "Placement", "replicated", "shard_batch",
           "shard_batch_seq", "tensor_parallel_plan"]


class ShardingRules:
    """Ordered (regex, spec) table applied to parameter names."""

    def __init__(self, rules: Optional[Sequence[Tuple[str, Sequence]]] = None):
        self._rules = [(re.compile(pat), tuple(spec))
                       for pat, spec in (rules or [])]

    def to_json(self):
        """Lossless ``[[pattern, [spec...]], ...]`` form."""
        return [[pat.pattern,
                 [list(a) if isinstance(a, tuple) else a for a in spec]]
                for pat, spec in self._rules]

    @classmethod
    def from_json(cls, rec) -> "ShardingRules":
        return cls([(pat, tuple(tuple(a) if isinstance(a, list) else a
                                for a in spec)) for pat, spec in (rec or [])])

    def __eq__(self, other):
        return (isinstance(other, ShardingRules)
                and self.to_json() == other.to_json())

    def __hash__(self):
        return hash(repr(self.to_json()))

    def __bool__(self):
        return bool(self._rules)

    def spec_for(self, name: str, ndim: int) -> Tuple:
        """The spec of the first rule whose pattern matches ``name``, cut
        or padded with None to ``ndim``; ``()`` (replicated) when none
        matches."""
        for pat, spec in self._rules:
            if pat.match(name):
                spec = tuple(spec)[:ndim]
                return spec + (None,) * (ndim - len(spec))
        return ()

    def pattern_for(self, name: str) -> Optional[str]:
        """The pattern of the first rule that matches ``name``, or None."""
        for pat, _ in self._rules:
            if pat.match(name):
                return pat.pattern
        return None


@dataclass(frozen=True)
class Placement:
    """A spec over a mesh: entry i names the mesh axes dimension i of a
    global array is split over (None: whole)."""
    mesh: object
    spec: Tuple

    def local(self, shape, rank: Optional[int] = None):
        """The slices (one per dimension) of a global array of ``shape``
        that ``rank`` (default: this process) holds."""
        coords = self.mesh.coords(rank)
        sizes = self.mesh.shape
        out = []
        for dim, n in enumerate(shape):
            entry = self.spec[dim] if dim < len(self.spec) else None
            axes = (() if entry is None else
                    (entry,) if isinstance(entry, str) else tuple(entry))
            parts, idx = 1, 0
            for a in axes:  # row-major over the named axes
                idx = idx * sizes[a] + coords[a]
                parts *= sizes[a]
            if n % parts:
                raise MXNetError(
                    f"dimension {dim} of {tuple(shape)} is not divisible by "
                    f"{axes}={parts}")
            step = n // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)


def replicated(mesh) -> Placement:
    return Placement(mesh, ())


def shard_batch(mesh, axes=("dp",), ndim=2) -> Placement:
    """Dimension 0 split over the data axes that ``mesh`` has."""
    axis = tuple(a for a in axes if a in mesh.axis_names)
    spec = (axis if len(axis) > 1 else (axis[0] if axis else None),)
    return Placement(mesh, spec + (None,) * (ndim - 1))


def shard_batch_seq(mesh, ndim=2) -> Placement:
    """Sequence parallelism: dimension 0 over ``dp``, 1 over ``sp``."""
    if ndim < 2:
        raise MXNetError("shard_batch_seq needs ndim >= 2")
    return Placement(mesh, ("dp", "sp") + (None,) * (ndim - 2))


def tensor_parallel_plan(rules, tp, dp=0, n_devices=None, accum_steps=1):
    """Compat shim: :func:`~mxnet_tpu_torch.parallel.plan.
    tensor_parallel_plan`."""
    from .plan import tensor_parallel_plan as _tp

    return _tp(rules, tp, dp=dp, n_devices=n_devices,
               accum_steps=accum_steps)
