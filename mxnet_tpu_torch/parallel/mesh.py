"""Meshes over processes, and host-level collectives.

Counterpart of ``mxnet_tpu/parallel/mesh.py``.  The JAX package's mesh is
a ``jax.sharding.Mesh`` of devices that XLA compiles collectives over.
The port runs one process per card, so a :class:`Mesh` is an array of
process ranks with named, ordered axes (``dp``, ``pp``, ``sp``, ``tp``,
``ep`` from :func:`make_mesh`), ``.shape``, ``.axis_names`` and
``.devices`` as in JAX, and one ``torch.distributed`` process group per
slice of an axis (or of several axes together), made by :meth:`group`:
every process of the world calls ``new_group`` for every slice, in the
same order, the first time any of them asks for those axes, and each
keeps the group it belongs to.  A mesh that covers one process needs no
group; a slice that covers the whole world is the default group.

A mesh can be built over ranks that no group holds (the tests build the
JAX package's shapes with ``devices=range(8)``); it asks for groups only
when a step runs collectives over it.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError
from . import dist

__all__ = ["Mesh", "MeshDevice", "make_mesh", "local_mesh", "device_mesh",
           "host_barrier", "global_allreduce"]

AXIS_ORDER = ("dp", "pp", "sp", "tp", "ep")


@dataclass(frozen=True)
class MeshDevice:
    """One process's card in a mesh: ``id`` is the process rank (one card
    per process), as a JAX device's global id."""
    id: int
    process_index: int
    platform: str


class Mesh:
    """Process ranks arranged on named axes."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(str(a) for a in axis_names)
        if ranks.ndim != len(axis_names):
            raise MXNetError(f"mesh of rank {ranks.ndim} given "
                             f"{len(axis_names)} axis names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise MXNetError(f"duplicate mesh axes {axis_names}")
        if len(set(ranks.flat)) != ranks.size:
            raise MXNetError(f"a rank appears twice in the mesh {ranks}")
        self.ranks = ranks
        self.axis_names = axis_names
        self._groups: Dict[Tuple[str, ...], object] = {}

    # -- the JAX mesh's surface ---------------------------------------------
    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def devices(self) -> np.ndarray:
        import torch

        on_card = (dist.backend() == "nccl" if dist.is_initialized()
                   else torch.cuda.is_available())
        platform = "gpu" if on_card else "cpu"
        out = np.empty(self.ranks.shape, dtype=object)
        for idx, r in np.ndenumerate(self.ranks):
            out[idx] = MeshDevice(int(r), int(r), platform)
        return out

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, ranks="
                f"{self.ranks.reshape(-1).tolist()})")

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.axis_names ==
                other.axis_names and np.array_equal(self.ranks, other.ranks))

    def __hash__(self):
        return hash((self.axis_names, tuple(self.ranks.reshape(-1))))

    # -- this process's place ------------------------------------------------
    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> index of ``rank`` (default: this process)."""
        rank = dist.process_index() if rank is None else int(rank)
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise MXNetError(f"rank {rank} is not in {self!r}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_index(self, axis: str, rank: Optional[int] = None) -> int:
        if axis not in self.axis_names:
            return 0
        return self.coords(rank)[axis]

    def _slices(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every slice of the mesh over ``axes`` (the other axes fixed), as
        lists of ranks in row-major order of ``axes``."""
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        arr = np.transpose(self.ranks, rest + keep)
        arr = arr.reshape(-1, int(np.prod([self.ranks.shape[i]
                                           for i in keep], dtype=np.int64)))
        return [list(map(int, row)) for row in arr]

    def slice_ranks(self, axes, rank: Optional[int] = None) -> List[int]:
        """The ranks of ``rank``'s slice over ``axes`` (a name or a tuple
        of names, in the mesh's order of them)."""
        axes = self._axes(axes)
        rank = dist.process_index() if rank is None else int(rank)
        for row in self._slices(axes):
            if rank in row:
                return row
        raise MXNetError(f"rank {rank} is not in {self!r}")

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise MXNetError(f"mesh has no axes {unknown}: "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of this process's slice over ``axes``: None
        (the default group) when the slice is the whole world, else a
        ``new_group`` made once for every slice, by every process."""
        axes = self._axes(axes)
        if axes in self._groups:
            return self._groups[axes]
        if not dist.is_initialized():
            raise MXNetError(
                f"{self!r} needs a process group for axes {axes}: start one "
                "with parallel.dist.init_from_env() (the launcher's "
                "environment) or parallel.dist.init(...)")
        world = dist.process_count()
        if self.size != world:
            raise MXNetError(f"{self!r} covers {self.size} ranks but the "
                             f"process group has {world}")
        import torch.distributed as tdist

        me = dist.process_index()
        mine = None
        rows = self._slices(axes)
        if len(rows) == 1 and sorted(rows[0]) == list(range(world)):
            self._groups[axes] = None
            return None
        for row in rows:
            g = tdist.new_group(ranks=row)
            if me in row:
                mine = g
        self._groups[axes] = mine
        return mine


def device_mesh(axis_names: Sequence[str],
                shape: Optional[Sequence[int]] = None, devices=None) -> Mesh:
    """A :class:`Mesh` with named axes over ``devices`` (ranks, or objects
    with an ``id``; default: every process of the group)."""
    ranks = _ranks(devices)
    n = len(ranks)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise MXNetError(
            f"mesh shape {tuple(shape)} does not cover {n} devices")
    return Mesh(np.asarray(ranks).reshape(tuple(shape)), tuple(axis_names))


def _ranks(devices) -> List[int]:
    if devices is None:
        return list(range(dist.process_count()))
    return [int(getattr(d, "id", d)) for d in devices]


def make_mesh(dp: int = 0, tp: int = 1, pp: int = 1, sp: int = 1,
              ep: int = 1, devices=None) -> Mesh:
    """Mesh over the standard parallelism axes, in the order (dp, pp, sp,
    tp, ep); axes of size 1 are still present; ``dp=0`` means whatever is
    left of the devices."""
    n = len(_ranks(devices))
    fixed = tp * pp * sp * ep
    if dp in (0, None):
        if n % fixed != 0:
            raise MXNetError(
                f"{n} devices not divisible by tp*pp*sp*ep={fixed}")
        dp = n // fixed
    return device_mesh(AXIS_ORDER, (dp, pp, sp, tp, ep), devices)


def local_mesh(axis_name: str = "dp", devices=None) -> Mesh:
    """One-axis mesh over this process's devices: one card, one rank."""
    if devices is None:
        devices = [dist.process_index()]
    return device_mesh((axis_name,), (len(devices),), devices)


def host_barrier() -> None:
    """Block until every process reaches this point."""
    dist.barrier()


def global_allreduce(nd):
    """Sum an NDArray across every process (one all-reduce of the group)."""
    if dist.process_count() == 1:
        return nd
    from ..ndarray.ndarray import NDArray

    return NDArray(dist.allreduce_sum(nd._data), ctx=nd.context)
