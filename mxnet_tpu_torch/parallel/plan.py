"""The parallelism ``Plan``: a layout as one serializable value.

Counterpart of ``mxnet_tpu/parallel/plan.py``.  A :class:`Plan` holds the
mesh axes and sizes, the per-parameter sharding rules, the batch axes,
the sequence-axis contract, the sequence-parallel attention mechanism,
the pipeline and accumulation microbatch counts and the precision
config; it validates, serializes (``to_json`` / ``from_json``, lossless,
as the JAX ``Plan.to_json()`` spells it) and builds its mesh over the
process group.  ``DataParallelStep`` (and ``compile_step_with_plan``)
runs every one of the five strategy shims' plans; ``parallel/planner.py``
chooses one analytically.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from ..base import MXNetError
from ..precision.config import PrecisionConfig
from .sharding import ShardingRules

__all__ = ["Plan", "dp_plan", "tensor_parallel_plan", "pipeline_plan",
           "ring_plan", "ulysses_plan", "STRATEGY_NAMES"]

_AXIS_ORDER = ("dp", "pp", "sp", "tp", "ep")
STRATEGY_NAMES = ("auto", "dp", "tp", "pp", "sp", "ring", "ulysses")
_SP_MODES = ("gspmd", "ring", "ulysses")


@dataclass(frozen=True)
class Plan:
    """One parallelism layout (the JAX ``Plan``'s fields and rules)."""

    mesh_axes: Tuple[Tuple[str, int], ...]
    rules: ShardingRules = field(default_factory=ShardingRules)
    batch_axes: Tuple[str, ...] = ("dp", "sp")
    seq_axis: Optional[int] = None
    sp_attention: str = "gspmd"
    pp_microbatches: int = 4
    accum_steps: int = 1
    precision: Optional[PrecisionConfig] = None
    predicted: Optional[dict] = field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "mesh_axes",
                           tuple((str(n), int(s)) for n, s in self.mesh_axes))
        object.__setattr__(self, "batch_axes", tuple(self.batch_axes))
        self.validate()

    def validate(self) -> None:
        names = [n for n, _ in self.mesh_axes]
        if len(set(names)) != len(names):
            raise MXNetError(f"Plan: duplicate mesh axes {names}")
        for n, s in self.mesh_axes:
            if s < 1:
                raise MXNetError(f"Plan: axis {n!r} has size {s} < 1")
        unknown = [a for a in self.batch_axes if a not in names]
        if unknown:
            raise MXNetError(
                f"Plan: batch_axes {unknown} not among mesh axes {names}")
        if self.seq_axis not in (None, 1, -1):
            raise MXNetError("Plan: seq_axis must be None (auto), 1 "
                             "(force SP on dim 1) or -1 (disable)")
        if self.sp_attention not in _SP_MODES:
            raise MXNetError(f"Plan: sp_attention must be one of "
                             f"{_SP_MODES}, got {self.sp_attention!r}")
        if self.pp_microbatches < 1:
            raise MXNetError(f"Plan: pp_microbatches must be >= 1, got "
                             f"{self.pp_microbatches}")
        if self.accum_steps < 1:
            raise MXNetError(f"Plan: accum_steps must be >= 1, got "
                             f"{self.accum_steps}")
        if self.sp_attention != "gspmd" and self.axis_size("sp") < 2 \
                and self.seq_axis != 1:
            raise MXNetError(
                f"Plan: sp_attention={self.sp_attention!r} needs an sp "
                f"axis > 1 (mesh: {dict(self.mesh_axes)})")

    def axis_size(self, name: str) -> int:
        for n, s in self.mesh_axes:
            if n == name:
                return s
        return 1

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self.mesh_axes:
            n *= s
        return n

    @property
    def strategy(self) -> str:
        """The dominant-strategy label (``dp``, ``tp``, ``dp+ring``, ...)."""
        parts = []
        if self.axis_size("tp") > 1:
            parts.append("tp")
        if self.axis_size("pp") > 1:
            parts.append("pp")
        if self.axis_size("sp") > 1 or self.seq_axis == 1:
            parts.append(self.sp_attention if self.sp_attention != "gspmd"
                         else "sp")
        if self.axis_size("dp") > 1 or not parts:
            parts.insert(0, "dp")
        return "+".join(parts)

    def describe(self) -> str:
        mesh = "x".join(f"{n}{s}" for n, s in self.mesh_axes if s > 1) \
            or "1dev"
        return (f"Plan[{self.strategy}] {mesh} accum={self.accum_steps} "
                f"pp_micro={self.pp_microbatches}")

    def build_mesh(self, devices=None):
        """A :class:`~mxnet_tpu_torch.parallel.mesh.Mesh` of this plan's
        axes over ``devices`` (default: every process of the group)."""
        from .mesh import _ranks, device_mesh

        ranks = _ranks(devices)
        if len(ranks) != self.n_devices:
            raise MXNetError(
                f"Plan covers {self.n_devices} devices "
                f"({dict(self.mesh_axes)}) but {len(ranks)} were given")
        return device_mesh(tuple(n for n, _ in self.mesh_axes),
                           tuple(s for _, s in self.mesh_axes), ranks)

    def matches_mesh(self, mesh) -> bool:
        """Whether ``mesh`` realizes this plan: the axes of size > 1 agree,
        in order."""
        mine = tuple((n, s) for n, s in self.mesh_axes if s > 1)
        theirs = tuple((n, int(s)) for n, s in mesh.shape.items() if s > 1)
        return mine == theirs

    def to_json(self) -> dict:
        return {
            "mesh_axes": [[n, s] for n, s in self.mesh_axes],
            "rules": self.rules.to_json(),
            "batch_axes": list(self.batch_axes),
            "seq_axis": self.seq_axis,
            "sp_attention": self.sp_attention,
            "pp_microbatches": self.pp_microbatches,
            "accum_steps": self.accum_steps,
            "precision": (self.precision.to_json()
                          if self.precision is not None else None),
            "strategy": self.strategy,
        }

    @classmethod
    def from_json(cls, rec: dict) -> "Plan":
        ba = rec.get("batch_axes")
        return cls(
            mesh_axes=tuple((n, int(s)) for n, s in rec["mesh_axes"]),
            rules=ShardingRules.from_json(rec.get("rules") or []),
            batch_axes=tuple(ba) if ba is not None else ("dp", "sp"),
            seq_axis=rec.get("seq_axis"),
            sp_attention=rec.get("sp_attention", "gspmd"),
            pp_microbatches=int(rec.get("pp_microbatches", 4)),
            accum_steps=int(rec.get("accum_steps", 1)),
            precision=PrecisionConfig.from_json(rec.get("precision")),
        )

    def with_predicted(self, predicted: dict) -> "Plan":
        return replace(self, predicted=dict(predicted))


def _axes(dp: int, tp: int = 1, pp: int = 1, sp: int = 1,
          ep: int = 1) -> Tuple[Tuple[str, int], ...]:
    sizes = {"dp": dp, "pp": pp, "sp": sp, "tp": tp, "ep": ep}
    return tuple((n, int(sizes[n])) for n in _AXIS_ORDER)


def _resolve_dp(dp: int, n_devices: Optional[int], fixed: int) -> int:
    """dp=0 means whatever is left of ``n_devices`` (default: the
    processes of the group)."""
    if dp not in (0, None):
        return int(dp)
    if n_devices is None:
        from . import dist

        n_devices = dist.process_count()
    if n_devices % fixed:
        raise MXNetError(
            f"{n_devices} devices not divisible by tp*pp*sp={fixed}")
    return n_devices // fixed


def dp_plan(dp: int = 0, n_devices: Optional[int] = None,
            accum_steps: int = 1) -> Plan:
    """Pure data parallelism: the batch split over every device."""
    dp = _resolve_dp(dp, n_devices, 1)
    return Plan(mesh_axes=_axes(dp=dp), accum_steps=accum_steps)


def tensor_parallel_plan(rules: ShardingRules, tp: int, dp: int = 0,
                         n_devices: Optional[int] = None,
                         accum_steps: int = 1) -> Plan:
    """Tensor parallelism through per-parameter rules, with dp over the
    rest."""
    if tp < 2:
        raise MXNetError(f"tensor_parallel_plan: tp must be >= 2, got {tp}")
    dp = _resolve_dp(dp, n_devices, tp)
    return Plan(mesh_axes=_axes(dp=dp, tp=tp), rules=rules,
                accum_steps=accum_steps)


def pipeline_plan(pp: int, microbatches: int = 4, dp: int = 0,
                  n_devices: Optional[int] = None,
                  rules: Optional[ShardingRules] = None,
                  accum_steps: int = 1) -> Plan:
    """GPipe pipeline parallelism over ``pp``: a stacked encoder
    (``models/bert_pp.py``) runs its layers through
    ``pipeline.pipeline_apply``."""
    if pp < 2:
        raise MXNetError(f"pipeline_plan: pp must be >= 2, got {pp}")
    dp = _resolve_dp(dp, n_devices, pp)
    return Plan(mesh_axes=_axes(dp=dp, pp=pp),
                rules=rules or ShardingRules(),
                pp_microbatches=microbatches, accum_steps=accum_steps)


def ring_plan(sp: int, dp: int = 0, n_devices: Optional[int] = None,
              rules: Optional[ShardingRules] = None,
              accum_steps: int = 1) -> Plan:
    """Ring-attention sequence parallelism over ``sp``."""
    if sp < 2:
        raise MXNetError(f"ring_plan: sp must be >= 2, got {sp}")
    dp = _resolve_dp(dp, n_devices, sp)
    return Plan(mesh_axes=_axes(dp=dp, sp=sp),
                rules=rules or ShardingRules(),
                sp_attention="ring", accum_steps=accum_steps)


def ulysses_plan(sp: int, dp: int = 0, n_devices: Optional[int] = None,
                 rules: Optional[ShardingRules] = None,
                 accum_steps: int = 1) -> Plan:
    """Ulysses sequence parallelism: an all-to-all reshards heads."""
    if sp < 2:
        raise MXNetError(f"ulysses_plan: sp must be >= 2, got {sp}")
    dp = _resolve_dp(dp, n_devices, sp)
    return Plan(mesh_axes=_axes(dp=dp, sp=sp),
                rules=rules or ShardingRules(),
                sp_attention="ulysses", accum_steps=accum_steps)
