"""Analytic auto-sharding planner: CHOOSE the dp x tp x pp x sp layout.

Counterpart of ``mxnet_tpu/parallel/planner.py``, with its formulas,
defaults, rankings and ``MX_PLAN`` override.  It enumerates every legal
factorization of a mesh into (dp, tp, pp, sp) for a given model
signature and ranks them with a closed-form cost model: bytes moved per
collective over per-axis bandwidth, per-stage FLOPs with the pipeline
bubble, per-device memory against a budget.  The chosen
:class:`~mxnet_tpu_torch.parallel.plan.Plan` carries the predicted
breakdown as ``plan.predicted``, which ``compile_step_with_plan`` records
in its ``plan`` telemetry event beside the measured ``step`` events.

The formulas (all sizes in bytes, times in seconds):

  per-device params   P_dev  = (P_tp/tp + P_rest) / pp
  per-device acts     A_dev  = A / (dp*sp)
  compute             C      = F / (N * flops_per_device) * bubble
                      bubble = (M + pp - 1) / M          (pp > 1)
  dp grad allreduce   t_dp   = 2*(dp-1)/dp * P_dev / bw(dp)
  tp act collectives  t_tp   = 4*(tp-1)/tp * A_dev / bw(tp)
  sp seq collectives  t_sp   = 4*(sp-1)/sp * A_dev / bw(sp)
  pp boundary hops    t_pp   = 2*(pp-1)/pp * A_dev / bw(pp)
  step                T      = C + t_dp + t_tp + t_sp + t_pp
  memory              M_dev  = (2 + opt_slots) * P_dev
                               + A_dev / (accum * (M if pp>1 else 1))

Legality is structural: dp must divide the batch, sp the sequence
length, pp the stacked layer count (and the per-device batch the
microbatch count), and tp every dimension the sharding rules put it on.
A plan over the memory budget ranks below every plan that fits.

``plan_for`` picks the argmin; ``MX_PLAN`` overrides it (``auto`` |
``dp`` | ``tp`` | ``pp`` | ``sp`` | ``ring`` | ``ulysses``).  On a card
the ``Hardware`` figures are the caller's (the H100's 989 TFLOP/s bf16,
a measured NCCL bus bandwidth, 80 GB); the defaults are the JAX module's
generic ratios, so that rankings and costs agree with it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from .plan import Plan, STRATEGY_NAMES
from .sharding import ShardingRules

__all__ = ["ModelSignature", "Hardware", "PlanChoice", "signature_of",
           "enumerate_plans", "plan_cost", "plan_for"]


@dataclass
class Hardware:
    """What the cost model knows about one device class and its links.

    Relative ranking (the planner's job) only needs the RATIOS to be
    sane, so the defaults are generic accelerator-ish numbers;
    ``bw_override`` pins individual axes (tests and heterogeneous
    meshes).  ``dcn_axes`` names the axes whose collectives cross hosts
    (DCN/Gloo bandwidth class instead of ICI)."""

    flops_per_device: float = 1e12
    ici_bw: float = 1e11          # bytes/s, on-chip interconnect class
    dcn_bw: float = 2.5e9         # bytes/s, cross-host class
    mem_per_device: Optional[float] = None   # bytes; None = unbounded
    opt_slots: float = 2.0        # adam: 2 fp32 slots besides param+grad
    dcn_axes: Tuple[str, ...] = ()
    bw_override: Dict[str, float] = field(default_factory=dict)

    def bw(self, axis: str) -> float:
        if axis in self.bw_override:
            return self.bw_override[axis]
        return self.dcn_bw if axis in self.dcn_axes else self.ici_bw


@dataclass
class ModelSignature:
    """The shape-level facts the cost model needs about one (model,
    batch) pair — constructible by hand for fixtures (every number
    explicit and hand-checkable) or derived from a Gluon block via
    :func:`signature_of`.

    ``flops_per_step`` defaults to the 6·tokens·params dense-training
    estimate over matmul-shaped (ndim>=2) params; ``act_bytes``
    defaults to a rough activations-per-step volume.  Fixtures should
    pass both explicitly."""

    param_shapes: Dict[str, Tuple[int, ...]]
    batch_shape: Tuple[int, ...]
    bytes_per_param: int = 4
    seq_len: Optional[int] = None
    stacked_layers: Optional[int] = None
    rules: Optional[ShardingRules] = None
    flops_per_step: Optional[float] = None
    act_bytes: Optional[float] = None

    def __post_init__(self):
        self.param_shapes = {n: tuple(int(d) for d in s)
                             for n, s in self.param_shapes.items()}
        self.batch_shape = tuple(int(d) for d in self.batch_shape)
        if self.seq_len is None and len(self.batch_shape) >= 2:
            self.seq_len = self.batch_shape[1]
        if self.flops_per_step is None:
            self.flops_per_step = 6.0 * self.tokens * self._matmul_numel()
        if self.act_bytes is None:
            widths = [s[-1] for s in self.param_shapes.values()
                      if len(s) >= 2]
            self.act_bytes = (4.0 * self.tokens
                              * float(max(widths) if widths else 1)
                              * max(1, len(widths)))

    @property
    def batch(self) -> int:
        return self.batch_shape[0]

    @property
    def tokens(self) -> int:
        return self.batch * (self.seq_len or 1)

    def _matmul_numel(self) -> float:
        total = 0.0
        for s in self.param_shapes.values():
            if len(s) >= 2:
                n = 1.0
                for d in s:
                    n *= d
                total += n
        return total

    @property
    def param_bytes(self) -> float:
        total = 0.0
        for s in self.param_shapes.values():
            n = 1.0
            for d in s:
                n *= d
            total += n
        return total * self.bytes_per_param

    def tp_split(self, tp: int) -> Tuple[float, float, bool]:
        """(tp-sharded param bytes, replicated param bytes, divisible):
        which params the rules put on 'tp' and whether every such dim
        divides by ``tp``."""
        if not self.rules or tp < 2:
            return 0.0, self.param_bytes, True
        sharded = 0.0
        ok = True
        for name, shape in self.param_shapes.items():
            spec = tuple(self.rules.spec_for(name, len(shape)))
            dims = [i for i, entry in enumerate(spec)
                    if entry is not None
                    and ("tp" == entry or (isinstance(entry, (tuple, list))
                                           and "tp" in entry))]
            if not dims:
                continue
            n = 1.0
            for d in shape:
                n *= d
            sharded += n * self.bytes_per_param
            for i in dims:
                if shape[i] % tp:
                    ok = False
        return sharded, self.param_bytes - sharded, ok


def signature_of(block, data_shape: Sequence[int],
                 rules: Optional[ShardingRules] = None,
                 stacked_layers: Optional[int] = None,
                 bytes_per_param: int = 4) -> ModelSignature:
    """Derive a :class:`ModelSignature` from an initialized Gluon block
    and one batch shape.  Deferred-init params with unknown shapes are
    skipped (their cost contribution is unknowable pre-trace);
    ``stacked_layers`` defaults to the block's ``_L`` when it exposes
    one (the stacked-encoder pipeline contract of models/bert_pp.py)."""
    shapes = {}
    items = (block.collect_params().items()
             if hasattr(block, "collect_params")
             else block.named_parameters())
    for name, p in items:
        shape = tuple(getattr(p, "shape", ()) or ())
        if shape and all(int(d) > 0 for d in shape):
            shapes[name] = shape
    if stacked_layers is None:
        stacked_layers = getattr(block, "_L", None)
    return ModelSignature(param_shapes=shapes,
                          batch_shape=tuple(data_shape),
                          bytes_per_param=bytes_per_param,
                          rules=rules, stacked_layers=stacked_layers)


@dataclass
class PlanChoice:
    """One enumerated candidate: the Plan plus its predicted cost
    breakdown (the ``predicted`` dict also rides on the Plan itself)."""

    plan: Plan
    cost: Dict[str, object]

    @property
    def step_s(self) -> float:
        return self.cost["step_s"]


def plan_cost(sig: ModelSignature, plan: Plan,
              hw: Optional[Hardware] = None) -> Dict[str, object]:
    """Closed-form cost of running ``sig`` under ``plan`` on ``hw`` —
    the docstring formulas, every intermediate in the returned dict so
    fixtures can hand-check each term."""
    hw = hw or Hardware()
    dp, tp = plan.axis_size("dp"), plan.axis_size("tp")
    pp, sp = plan.axis_size("pp"), plan.axis_size("sp")
    n = plan.n_devices
    p_tp, p_rest, _ = sig.tp_split(tp)
    p_dev = (p_tp / tp + p_rest) / pp
    a_dev = sig.act_bytes / (dp * sp)
    micro = plan.pp_microbatches
    bubble = (micro + pp - 1) / micro if pp > 1 else 1.0
    compute_s = sig.flops_per_step / (n * hw.flops_per_device) * bubble
    comm: Dict[str, float] = {}
    if dp > 1:
        comm["dp"] = 2.0 * (dp - 1) / dp * p_dev / hw.bw("dp")
    if tp > 1:
        comm["tp"] = 4.0 * (tp - 1) / tp * a_dev / hw.bw("tp")
    if sp > 1:
        comm["sp"] = 4.0 * (sp - 1) / sp * a_dev / hw.bw("sp")
    if pp > 1:
        comm["pp"] = 2.0 * (pp - 1) / pp * a_dev / hw.bw("pp")
    comm_s = sum(comm.values())
    act_mem = a_dev / (plan.accum_steps * (micro if pp > 1 else 1))
    mem_bytes = (2.0 + hw.opt_slots) * p_dev + act_mem
    mem_ok = hw.mem_per_device is None or mem_bytes <= hw.mem_per_device
    return {
        "step_s": compute_s + comm_s,
        "compute_s": compute_s,
        "comm_s": comm_s,
        "comm": comm,
        "bubble": bubble,
        "param_bytes_per_device": p_dev,
        "act_bytes_per_device": a_dev,
        "mem_bytes": mem_bytes,
        "mem_ok": mem_ok,
    }


def _legal(sig: ModelSignature, dp: int, tp: int, pp: int, sp: int,
           microbatches: int) -> bool:
    if sig.batch % dp:
        return False
    if sp > 1 and (not sig.seq_len or sig.seq_len % sp):
        return False
    if tp > 1:
        sharded, _, ok = sig.tp_split(tp)
        if not sig.rules or sharded == 0.0 or not ok:
            return False
    if pp > 1:
        if not sig.stacked_layers or sig.stacked_layers % pp:
            return False
        per_dev_batch = sig.batch // dp
        if per_dev_batch % microbatches:
            return False
    return True


def _factorizations(n: int):
    """Every (dp, tp, pp, sp) with dp*tp*pp*sp == n."""
    divs = [d for d in range(1, n + 1) if n % d == 0]
    for tp in divs:
        for pp in [d for d in divs if (n // tp) % d == 0]:
            rem = n // (tp * pp)
            for sp in [d for d in divs if rem % d == 0]:
                yield rem // sp, tp, pp, sp


def _mk_plan(sig: ModelSignature, dp: int, tp: int, pp: int, sp: int,
             microbatches: int, sp_mode: str) -> Plan:
    from .plan import _axes

    return Plan(mesh_axes=_axes(dp=dp, tp=tp, pp=pp, sp=sp),
                rules=(sig.rules if tp > 1 and sig.rules
                       else ShardingRules()),
                seq_axis=(1 if sp > 1 else None),
                sp_attention=(sp_mode if sp > 1 else "gspmd"),
                pp_microbatches=microbatches)


def enumerate_plans(sig: ModelSignature, n_devices: int,
                    hw: Optional[Hardware] = None,
                    microbatches: int = 4,
                    sp_mode: str = "gspmd") -> List[PlanChoice]:
    """Every LEGAL (dp, tp, pp, sp) factorization of ``n_devices`` for
    ``sig``, costed and ranked: plans that fit the memory budget first
    (ascending predicted step time), over-budget plans after (ascending
    memory) — so the head of the list is "fastest that fits" and a
    memory-infeasible mesh still returns its least-bad candidate
    rather than nothing."""
    hw = hw or Hardware()
    choices: List[PlanChoice] = []
    for dp, tp, pp, sp in _factorizations(int(n_devices)):
        if not _legal(sig, dp, tp, pp, sp, microbatches):
            continue
        plan = _mk_plan(sig, dp, tp, pp, sp, microbatches, sp_mode)
        choices.append(PlanChoice(plan, plan_cost(sig, plan, hw)))
    # tie-break: prefer the SIMPLER layout (fewer non-dp axes) — equal
    # predicted cost should never pick tp/pp/sp machinery over plain dp
    choices.sort(key=lambda c: (
        not c.cost["mem_ok"], c.step_s,
        sum(1 for a in ("tp", "pp", "sp") if c.plan.axis_size(a) > 1),
        c.cost["mem_bytes"]))
    return choices


def _ranking_summary(choices: List[PlanChoice], top: int = 5) -> list:
    return [{
        "strategy": c.plan.strategy,
        "mesh": {n: s for n, s in c.plan.mesh_axes if s > 1} or {"dp": 1},
        "step_s": round(float(c.step_s), 9),
        "mem_ok": bool(c.cost["mem_ok"]),
    } for c in choices[:top]]


def _apply_override(choices: List[PlanChoice], strategy: str) -> PlanChoice:
    if strategy == "auto":
        return choices[0]
    if strategy == "dp":
        pure = [c for c in choices
                if all(c.plan.axis_size(a) == 1 for a in ("tp", "pp", "sp"))]
        if not pure:
            raise MXNetError("MX_PLAN=dp: pure data parallelism is not "
                             "legal here (batch not divisible by the "
                             "device count?)")
        return pure[0]
    axis = {"tp": "tp", "pp": "pp", "sp": "sp", "ring": "sp",
            "ulysses": "sp"}[strategy]
    cands = [c for c in choices if c.plan.axis_size(axis) > 1]
    if not cands:
        raise MXNetError(
            f"MX_PLAN={strategy}: no legal layout uses a {axis}>1 axis "
            f"for this model/mesh (divisibility or missing "
            f"rules/stacked layers/sequence dim)")
    best = cands[0]
    if strategy in ("ring", "ulysses"):
        from dataclasses import replace

        plan = replace(best.plan, sp_attention=strategy)
        best = PlanChoice(plan, best.cost)
    return best


def plan_for(sig: ModelSignature, mesh_or_n, hw: Optional[Hardware] = None,
             strategy: Optional[str] = None,
             microbatches: int = 4) -> Plan:
    """The planner entry point: the best legal Plan for ``sig`` over a
    mesh (or raw device count), with its predicted cost breakdown and
    the top of the ranking attached as ``plan.predicted`` — which
    ``compile_step_with_plan`` records as the ``plan`` telemetry event,
    the predicted-vs-measured hook.

    ``strategy`` (default: the ``MX_PLAN`` env var, default ``auto``)
    overrides the argmin: ``dp``/``tp``/``pp``/``sp`` pin the
    corresponding axis family, ``ring``/``ulysses`` additionally select
    the SP attention mechanism.  Raises when nothing legal exists —
    silence here would train on a wrong layout."""
    n = (mesh_or_n if isinstance(mesh_or_n, int)
         else int(len(list(mesh_or_n.devices.flat))))
    strategy = (strategy or os.environ.get("MX_PLAN") or "auto").lower()
    if strategy not in STRATEGY_NAMES:
        raise MXNetError(f"MX_PLAN={strategy!r}: expected one of "
                         f"{STRATEGY_NAMES}")
    choices = enumerate_plans(sig, n, hw=hw, microbatches=microbatches)
    if not choices:
        raise MXNetError(
            f"planner: no legal dp*tp*pp*sp factorization of {n} devices "
            f"for batch {sig.batch} (seq {sig.seq_len}, layers "
            f"{sig.stacked_layers}) — adjust the batch or the mesh")
    chosen = _apply_override(choices, strategy)
    predicted = dict(chosen.cost)
    predicted["comm"] = {k: float(v) for k, v in predicted["comm"].items()}
    predicted["ranking"] = _ranking_summary(choices)
    predicted["override"] = strategy
    return chosen.plan.with_predicted(predicted)
