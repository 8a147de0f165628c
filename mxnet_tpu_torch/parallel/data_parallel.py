"""The fused training step, on one device or over a mesh of processes.

Counterpart of ``mxnet_tpu/parallel/data_parallel.py::DataParallelStep``:
``step(data, label)`` runs the block's forward
in training mode, takes the f32 mean of ``loss_fn(out, label)`` (as
``loss_of`` does), runs the backward, applies one optimizer update and
returns an :class:`AsyncLoss` without waiting for the device.

The updates are ``_sgd_tree_update`` and ``_adam_tree_update`` formula for
formula, with ``learning_rate``, ``lr_scheduler``, ``wd``, ``momentum``,
``beta1``, ``beta2``, ``epsilon``, ``rescale_grad`` and ``clip_gradient``
as ``optimizer_params``, and each parameter's ``lr_mult`` and ``wd_mult``
attributes (1.0 where it has none):

    g = clip(grad * rescale, +-clip_gradient) + wd * wd_mult * w
    sgd:  m = momentum * m - lr * lr_mult * g;  w += m
    adam: m = beta1 m + (1 - beta1) g;  v = beta2 v + (1 - beta2) g^2
          w -= lr * lr_mult * sqrt(1 - beta2^t) / (1 - beta1^t)
               * m / (sqrt(v) + eps)

(MXNet's Adam adds eps to sqrt(v) before the bias correction, unlike
``torch.optim.Adam``, which is not used.)  With ``clip_global_norm=c``
the rescale takes the factor ``min(1, c / (norm + 1e-12))``, ``norm`` the
L2 norm of every trainable parameter's rescaled f32 gradient, before the
per-element clip (``_update_core``).  The lr is read on the host at each
step from the scheduler (its ``base_lr`` set from ``learning_rate``) at
the step's number, counted from 1, as ``_current_lr`` does;
``learning_rate`` is the lr of the next step.

``accum_steps=k`` splits every input and the label into the strided
microbatches ``a[i::k]``, runs the forward and backward of each in turn
and feeds the mean of their losses and gradients to one update; buffers
a forward moves (BatchNorm's running stats) take the mean of what each
microbatch's forward made of them, from the same starting value.
``remat=True`` runs the block under ``torch.utils.checkpoint``
(non-reentrant): its activations are recomputed in the backward, with
the forward's RNG state, as ``jax.checkpoint`` over the block apply;
buffers keep the value of the forward, not of the recomputation.

Every term is computed in f32 from ``grad.float()`` and ``w.float()``
with f32 optimizer state, and a 16-bit parameter is rounded to its dtype
once per step, as the JAX updates do; there is no f32 master copy.  They
run as multi-tensor ``torch._foreach_*`` calls over the parameter list
(the helpers of ``optimizer/foreach.py``, which the fused updater runs
too; parameters whose multipliers differ cost one call per value),
in place on the f32 gradients (which the step owns and discards) and,
for f32 parameters, on the parameters themselves, to save memory.  A
parameter the loss does not reach (BERT's pooler) gets a zero gradient,
as ``jax.grad`` gives it.  Parameters with ``requires_grad=False`` are
frozen, as Gluon's ``grad_req='null'``.  Inputs keep their dtype (a bf16
image batch stays bf16; a numpy bfloat16 array comes in bit for bit).

``precision=`` takes a :class:`~mxnet_tpu_torch.precision.config.
PrecisionConfig` (``MX_AMP`` / ``MX_AMP_POLICY`` / ``MX_LOSS_SCALE`` give
the default when it is None, read once here).  Its AMP policy becomes the
``amp`` pass of the step's pipeline (``passes.pipeline_for_training``),
whose ``wrap_apply`` runs the block's forward under the cast policy with
f32 outputs; the parameters stay f32 masters.  Its loss-scale config
makes the step a scaled one (``precision/loss_scale.py``): the loss is
multiplied by the device scale before the backward, the un-scale folds
into the rescale (``rescale / scale``, before the global-norm clip), one
reduction decides whether every trainable gradient is finite, and a
non-finite step selects the old parameters, optimizer state and float
buffers (BatchNorm's running stats), while the scaler moves
(``scaler_state``: ``scale``, ``growth``, ``skipped``, 0-d device
tensors).  Adam's step count ``t`` and bias correction are then device
tensors too, so a skipped step holds ``t``.  Nothing in the scaled step
reads a value back to the host.  With no precision config the step is
the one above, bit for bit.

``step`` returns without waiting for the card and keeps at most
``MX_ASYNC_INFLIGHT`` (default 2) steps pending in the step's
:class:`~mxnet_tpu_torch.parallel.async_loss.InflightRing`: a step past
the window first waits on the oldest; at 0 every step is forced at
dispatch.  ``drain`` forces the window.  The losses and weights are the
same at every window size.  With telemetry on, ``step`` is a
``train_step`` span holding ``block_wait`` (only when the window was
full), ``input_stage`` and ``dispatch`` spans, and records a ``step``
event (``inflight_depth``, ``block_wait_ms``; the first step is marked
``traced``, as the Trainer's is) and a heartbeat.  ``fault.on_dispatch``
runs before each dispatch, and an out-of-memory error there or at a
deferred readback writes memwatch's post-mortem.  The parameters and the
optimizer state are memwatch's ``params`` and ``optimizer`` categories.

The step's host state follows the JAX step's: ``state_dict()`` is
``{"params": {structural name: value}, "opt_state": {...}, "optimizer":
"sgd" | "adam"}`` with ``mom.<name>`` for SGD, ``mean.<name>``,
``var.<name>`` and ``t`` (int32) for Adam, and ``amp.scale``,
``amp.growth``, ``amp.skipped`` for a loss-scaled step; every Gluon
Parameter of the block has its entry (a frozen one zero slots), in
Gluon's layout, the parameters in their dtype and the slots in f32, as
numpy arrays (bfloat16 ones as CPU tensors, which numpy lacks).
``load_state_dict(state, saved_layout)`` writes such a state back in
place (a JAX step's too), ``shard_state_dict()`` is the format-2 form and
``layout()`` the JAX step's layout on a one-device mesh.  Adam's ``t`` is
counted apart from ``num_update`` (the lr schedule's count, which a
restore leaves alone, as the JAX step leaves its ``_step_count``); the
scaled step keeps it on the card.  The step updates the block's own
tensors, so ``sync_to_block`` only drains.

``mesh=`` (a :class:`~mxnet_tpu_torch.parallel.mesh.Mesh` over the
processes of a ``torch.distributed`` group, one card each), ``rules=``,
``batch_axes=``, ``seq_axis=``, ``ring_attention=``,
``pp_microbatches=`` and ``plan=`` take the JAX step's meaning and
gating.  Each process is given the GLOBAL batch, as the JAX step is, and
slices its own block (``sharding.Placement.local``): with an ``sp`` axis
> 1 and a sequence dimension 1 that divides by it (or ``seq_axis=1``),
dimension 0 over ``dp`` and 1 over ``sp``; otherwise (an NCHW image batch)
dimension 0 over the batch axes (``dp`` x ``sp``); the ``tp`` and ``pp``
ranks of one data block are given the same block.  At construction every
parameter and float buffer is broadcast from the mesh's first rank; then
each parameter a rule places on the ``tp`` or ``pp`` axis keeps the
block its process holds, and so do its optimizer slots
(``tensor_parallel.shard_parameters``; a parameter no rule matches stays
replicated, and a rule the port's layers cannot run raises, naming ROADMAP
A.9 part 4).  The forward and the loss run under the scopes the model's
ops read: ``ring_attention_scope`` when the sequence is sharded
(``ring``, ``ulysses``, or the K/V gather for ``gspmd``),
``tensor_parallel_scope`` when parameters are sharded (the layers' tp
collectives), ``pipeline_parallel_scope`` when ``pp`` > 1 (a stacked
encoder's GPipe schedule, ``parallel/pipeline.py``) and
``batch_reduction_scope``.  After the backward every gradient is summed
over the data axes (``dp`` and ``sp``) in flat buckets of
``dist.bucket_cap_bytes()`` (one all-reduce each, all started before the
first is waited on) and divided by their extent, as is the loss: the
ranks of a ``tp`` or ``pp`` slice computed the same batch, and a
replicated parameter's gradient is the same on each of them, so nothing
is summed over those axes.  ``clip_global_norm`` sums the squared norms
of sharded gradients over the axes they are cut along, once, and the
update acts on the reduced gradients, so every replica takes the same
update.  ``accum_steps`` splits each process's block (``a[i::k]``, the
global mean is the same).  A BatchNorm in training takes the statistics
of the global batch, as the JAX step's do: under the batch reduction
scope it merges every process's count, mean and M2 over the data axes
(``parallel/sync_batch_norm.py``; a torch ``_BatchNorm`` module of a
plain block is routed there too), so every process holds the same
running statistics.  sp > 1 with tp or pp > 1, and ``remat`` with pp > 1,
raise (ROADMAP A.9 part 4).  ``layout()`` reports the world size, the mesh
axes, the ranks and each parameter's spec from the rules (the JAX step's);
``state_dict()`` holds every array whole, in the JAX layout, on every
process (a sharded one gathered over its slice, a collective: every
process calls it).

``shard_state_dict()`` runs no collective, as the JAX step's does: every
process derives the same manifest from the placements alone
(``ParamShard.blocks(rank)`` of every rank of the mesh), the owner of a
block is the lowest rank that holds it, and each process returns the
blocks it owns (a replicated array, Adam's ``t`` and the ``amp.*``
entries are rank 0's, one full-shape shard).  The fused ``qkv`` weight's
block ``[q_r; k_r; v_r]`` is three shards, each its own slice of the JAX
layout.  ``load_state_dict`` reads, of a checkpoint's lazy format-2
arrays, only this process's blocks (``read_slice``), whatever the world
size or layout it was saved on.

Not ported: the superstep (with A.1's captured step) and AOT executables
(the port compiles none).
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import time
from dataclasses import replace
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import fault
from .. import memwatch
from .. import profiler, telemetry
from ..base import MXNetError, tensor_from_numpy
from ..context import resolve_device
from ..optimizer.foreach import adam_, grad_terms_, sgd_
from ..passes.builtin import pipeline_for_training
from ..precision import loss_scale as _ls
from ..precision.config import PrecisionConfig
from . import dist
from .async_loss import AsyncLoss, InflightRing, inflight_limit
from .plan import Plan
from .scope import (batch_reduction_scope, pipeline_parallel_scope,
                    ring_attention_scope, tensor_parallel_scope)
from .sharding import ShardingRules, shard_batch, shard_batch_seq
from .sync_batch_norm import sync_torch_batch_norms as _sync_torch_batch_norms
from .tensor_parallel import A94, ParamShard, shard_of, shard_parameters

__all__ = ["DataParallelStep", "make_train_step", "compile_step_with_plan"]

_LOG = logging.getLogger("mxnet_tpu_torch.data_parallel")


def _params_arrays(step):
    """memwatch provider: the parameters this step trains."""
    return list(step.params)


def _opt_state_arrays(step):
    """memwatch provider: the optimizer state (and the scaler's)."""
    out = [t for s in step.opt_state for t in s]
    if step.scaler_state is not None:
        out += list(step.scaler_state.values()) + [step._t]
    return out


def _host_array(t: torch.Tensor):
    """A host copy of ``t``: a numpy array, or a CPU tensor for bfloat16,
    which numpy lacks."""
    t = t.detach().to("cpu", copy=True)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _cpu_tensor(value) -> torch.Tensor:
    """A loaded value (numpy array, tensor, NDArray or a format-2 lazy
    view) as a CPU tensor."""
    if hasattr(value, "read_slice"):
        return value.tensor()
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    data = getattr(value, "_data", None)
    if isinstance(data, torch.Tensor):
        return data.detach().cpu()
    value = np.asarray(value)
    return tensor_from_numpy(value).reshape(value.shape)  # keeps a 0-d


def _layouts_equal(a: dict, b: dict) -> bool:
    """Whether two layouts denote the same placement (the JAX rule)."""
    keys = ("world_size", "mesh_axes", "device_ids", "specs")
    return all(a.get(k) == b.get(k) for k in keys)


class DataParallelStep:
    _instance_counter = 0

    def __init__(self, block: torch.nn.Module, loss_fn: Callable,
                 optimizer: str = "sgd",
                 optimizer_params: Optional[Dict] = None, device=None,
                 remat: bool = False, accum_steps: int = 1,
                 clip_global_norm: Optional[float] = None,
                 precision: Optional[PrecisionConfig] = None, mesh=None,
                 rules: Optional[ShardingRules] = None,
                 batch_axes: Sequence[str] = ("dp", "sp"),
                 seq_axis: Optional[int] = None, ring_attention=False,
                 pp_microbatches: int = 4, plan: Optional[Plan] = None):
        if optimizer not in ("sgd", "adam"):
            raise MXNetError(f"fused step supports sgd/adam, got {optimizer}")
        if int(accum_steps) < 1:
            raise MXNetError(f"accum_steps must be >= 1, got {accum_steps}")
        opt = dict(optimizer_params or {})
        self.mesh, self.plan = self._resolve_plan(
            mesh, plan, rules, batch_axes, seq_axis, ring_attention,
            accum_steps, pp_microbatches, precision)
        precision = self.plan.precision
        accum_steps = self.plan.accum_steps
        model_par = [f"{a} = {self.plan.axis_size(a)}" for a in ("tp", "pp")
                     if self.plan.axis_size(a) > 1]
        if model_par and self.plan.axis_size("sp") > 1:
            raise MXNetError(
                f"sp = {self.plan.axis_size('sp')} with "
                f"{' and '.join(model_par)}: sequence parallelism composed "
                f"with tensor or pipeline parallelism is {A94}")
        if remat and self.plan.axis_size("pp") > 1:
            raise MXNetError(f"remat with pp = {self.plan.axis_size('pp')}: "
                             f"recomputing a pipeline schedule is {A94}")
        # collectives run whenever a process group holds the mesh, one
        # process included (its all-reduce is exact)
        self._collective = self.mesh is not None and dist.is_initialized()
        self._world = self.mesh.size if self._collective else 1
        # the data axes' extent: what the gradients and the loss are
        # averaged over (the tp and pp ranks of a block compute it alike)
        self._extent = (self.mesh.axis_size("dp") * self.mesh.axis_size("sp")
                        if self._collective else 1)
        if self.mesh is not None and self.mesh.size > 1 \
                and not self._collective:
            self.mesh.group(("dp",))  # raises: no process group
        if device is None and self._collective:
            device = dist.device()
        self.device = resolve_device(device)
        self.block = block.to(self.device)
        self._group = None
        self._shards: Dict[int, ParamShard] = {}
        if self._collective:
            self._group = self.mesh.group(("dp", "sp"))
            if self._world > 1:
                _sync_torch_batch_norms(self.block)
            self._broadcast_from_first()
            self._shard(self.plan.rules)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.precision = precision
        self._loss_scale_cfg = (precision.loss_scale
                                if precision is not None else None)
        self._pipeline = pipeline_for_training(precision)
        self._apply = self._pipeline.wrap_apply(self._block_apply)
        self.remat = bool(remat)
        self.accum_steps = int(accum_steps)
        self.clip_global_norm = clip_global_norm
        self._lr = float(opt.get("learning_rate", 0.01))
        self._lr_scheduler = opt.get("lr_scheduler")
        if self._lr_scheduler is not None:
            self._lr_scheduler.base_lr = self._lr
        self._momentum = float(opt.get("momentum", 0.9))
        self._wd = float(opt.get("wd", 0.0))
        self._beta1 = float(opt.get("beta1", 0.9))
        self._beta2 = float(opt.get("beta2", 0.999))
        self._eps = float(opt.get("epsilon", 1e-8))
        self._rescale = float(opt.get("rescale_grad", 1.0))
        self._clip = opt.get("clip_gradient")
        self.params = [p for p in block.parameters() if p.requires_grad]
        # the multipliers are read once, as the JAX step reads its mults
        self._lr_mults = [float(getattr(p, "lr_mult", 1.0))
                          for p in self.params]
        self._wd_mults = [float(getattr(p, "wd_mult", 1.0))
                          for p in self.params]
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for p in self.params]
        # sgd: momenta; adam: (means, variances)
        self.opt_state = (zeros(),) if optimizer == "sgd" else (zeros(),
                                                                zeros())
        self.num_update = 0
        self._t_host = 0  # Adam's step count (unscaled step)
        self.scaler_state = None
        if self._loss_scale_cfg is not None:
            self.scaler_state = _ls.init_scaler(self._loss_scale_cfg,
                                                self.device)
            # Adam's step count on the device: a skipped step holds it
            self._t = torch.zeros((), dtype=torch.int32, device=self.device)
        # per-instance telemetry key, as the JAX step's
        DataParallelStep._instance_counter += 1
        self._tele_name = (f"DataParallelStep:{type(block).__name__}"
                           f"#{DataParallelStep._instance_counter}")
        self._inflight = InflightRing(self._tele_name)
        memwatch.register("params", self, _params_arrays)
        memwatch.register("optimizer", self, _opt_state_arrays)

    # -- the plan and the mesh ---------------------------------------------
    @staticmethod
    def _resolve_plan(mesh, plan, rules, batch_axes, seq_axis,
                      ring_attention, accum_steps, pp_microbatches,
                      precision):
        """(mesh or None, Plan), with the JAX constructor's rules: a plan
        excludes the strategy keywords; without one the keywords build it
        (``ring_attention`` on a mesh with no ``sp`` axis stays inert)."""
        if plan is not None:
            clash = [kw for kw, val, dflt in (
                ("rules", rules, None),
                ("batch_axes", tuple(batch_axes), ("dp", "sp")),
                ("seq_axis", seq_axis, None),
                ("ring_attention", ring_attention, False),
                ("accum_steps", int(accum_steps), 1),
                ("pp_microbatches", pp_microbatches, 4),
                ("precision", precision, None),
            ) if val != dflt]
            if clash:
                raise MXNetError(
                    f"DataParallelStep: both plan= and strategy kwargs "
                    f"{clash} given — the Plan already carries them")
            if mesh is None:
                mesh = plan.build_mesh()
            elif not plan.matches_mesh(mesh):
                raise MXNetError(
                    f"Plan axes {dict(plan.mesh_axes)} do not match the "
                    f"given mesh {dict(mesh.shape)}")
        else:
            if ring_attention not in (True, False, "ring", "ulysses"):
                raise MXNetError("ring_attention must be bool, 'ring' or "
                                 f"'ulysses', got {ring_attention!r}")
            sp_mode = ("gspmd" if ring_attention is False
                       else "ring" if ring_attention is True
                       else ring_attention)
            shape = dict(mesh.shape) if mesh is not None else {"dp": 1}
            if sp_mode != "gspmd" and shape.get("sp", 1) < 2 \
                    and seq_axis != 1:
                sp_mode = "gspmd"
            plan = Plan(
                mesh_axes=tuple(shape.items()),
                rules=rules or ShardingRules(),
                batch_axes=tuple(a for a in batch_axes if a in shape),
                seq_axis=seq_axis, sp_attention=sp_mode,
                pp_microbatches=int(pp_microbatches),
                accum_steps=int(accum_steps), precision=precision)
        if plan.precision is None:
            # the env default, read once: the config is part of the step
            env_precision = PrecisionConfig.from_env()
            if env_precision is not None:
                plan = replace(plan, precision=env_precision)
        return mesh, plan

    @torch.no_grad()
    def _broadcast_from_first(self) -> None:
        """Every parameter and float buffer from the mesh's first rank to
        every process, so the replicas start equal."""
        import torch.distributed as tdist

        src = int(self.mesh.ranks.reshape(-1)[0])
        tensors = list(self.block.parameters()) + [
            b for b in self.block.buffers() if b.is_floating_point()]
        for t in tensors:
            tdist.broadcast(t.data, src)

    def _rule_names(self):
        """[(name the rules match, tensor)]: a Gluon block's
        ``collect_params`` names (the JAX step's), a plain module's torch
        names."""
        if not hasattr(self.block, "_collect_params_with_prefix"):
            return [(n, t) for n, t, *_ in self._entries()]
        return [(n, p._tensor())
                for n, p in self.block.collect_params().items()]

    @torch.no_grad()
    def _shard(self, rules: ShardingRules) -> None:
        """Cut every parameter the rules place on a model axis to the block
        this process holds; the groups its collectives use are made here,
        by every process in the same order."""
        if not rules:
            return
        self._shards = shard_parameters(self.block, self.mesh, rules,
                                        self._rule_names())
        for t in self.block.parameters():
            sh = self._shards.get(id(t))
            if sh is None:
                continue
            if shard_of(t) is not None:
                raise MXNetError("a parameter is sharded by two steps")
            t.data = sh.local(t.data).contiguous()
            t._mx_shard = sh
        import torch.distributed as tdist

        wanted = [a for a in dict.fromkeys(
            sh.axes for sh in self._shards.values()) if a]
        wanted += [axes for axes in (("tp",), ("pp",), ("pp", "tp"))
                   if all(self.mesh.axis_size(a) > 1 for a in axes)]
        for axes in dict.fromkeys(wanted):
            group = self.mesh.group(axes)
            # one collective on every group first: the pipeline's first
            # use of its group is point-to-point, which NCCL wants after
            # the whole group has joined one
            tdist.all_reduce(torch.zeros(1, device=self.device), group=group)

    # -- the learning rate ------------------------------------------------
    def _current_lr(self, num_update: int) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler(num_update))
        return self._lr

    @property
    def learning_rate(self) -> float:
        """The lr the next step will use."""
        return self._current_lr(self.num_update + 1)

    @learning_rate.setter
    def learning_rate(self, lr: float) -> None:
        self.set_learning_rate(lr)

    def set_learning_rate(self, lr: float) -> None:
        if self._lr_scheduler is not None:
            raise MXNetError(
                "set_learning_rate conflicts with an lr_scheduler "
                "(Trainer semantics: mutate the scheduler instead)")
        self._lr = float(lr)

    # -- the host state (checkpoints) ------------------------------------
    def sync_to_block(self) -> None:
        """Drain the window.  The step updates the block's own tensors in
        place (the JAX step keeps its own arrays and copies them back
        here), so nothing is copied."""
        self.drain()

    def _struct_names(self) -> Dict[str, str]:
        """``collect_params`` name -> structural name (``0.weight``), the
        names checkpoints key on; a shared Parameter takes its last one,
        as in the JAX step."""
        by_param = {id(p): sname for sname, p in
                    self.block._collect_params_with_prefix().items()}
        return {n: by_param.get(id(p), n)
                for n, p in self.block.collect_params().items()}

    def _entries(self):
        """(structural name, tensor, to_gluon, from_gluon) of every
        parameter the JAX step holds: a Gluon block's Parameters in
        ``collect_params`` order, in Gluon's layout; a plain module's
        parameters and floating buffers under their torch names."""
        if not hasattr(self.block, "_collect_params_with_prefix"):
            same = lambda v: v  # noqa: E731
            named = list(self.block.named_parameters()) + [
                (n, b) for n, b in self.block.named_buffers()
                if b.is_floating_point()]
            return [(n, t, same, same) for n, t in named]
        smap = self._struct_names()
        return [(smap[n], p._tensor(), p._to_gluon, p._from_gluon)
                for n, p in self.block.collect_params().items()]

    def layout(self) -> dict:
        """The JAX step's ``layout()``: world size, mesh axes, the device
        ids (the mesh's ranks; the card's index without a mesh), every
        parameter replicated (an empty spec), the plan's JSON and the pass
        pipeline's."""
        if self.mesh is not None:
            axes = [[n, int(s)] for n, s in self.mesh.shape.items()]
            ids = [int(r) for r in self.mesh.ranks.reshape(-1)]
        else:
            axes, ids = [["dp", 1]], [int(self.device.index or 0)]
        rules = self.plan.rules
        by_id = {id(t): n for n, t in self._rule_names()}
        specs = {sname: [list(a) if isinstance(a, tuple) else a
                         for a in rules.spec_for(by_id.get(id(t), sname),
                                                 self._global_ndim(t))]
                 for sname, t, *_ in self._entries()}
        return {
            "world_size": dist.process_count(),
            "mesh_axes": axes,
            "device_ids": ids,
            "platform": "gpu" if self.device.type == "cuda" else "cpu",
            "specs": specs,
            "plan": self.plan.to_json(),
            "passes": self._pipeline.to_json(),
        }

    @staticmethod
    def _global_ndim(t) -> int:
        sh = shard_of(t)
        return t.dim() if sh is None else len(sh.shape)

    def snapshot_requires_collective(self) -> bool:
        """Whether a host copy of the state gathers shards (every process
        must then take it together)."""
        return any(sh.axes for sh in self._shards.values())

    def _whole(self, value, param):
        """``value`` (``param`` or one of its slots) whole: gathered over
        its shard's slice when ``param`` is sharded."""
        sh = self._shards.get(id(param))
        return value if sh is None else sh.gather(value)

    def _local(self, value, param):
        """This process's block of a whole ``value`` for ``param``."""
        sh = self._shards.get(id(param))
        return value if sh is None else sh.local(value)

    def _local_state(self):
        """[(section, key, local device tensor, ParamShard or None,
        to_gluon)] of the state, in the JAX ``state_dict``'s order: this
        process's block of each array and its placement (None: whole).  A
        sharded parameter's Gluon layout is its torch one."""
        slot_of = {id(p): i for i, p in enumerate(self.params)}
        same = lambda v: v  # noqa: E731
        out = []
        entries = self._entries()
        for sname, t, to_gluon, _ in entries:
            out.append(("params", sname, t.detach(), self._shards.get(id(t)),
                        to_gluon))
        prefixes = ("mom",) if self.optimizer == "sgd" else ("mean", "var")
        for k, prefix in enumerate(prefixes):
            for sname, t, to_gluon, _ in entries:
                i = slot_of.get(id(t))
                slot = (self.opt_state[k][i] if i is not None else
                        torch.zeros(t.shape, dtype=torch.float32,
                                    device=t.device))
                out.append(("opt_state", f"{prefix}.{sname}", slot,
                            self._shards.get(id(t)), to_gluon))
        if self.optimizer == "adam":
            t = (self._t if self.scaler_state is not None else
                 torch.tensor(self._t_host, dtype=torch.int32))
            out.append(("opt_state", "t", t, None, same))
        if self.scaler_state is not None:
            for key in _ls.SCALER_KEYS:
                out.append(("opt_state", f"amp.{key}",
                            self.scaler_state[key], None, same))
        return out

    def _host_state(self):
        """[(section, key, device tensor)] of the state, every array whole
        (a sharded one gathered over its slice), in Gluon's layouts."""
        return [(section, key,
                 to_gluon(value if sh is None else sh.gather(value)))
                for section, key, value, sh, to_gluon in self._local_state()]

    def state_dict(self, allow_collective: bool = True) -> dict:
        """Host copy of the training state (see the module's docstring).
        It does not force the window: each copy waits for the work queued
        before it on the card."""
        out = {"params": {}, "opt_state": {}}
        for section, key, t in self._host_state():
            out[section][key] = _host_array(t)
        out["optimizer"] = self.optimizer
        return out

    def shard_state_dict(self) -> dict:
        """The format-2 form of :meth:`state_dict`, with no collective:
        ``{"params": {name: [(j, value)]}, "opt_state": {...}, "manifest":
        {...}, "optimizer", "rank", "nprocs"}``.  The manifest, the same on
        every process, lists each array's shape, dtype and shards (``rank``
        the owner, ``j`` its index among the owner's shards of the array,
        ``slice`` the [start, stop) of each dimension in the JAX layout);
        the payloads are the shards this process owns."""
        rank = dist.process_index()
        manifest = {"params": {}, "opt_state": {}}
        local = {"params": {}, "opt_state": {}}
        for section, key, value, sh, to_gluon in self._local_state():
            if sh is None:
                value = to_gluon(value)
                shape = tuple(value.shape)
                shards = [{"rank": 0, "j": 0,
                           "slice": [[0, int(n)] for n in shape]}]
                payloads = [(0, _host_array(value))] if rank == 0 else []
            else:
                shape = sh.shape
                shards, payloads = _owned_blocks(sh, value, rank)
            manifest[section][key] = {
                "shape": [int(n) for n in shape],
                "dtype": str(value.dtype).replace("torch.", ""),
                "shards": shards}
            if payloads:
                local[section][key] = payloads
        return {"params": local["params"], "opt_state": local["opt_state"],
                "manifest": manifest, "optimizer": self.optimizer,
                "rank": rank, "nprocs": dist.process_count()}

    def _load_into(self, dst: torch.Tensor, value, param,
                   from_gluon) -> None:
        """Write this process's block of a loaded array into ``dst`` (a
        parameter or one of its slots): of a lazy format-2 array only the
        blocks ``param``'s placement holds are read; any other value is
        taken whole."""
        sh = self._shards.get(id(param))
        if sh is not None and hasattr(value, "read_slice"):
            for glob, loc in sh.blocks():
                dst[loc].copy_(value.read_slice(glob))
            return
        dst.copy_(self._local(from_gluon(_cpu_tensor(value)), param))

    @torch.no_grad()
    def load_state_dict(self, state: dict,
                        saved_layout: Optional[dict] = None) -> dict:
        """Write a host state (this step's, a JAX step's, or a
        checkpoint's) into the block's tensors and the optimizer state, in
        place.  A state saved from another optimizer raises; one without
        optimizer slots zeroes them, loudly; a partly missing slot raises.
        Returns ``{"resharded", "old_world", "new_world", "n_params"}``
        (one device: nothing is resharded, but a saved layout that differs
        is reported, as the JAX step reports it)."""
        saved_opt = state.get("optimizer") or (saved_layout or {}).get(
            "optimizer")
        if saved_opt and saved_opt != self.optimizer:
            raise MXNetError(
                f"checkpoint optimizer state was saved from a "
                f"{saved_opt!r} step but this step runs "
                f"{self.optimizer!r} — restoring would silently "
                "zero-fill every optimizer slot")
        params_host = state["params"]
        entries = self._entries()
        for sname, t, _, from_gluon in entries:
            if sname not in params_host:
                raise MXNetError(f"checkpoint missing parameter {sname}")
            self._load_into(t, params_host[sname], t, from_gluon)
        opt = dict(state.get("opt_state") or {})
        amp_state = {k[len("amp."):]: opt.pop(k)
                     for k in list(opt) if k.startswith("amp.")}
        if not opt:
            _LOG.warning(
                "load_state_dict: checkpoint carries no optimizer state — "
                "resuming with FRESH (zeroed) %s slots", self.optimizer)
        slot_of = {id(p): i for i, p in enumerate(self.params)}
        prefixes = ("mom",) if self.optimizer == "sgd" else ("mean", "var")
        for k, prefix in enumerate(prefixes):
            for sname, t, _, from_gluon in entries:
                i = slot_of.get(id(t))
                if i is None:
                    continue  # frozen: the step keeps no slot
                key = f"{prefix}.{sname}"
                dst = self.opt_state[k][i]
                if key in opt:
                    self._load_into(dst, opt[key], t, from_gluon)
                elif opt:
                    raise MXNetError(
                        f"checkpoint optimizer state is missing slot "
                        f"{key!r} (has: {sorted(opt)[:8]}...)")
                else:
                    dst.zero_()
        if self.optimizer == "adam":
            t = int(_cpu_tensor(opt.get("t", 0)).reshape(()))
            if self.scaler_state is not None:
                self._t.fill_(t)
            else:
                self._t_host = t
        if self._loss_scale_cfg is not None:
            fresh = _ls.init_scaler_host(self._loss_scale_cfg)
            if not amp_state:
                _LOG.warning(
                    "load_state_dict: checkpoint carries no amp.* "
                    "loss-scale state — resuming with a FRESH scaler "
                    "(scale=%s)", fresh["scale"])
            self.scaler_state = {
                k: torch.tensor(np.asarray(
                    _cpu_tensor(amp_state[k]) if k in amp_state
                    else fresh[k]).astype(np.asarray(fresh[k]).dtype),
                    device=self.device)
                for k in _ls.SCALER_KEYS}
        elif amp_state:
            _LOG.warning(
                "load_state_dict: checkpoint carries amp.* loss-scale "
                "state but this step runs without loss scaling — "
                "ignoring it")
        cur = self.layout()
        old_world = (saved_layout or {}).get("world_size")
        info = {"resharded": bool(saved_layout is not None
                                  and not _layouts_equal(saved_layout,
                                                         cur)),
                "old_world": old_world, "new_world": cur["world_size"],
                "n_params": len(entries)}
        if info["resharded"] and telemetry.enabled():
            telemetry.record("reshard", executor=self._tele_name,
                             n_params=len(entries), old_world=old_world,
                             new_world=cur["world_size"])
            if old_world is not None and old_world != cur["world_size"] \
                    and not os.environ.get("MX_ELASTIC") \
                    and not os.environ.get("MX_PREV_NUM_PROCS"):
                # a resize by hand: under the supervisor the rendezvous
                # records it (MX_PREV_NUM_PROCS), and a later restart of
                # the same size must not record it again
                telemetry.record("resize", old_world=old_world,
                                 new_world=cur["world_size"],
                                 source="restore")
        return info

    # -- the step ---------------------------------------------------------
    def _put(self, x):
        from ..ndarray.ndarray import NDArray

        if isinstance(x, NDArray):
            x = x.data
        if isinstance(x, np.ndarray):
            x = tensor_from_numpy(x)
        return x.to(self.device, non_blocking=True)

    def _placements(self, datas, label):
        """(placement of each input, of the label, sp_active): the JAX
        step's ``_input_shardings`` over this step's mesh."""
        mesh, plan = self.mesh, self.plan
        sp = mesh.axis_size("sp")
        sp_active = (sp > 1 and "sp" in plan.batch_axes
                     and plan.seq_axis != -1
                     and any(np.ndim(a) >= 2 for a in datas))
        if sp_active and plan.seq_axis is None:
            sp_active = all(np.shape(a)[1] % sp == 0
                            for a in datas if np.ndim(a) >= 2)
        if plan.seq_axis == 1 and sp_active:
            bad = [tuple(np.shape(a)) for a in datas
                   if np.ndim(a) >= 2 and np.shape(a)[1] % sp != 0]
            if bad:
                raise MXNetError(
                    f"seq_axis=1: sequence dims of {bad} are not divisible "
                    f"by sp={sp}")

        def one(arr):
            nd = np.ndim(arr)
            if sp_active and nd >= 2 and np.shape(arr)[1] % sp == 0:
                return shard_batch_seq(mesh, nd)
            if sp_active:  # rank-1 (or ragged) input under SP: dp only
                return shard_batch(mesh, ("dp",), nd)
            return shard_batch(mesh, plan.batch_axes, max(nd, 1))

        return tuple(one(a) for a in datas), one(label), sp_active

    def _place(self, datas, label):
        """The inputs on this step's device, each cut to this process's
        block of the global batch under a mesh -> (datas, label,
        sp_active)."""
        from ..ndarray.ndarray import NDArray

        if self.mesh is None or self.mesh.size == 1:
            return (tuple(self._put(d) for d in datas), self._put(label),
                    False)
        datas = tuple(d.data if isinstance(d, NDArray) else d for d in datas)
        if isinstance(label, NDArray):
            label = label.data
        data_pl, label_pl, sp_active = self._placements(datas, label)

        def cut(x, pl):
            if isinstance(x, np.ndarray):
                x = tensor_from_numpy(x)
            if x.dim() == 0:
                return x.to(self.device, non_blocking=True)
            return x[pl.local(tuple(x.shape))].contiguous().to(
                self.device, non_blocking=True)

        return (tuple(cut(d, p) for d, p in zip(datas, data_pl)),
                cut(label, label_pl), sp_active)

    def _scopes(self, sp_active):
        """The forward's scopes: the sequence-parallel route when the
        inputs were sequence-sharded, and the loss's batch reduction over
        more than one process."""
        stack = contextlib.ExitStack()
        if sp_active:
            dim0 = tuple(a for a in self.plan.batch_axes
                         if a != "sp" and self.mesh.axis_size(a) > 1)
            stack.enter_context(ring_attention_scope(
                self.mesh, dim0, mode=self.plan.sp_attention))
        if self._shards:
            stack.enter_context(tensor_parallel_scope(self.mesh))
        if self.mesh is not None and self.mesh.axis_size("pp") > 1:
            dim0 = tuple(a for a in self.plan.batch_axes
                         if a != "sp" and self.mesh.axis_size(a) > 1)
            stack.enter_context(pipeline_parallel_scope(
                self.mesh, dim0, self.plan.pp_microbatches))
        if self._extent > 1:
            stack.enter_context(batch_reduction_scope(self._group,
                                                      self._extent))
        return stack

    def _allreduce_mean(self, tensors):
        """Each tensor summed over the data axes in place and divided by
        their extent: flat buckets of ``bucket_cap_bytes``, one all-reduce
        each, all started before the first is waited on."""
        import torch.distributed as tdist

        pending = []
        for idx in dist.buckets(tensors):
            one = len(idx) == 1 and tensors[idx[0]].is_contiguous()
            flat = (tensors[idx[0]].view(-1) if one
                    else dist.flatten_bucket([tensors[i] for i in idx]))
            pending.append((idx, flat, one, tdist.all_reduce(
                flat, group=self._group, async_op=True)))
        for idx, flat, one, work in pending:
            work.wait()
            if self._extent > 1:
                flat.div_(self._extent)
            if not one:
                for i, part in zip(idx, dist.unflatten_bucket(
                        flat, [tuple(tensors[i].shape) for i in idx])):
                    tensors[i].copy_(part)
        return tensors

    def stage(self, data, label):
        """One batch on this step's device ahead of its ``step`` ->
        (data tuple, label) of NDArrays (``io.DevicePrefetchIter`` calls
        it from its background thread); ``step`` then copies nothing.
        The values are the same either way."""
        from ..ndarray.ndarray import NDArray

        datas = tuple(data) if isinstance(data, (tuple, list)) else (data,)
        staged = tuple(NDArray(self._put(d), ctx=self.device) for d in datas)
        return staged, (None if label is None else
                        NDArray(self._put(label), ctx=self.device))

    def drain(self) -> None:
        """Force every in-flight step (epoch end, before a checkpoint,
        exit); raises the first deferred failure."""
        self._inflight.drain()

    @property
    def inflight_depth(self) -> int:
        """Dispatched, unforced steps pending now."""
        return self._inflight.depth

    @staticmethod
    def _microbatch(a, i: int, k: int):
        """Microbatch ``i`` of ``k``: the strided rows ``a[i::k]`` (the
        JAX step's choice: each microbatch draws from every device's
        shard of the batch)."""
        return a[i::k] if k > 1 else a

    def _block_apply(self, params, key, *datas):
        """The block's forward as the pass pipeline wraps it (the JAX
        step's ``apply(params, key, *inputs) -> (out, aux)``; the block
        holds its own parameters and buffers)."""
        return self.block(*datas), ()

    def _loss(self, datas, label):
        # under remat the recomputation runs through the same wrapped
        # apply, so it sees the same cast policy
        if self.remat:
            out, _ = checkpoint(self._apply, None, None, *datas,
                                use_reentrant=False)
        else:
            out, _ = self._apply(None, None, *datas)
        return self.loss_fn(out, label).float().mean()

    def _held_state(self):
        """What a skipped step holds: the parameters, the optimizer state
        and the block's float buffers."""
        bufs = [b for b in self.block.buffers() if b.is_floating_point()]
        return list(self.params) + [t for s in self.opt_state
                                    for t in s] + bufs

    def step(self, data, label) -> AsyncLoss:
        """One training step; ``data`` is a tensor (or numpy array) or a
        tuple of them for a block with several inputs.  Returns the lazy
        loss without waiting for the card, unless the window is full (it
        then waits on the oldest pending step first) or 0."""
        with telemetry.span("train_step", executor=self._tele_name):
            handle = self._step_impl(data, label)
        memwatch.on_step(self.num_update)
        return handle

    def _step_impl(self, data, label) -> AsyncLoss:
        name = self._tele_name
        t0 = time.perf_counter()
        limit = inflight_limit()
        block_wait_s = 0.0
        if limit > 0:
            bw0 = time.perf_counter()
            # the interval is this step's block_wait span: the inner waits
            # record no loss_wait span over the same wall
            block_wait_s = self._inflight.make_room(limit, wait_span=False)
            if block_wait_s > 0.0:
                telemetry.record_span("block_wait", bw0, bw0 + block_wait_s)
        with telemetry.span("input_stage"):
            datas = tuple(data) if isinstance(data, (tuple, list)) \
                else (data,)
            raw = datas + (label,)
            datas, label, sp_active = self._place(datas, label)
        step_no = self.num_update + 1
        with telemetry.span("dispatch", step=step_no,
                            traced=step_no == 1):
            fault.on_dispatch(step_no)
            try:
                if profiler._running:
                    # the step is one profiled call, as the JAX step's
                    # compiled program is: the ops inside record nothing
                    loss = profiler.timed_call(
                        f"FusedStep:{type(self.block).__name__}",
                        self._dispatch, datas, label, sp_active)
                else:
                    loss = self._dispatch(datas, label, sp_active)
            except Exception as e:
                if memwatch.is_resource_exhausted(e):
                    memwatch.emit_oom_report(
                        executor=name, step=step_no,
                        inflight_depth=self._inflight.depth)
                raise
        self.num_update = step_no
        handle = AsyncLoss(loss, step=step_no, executor=name,
                           ring=self._inflight)
        depth = self._inflight.admit(handle) if limit > 0 else 0
        if telemetry.enabled():
            placed = datas + (label,)
            xfer = sum(t.numel() * t.element_size() for t in placed)
            staged = sum(t.numel() * t.element_size()
                         for t, r in zip(placed, raw)
                         if getattr(r, "_data", r) is t)
            telemetry.record_step(name, step=step_no,
                                  wall_s=time.perf_counter() - t0,
                                  samples=int(label.shape[0])
                                  if label.dim() else 1,
                                  transfer_bytes=xfer, traced=step_no == 1,
                                  h2d_overlapped=staged,
                                  inflight_depth=depth,
                                  block_wait_ms=round(block_wait_s * 1e3, 3))
            # the heartbeat advances at dispatch, not at readback
            telemetry.heartbeat(step_no)
        if limit == 0:
            handle.wait()  # synchronous mode: a failure surfaces here
        return handle

    def _dispatch(self, datas, label, sp_active=False) -> torch.Tensor:
        """The forward, backward and update of one step on placed inputs
        -> the device loss (the mean over the data axes' processes)."""
        k = self.accum_steps
        if k > 1:
            for d in datas + (label,):
                if d.shape[0] % k:
                    raise MXNetError(f"batch {d.shape[0]} not divisible by "
                                     f"accum_steps={k}")
        self.block.train()
        for p in self.params:
            p.grad = None
        scaled = self.scaler_state is not None
        if scaled:
            scale = self.scaler_state["scale"]
            held = self._held_state()
            before = [t.detach().clone() for t in held]
        bufs = ([b for b in self.block.buffers() if b.is_floating_point()]
                if k > 1 or self.remat else [])
        start = [b.clone() for b in bufs] if k > 1 else []
        sums = None
        loss = None
        for i in range(k):
            if i and bufs:
                torch._foreach_copy_(bufs, start)
            with self._scopes(sp_active):
                loss_i = self._loss(
                    tuple(self._microbatch(d, i, k) for d in datas),
                    self._microbatch(label, i, k))
                made = [b.clone() for b in bufs]
                (loss_i * scale if scaled else loss_i).backward()
            if bufs:  # what the forward made of them, not the recomputation
                sums = made if sums is None else torch._foreach_add(sums,
                                                                    made)
            loss_i = loss_i.detach() / k if k > 1 else loss_i
            loss = loss_i if loss is None else loss + loss_i
        if bufs:
            torch._foreach_copy_(bufs, torch._foreach_div(sums, k))
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if k > 1:
            grads = torch._foreach_div(grads, k)
        if self._collective:
            with torch.no_grad():
                grads = self._allreduce_mean(grads)
                loss = self._allreduce_mean([loss.detach().reshape(1)])[0][0]
        with torch.no_grad():
            if not scaled:
                self._update(grads)
            else:
                finite = self._model_all(
                    _ls.grads_finite([g.float() for g in grads]))
                self._update(grads, scale)
                # the skip step: every held tensor selects its old value
                for t, old in zip(held, before):
                    t.copy_(torch.where(finite, t, old))
                self._t = self._t + finite.to(torch.int32)
                self.scaler_state = _ls.scaler_update(
                    self.scaler_state, finite, self._loss_scale_cfg)
        for p in self.params:
            p.grad = None
        return loss

    def _grad_terms(self, grads, w, rescale=None):
        """g = clip(grad * rescale [* global-norm factor]) + wd * wd_mult
        * w, in place on the f32 ``grads``; ``w`` the parameters in f32.
        ``rescale`` defaults to ``rescale_grad``; under a loss scale it is
        ``rescale_grad / scale``, a device tensor."""
        rescale = self._rescale if rescale is None else rescale
        scale = rescale
        if self.clip_global_norm is not None and grads:
            norm = self._global_norm(grads) * abs(rescale)
            scale = torch.clamp(self.clip_global_norm / (norm + 1e-12),
                                max=1.0) * rescale
        return grad_terms_(grads, w, scale, self._clip,
                           [self._wd * m for m in self._wd_mults])

    def _global_norm(self, grads) -> torch.Tensor:
        """The L2 norm of every trainable gradient: a sharded one's squared
        norm summed over the slice it is cut along, once; a replicated
        one's counted once, not once a process."""
        norms = torch._foreach_norm(grads)
        if not any(sh.axes for sh in self._shards.values()):
            return torch.linalg.vector_norm(torch.stack(norms))
        import torch.distributed as tdist

        by_axes: Dict[tuple, list] = {}
        for p, n in zip(self.params, norms):
            sh = self._shards.get(id(p))
            by_axes.setdefault(sh.axes if sh is not None else (), []).append(n)
        total = None
        for axes in sorted(by_axes):
            sq = torch.stack(by_axes[axes]).float().square().sum()
            if axes:
                tdist.all_reduce(sq, group=self.mesh.group(axes))
            total = sq if total is None else total + sq
        return total.sqrt()

    def _model_all(self, flag: torch.Tensor) -> torch.Tensor:
        """``flag`` (a 0-d bool) true on every process of this one's tp x
        pp slice: a non-finite shard skips the step everywhere."""
        axes = tuple(a for a in ("pp", "tp") if self.mesh is not None
                     and self._shards and self.mesh.axis_size(a) > 1)
        if not axes:
            return flag
        import torch.distributed as tdist

        f = flag.to(torch.int32).reshape(1)
        tdist.all_reduce(f, op=tdist.ReduceOp.MIN,
                         group=self.mesh.group(axes))
        return f[0].bool()

    def _update(self, grads, loss_scale=None) -> None:
        # f32 views: the tensors themselves where they are f32, copies of
        # 16-bit ones, which are rounded back once at the end
        w = [p.float() for p in self.params]
        g = [x.float() for x in grads]
        g = (self._grad_terms(g, w) if loss_scale is None
             else self._grad_terms(g, w, self._rescale / loss_scale))
        lr = self._current_lr(self.num_update + 1)
        if self.optimizer == "sgd":
            sgd_(w, g, self.opt_state[0], self._momentum,
                 [lr * m for m in self._lr_mults])
        elif loss_scale is not None:
            self._adam_device_t(w, g, lr)
        else:
            t = self._t_host = self._t_host + 1
            corr = math.sqrt(1 - self._beta2 ** t) / (1 - self._beta1 ** t)
            adam_(w, g, *self.opt_state, self._beta1, self._beta2, self._eps,
                  [lr * m * corr for m in self._lr_mults])
        low = [(p, x) for p, x in zip(self.params, w) if x is not p]
        if low:
            torch._foreach_copy_([p for p, _ in low], [x for _, x in low])

    def _adam_device_t(self, w, g, lr: float) -> None:
        """Adam with ``t`` and the bias correction on the device (the
        scaled step): ``w -= ((lr * lr_mult) * corr) * m / (sqrt(v) +
        eps)`` in the JAX update's order, one multi-tensor call a group of
        equal ``lr_mult``."""
        means, vars_ = self.opt_state
        b1, b2 = self._beta1, self._beta2
        torch._foreach_mul_(means, b1)
        torch._foreach_add_(means, g, alpha=1 - b1)
        torch._foreach_mul_(vars_, b2)
        torch._foreach_addcmul_(vars_, g, g, value=1 - b2)
        denom = torch._foreach_sqrt(vars_)
        torch._foreach_add_(denom, self._eps)
        t = (self._t + 1).float()
        corr = torch.sqrt(1 - torch.pow(b2, t)) / (1 - torch.pow(b1, t))
        groups = {}
        for i, m in enumerate(self._lr_mults):
            groups.setdefault(m, []).append(i)
        for m, idx in groups.items():
            step = torch._foreach_mul([means[i] for i in idx],
                                      corr * (lr * m))
            torch._foreach_div_(step, [denom[i] for i in idx])
            torch._foreach_sub_([w[i] for i in idx], step)


def _owned_blocks(sh: ParamShard, local: torch.Tensor, rank: int):
    """(manifest shards, this rank's payloads) of a placed array: every
    block of every rank of the mesh, each owned by the lowest rank holding
    it, in the order of their slices (the JAX ``_local_shard_split``'s)."""
    def key(glob):
        return tuple((int(s.start), int(s.stop)) for s in glob)

    owners: Dict[tuple, int] = {}
    for r in sorted(int(r) for r in sh.mesh.ranks.reshape(-1)):
        for glob, _ in sh.blocks(r):
            k = key(glob)
            if all(a < b for a, b in k):  # GSPMD's ceil cut may leave none
                owners.setdefault(k, r)
    mine = {key(glob): loc for glob, loc in sh.blocks(rank)}
    shards, payloads, counters = [], [], {}
    for k in sorted(owners):
        owner = owners[k]
        j = counters.get(owner, 0)
        counters[owner] = j + 1
        shards.append({"rank": owner, "j": j, "slice": [list(p) for p in k]})
        if owner == rank:
            payloads.append((j, _host_array(local[mine[k]])))
    return shards, payloads


def make_train_step(block, loss_fn, mesh=None, **kwargs) -> DataParallelStep:
    return DataParallelStep(block, loss_fn, mesh=mesh, **kwargs)


def compile_step_with_plan(block, loss_fn, plan: Plan, mesh=None,
                           **kwargs) -> DataParallelStep:
    """The step for any :class:`~mxnet_tpu_torch.parallel.plan.Plan` (the
    JAX package's single compile path; the port compiles nothing, so this
    is the constructor with ``plan=``), recording one ``plan`` telemetry
    event."""
    step = DataParallelStep(block, loss_fn, mesh=mesh, plan=plan, **kwargs)
    if telemetry.enabled():
        telemetry.record(
            "plan", executor=step._tele_name, strategy=plan.strategy,
            plan=plan.to_json(), passes=step._pipeline.names(),
            predicted=plan.predicted)
    return step
