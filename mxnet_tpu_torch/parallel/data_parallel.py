"""The fused training step, on one device.

Counterpart of ``mxnet_tpu/parallel/data_parallel.py::DataParallelStep``
for a mesh of one device: ``step(data, label)`` runs the block's forward
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
place (a JAX step's too), ``shard_state_dict()`` is the format-2 form
(one process: rank 0 owns every array whole) and ``layout()`` the JAX
step's layout on a one-device mesh.  Adam's ``t`` is counted apart from
``num_update`` (the lr schedule's count, which a restore leaves alone, as
the JAX step leaves its ``_step_count``); the scaled step keeps it on the
card.  The step updates the block's own tensors, so ``sync_to_block``
only drains.

Not ported: meshes and sharding (A.9), the superstep (with A.1's
captured step) and AOT executables (the port compiles none).
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, Optional

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
from .async_loss import AsyncLoss, InflightRing, inflight_limit

__all__ = ["DataParallelStep"]

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


def _dp_plan_json(accum_steps: int, precision) -> dict:
    """``Plan.to_json()`` of the JAX step's plan on a one-device ``dp``
    mesh (``mxnet_tpu/parallel/plan.py``), which ``layout()`` carries;
    ``Plan`` itself waits for A.9."""
    return {"mesh_axes": [["dp", 1]], "rules": [], "batch_axes": ["dp"],
            "seq_axis": None, "sp_attention": "gspmd",
            "pp_microbatches": 4, "accum_steps": int(accum_steps),
            "precision": (precision.to_json() if precision is not None
                          else None),
            "strategy": "dp"}


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
                 precision: Optional[PrecisionConfig] = None):
        if optimizer not in ("sgd", "adam"):
            raise MXNetError(f"fused step supports sgd/adam, got {optimizer}")
        if int(accum_steps) < 1:
            raise MXNetError(f"accum_steps must be >= 1, got {accum_steps}")
        opt = dict(optimizer_params or {})
        self.device = resolve_device(device)
        self.block = block.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        if precision is None:
            # the env default, read once: the config is part of the step
            precision = PrecisionConfig.from_env()
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
        """The JAX step's ``layout()`` on a one-device mesh: world size,
        mesh axes, the device, every parameter replicated (an empty
        spec), the plan's JSON and the pass pipeline's."""
        return {
            "world_size": 1,
            "mesh_axes": [["dp", 1]],
            "device_ids": [int(self.device.index or 0)],
            "platform": "gpu" if self.device.type == "cuda" else "cpu",
            "specs": {sname: [] for sname, *_ in self._entries()},
            "plan": _dp_plan_json(self.accum_steps, self.precision),
            "passes": self._pipeline.to_json(),
        }

    def snapshot_requires_collective(self) -> bool:
        """False: one process holds every array whole."""
        return False

    def _host_state(self):
        """[(section, key, device tensor)] of the state, in the JAX
        ``state_dict``'s order, in Gluon's layouts."""
        slot_of = {id(p): i for i, p in enumerate(self.params)}
        out = []
        entries = self._entries()
        for sname, t, to_gluon, _ in entries:
            out.append(("params", sname, to_gluon(t.detach())))
        prefixes = ("mom",) if self.optimizer == "sgd" else ("mean", "var")
        for k, prefix in enumerate(prefixes):
            for sname, t, to_gluon, _ in entries:
                i = slot_of.get(id(t))
                slot = (self.opt_state[k][i] if i is not None else
                        torch.zeros_like(t, dtype=torch.float32))
                out.append(("opt_state", f"{prefix}.{sname}",
                            to_gluon(slot)))
        if self.optimizer == "adam":
            t = (self._t if self.scaler_state is not None else
                 torch.tensor(self._t_host, dtype=torch.int32))
            out.append(("opt_state", "t", t))
        if self.scaler_state is not None:
            for key in _ls.SCALER_KEYS:
                out.append(("opt_state", f"amp.{key}",
                            self.scaler_state[key]))
        return out

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
        """The format-2 form of :meth:`state_dict`: ``{"params": {name:
        [(0, value)]}, "opt_state": {...}, "manifest": {...},
        "optimizer", "rank": 0, "nprocs": 1}``; rank 0 owns every array
        as one shard covering it whole."""
        manifest = {"params": {}, "opt_state": {}}
        local = {"params": {}, "opt_state": {}}
        for section, key, t in self._host_state():
            value = _host_array(t)
            manifest[section][key] = {
                "shape": [int(n) for n in t.shape],
                "dtype": str(t.dtype).replace("torch.", ""),
                "shards": [{"rank": 0, "j": 0,
                            "slice": [[0, int(n)] for n in t.shape]}]}
            local[section][key] = [(0, value)]
        return {"params": local["params"], "opt_state": local["opt_state"],
                "manifest": manifest, "optimizer": self.optimizer,
                "rank": 0, "nprocs": 1}

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
            t.copy_(from_gluon(_cpu_tensor(params_host[sname])))
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
                    dst.copy_(from_gluon(_cpu_tensor(opt[key])))
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
        return info

    # -- the step ---------------------------------------------------------
    def _put(self, x):
        from ..ndarray.ndarray import NDArray

        if isinstance(x, NDArray):
            x = x.data
        if isinstance(x, np.ndarray):
            x = tensor_from_numpy(x)
        return x.to(self.device, non_blocking=True)

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
            datas = tuple(self._put(d) for d in datas)
            label = self._put(label)
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
                        self._dispatch, datas, label)
                else:
                    loss = self._dispatch(datas, label)
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

    def _dispatch(self, datas, label) -> torch.Tensor:
        """The forward, backward and update of one step on placed inputs
        -> the device loss."""
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
        with torch.no_grad():
            if not scaled:
                self._update(grads)
            else:
                finite = _ls.grads_finite([g.float() for g in grads])
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
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads))) * abs(rescale)
            scale = torch.clamp(self.clip_global_norm / (norm + 1e-12),
                                max=1.0) * rescale
        return grad_terms_(grads, w, scale, self._clip,
                           [self._wd * m for m in self._wd_mults])

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
