"""Parallelism: the fused training step over a mesh of processes, its
lazy loss handles and in-flight window, the rendezvous and collectives,
meshes, plans and the planner, sharding rules and tensor parallelism, the
GPipe pipeline and the sequence-parallel attention routes (counterparts of
the JAX package's names; one process per card)."""
from .mesh import (make_mesh, local_mesh, device_mesh, host_barrier,
                   global_allreduce)
from .async_loss import (AsyncLoss, InflightRing, StepFence, drain_all,
                         inflight_limit)
from .data_parallel import (DataParallelStep, compile_step_with_plan,
                            make_train_step)
from .plan import (Plan, dp_plan, tensor_parallel_plan, pipeline_plan,
                   ring_plan, ulysses_plan)
from .ring import ring_attention, ring_self_attention
from .ulysses import ulysses_self_attention
from .pipeline import pipeline_apply
from .scope import ring_attention_scope, ring_scope, ring_scope_mesh
from . import dist
from . import pipeline
from . import planner
from . import sharding
from . import tensor_parallel

__all__ = ["AsyncLoss", "InflightRing", "StepFence", "drain_all",
           "inflight_limit", "DataParallelStep", "compile_step_with_plan",
           "make_train_step", "make_mesh", "local_mesh", "device_mesh",
           "host_barrier", "global_allreduce", "Plan", "dp_plan",
           "tensor_parallel_plan", "pipeline_plan", "ring_plan",
           "ulysses_plan", "ring_attention", "ring_self_attention",
           "ulysses_self_attention", "ring_attention_scope", "ring_scope",
           "ring_scope_mesh", "dist", "sharding", "pipeline",
           "pipeline_apply", "planner", "tensor_parallel"]
