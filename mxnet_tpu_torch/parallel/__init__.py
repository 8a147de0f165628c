"""The fused training step on one device, its lazy loss handles and the
bounded in-flight window (counterparts of the JAX package's names)."""
from .async_loss import (AsyncLoss, InflightRing, StepFence, drain_all,
                         inflight_limit)
from .data_parallel import DataParallelStep

__all__ = ["AsyncLoss", "InflightRing", "StepFence", "drain_all",
           "inflight_limit", "DataParallelStep"]
