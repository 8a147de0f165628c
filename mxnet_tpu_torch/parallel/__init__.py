"""The fused training step on one device and its lazy loss handle."""
from .async_loss import AsyncLoss
from .data_parallel import DataParallelStep

__all__ = ["AsyncLoss", "DataParallelStep"]
