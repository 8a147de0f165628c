"""The ``mx.mod`` namespace (counterpart of ``mxnet_tpu/module/``)."""
from .base_module import BaseModule, BatchEndParam
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "BatchEndParam", "Module", "BucketingModule"]
