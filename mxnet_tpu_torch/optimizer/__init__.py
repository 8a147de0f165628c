"""The optimizer package: the optimizer classes and their updaters
(``optimizer``), the fused multi-tensor updater (``fused``) and the lr
schedulers (``lr_scheduler``), as in ``mxnet_tpu/optimizer/``."""
from .optimizer import *  # noqa: F401,F403
from .optimizer import Optimizer, Updater, create, get_updater, register
from .fused import FusedUpdater, fused_enabled
from . import lr_scheduler

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "Adamax", "Nadam", "AdaGrad",
           "AdaDelta", "RMSProp", "Ftrl", "Signum", "LAMB", "Updater",
           "get_updater", "register", "create", "FusedUpdater",
           "fused_enabled", "lr_scheduler"]
