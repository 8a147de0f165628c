"""The Gluon Estimator API, from ``mxnet_tpu/gluon/contrib/estimator/``."""
from .estimator import Estimator
from .event_handler import (TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                            BatchBegin, BatchEnd, StoppingHandler,
                            MetricHandler, ValidationHandler, LoggingHandler,
                            CheckpointHandler, EarlyStoppingHandler)

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]
