"""Gluon data API, as ``mxnet_tpu/gluon/data/`` exports it."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader, default_batchify_fn
from . import vision
