"""Vision datasets and transforms, as ``mxnet_tpu/gluon/data/vision/``
exports them."""
from . import transforms
from .datasets import MNIST, FashionMNIST, CIFAR10, CIFAR100, ImageRecordDataset
