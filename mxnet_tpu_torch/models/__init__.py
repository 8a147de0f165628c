"""Models of the port (Gluon blocks, which are ``torch.nn`` modules); the
detectors under the JAX package's names."""
from .ssd import SSD, SSDTrainLoss, ssd_300
from .faster_rcnn import FasterRCNN, FasterRCNNTrainLoss, faster_rcnn_small

__all__ = ["SSD", "SSDTrainLoss", "ssd_300", "FasterRCNN",
           "FasterRCNNTrainLoss", "faster_rcnn_small"]
