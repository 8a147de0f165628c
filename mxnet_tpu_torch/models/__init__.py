"""Models of the port (Gluon blocks, which are ``torch.nn`` modules); the
detectors under the JAX package's names, and the word language model of
MXNet's Gluon example (``word_lm``)."""
from .ssd import SSD, SSDTrainLoss, ssd_300
from .faster_rcnn import FasterRCNN, FasterRCNNTrainLoss, faster_rcnn_small
from .word_lm import RNNModel, lstm_lm_medium

__all__ = ["SSD", "SSDTrainLoss", "ssd_300", "FasterRCNN",
           "FasterRCNNTrainLoss", "faster_rcnn_small", "RNNModel",
           "lstm_lm_medium"]
