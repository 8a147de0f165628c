"""Models of the port (Gluon blocks, which are ``torch.nn`` modules), under
the names ``mxnet_tpu/models/__init__.py`` exports (its pipelined BERT,
``bert_pp``, waits for multi-GPU, ROADMAP A.9), and the word language
model of MXNet's Gluon example (``word_lm``)."""
from . import transformer
from . import bert
from . import ssd
from . import faster_rcnn
from .bert import BERTModel, BERTForMLM, bert_base, bert_small
from .faster_rcnn import FasterRCNN, FasterRCNNTrainLoss, faster_rcnn_small
from .ssd import SSD, SSDTrainLoss, ssd_300
from .transformer import (TransformerEncoder, MultiHeadAttention,
                          Transformer, TransformerDecoder, transformer_base,
                          transformer_big, label_smoothed_ce)
from .word_lm import RNNModel, lstm_lm_medium

__all__ = ["transformer", "bert", "ssd", "faster_rcnn", "BERTModel",
           "BERTForMLM", "bert_base", "bert_small", "FasterRCNN",
           "FasterRCNNTrainLoss", "faster_rcnn_small", "SSD", "SSDTrainLoss",
           "ssd_300", "TransformerEncoder", "MultiHeadAttention",
           "Transformer", "TransformerDecoder", "transformer_base",
           "transformer_big", "label_smoothed_ce", "RNNModel",
           "lstm_lm_medium"]
