"""The legacy ``mx.rnn`` API (counterpart of ``mxnet_tpu/rnn/``): the
symbolic RNN cells, the bucketing sentence iterator and the RNN
checkpoints.  The cells compose registry ops, so they work with both the
``mx.sym`` and the ``mx.nd`` spelling; an unrolled graph runs through the
symbolic executor, and ``FusedRNNCell`` through the ``RNN`` op (cuDNN's
recurrence on the card).
"""
from .rnn_cell import (BaseRNNCell, RNNParams, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       ModifierCell, DropoutCell, ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)

__all__ = ["BaseRNNCell", "RNNParams", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BucketSentenceIter", "encode_sentences", "save_rnn_checkpoint",
           "load_rnn_checkpoint", "do_rnn_checkpoint"]
