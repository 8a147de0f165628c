"""Gluon's recurrent layers and cells, as in ``mxnet_tpu/gluon/rnn/``:
the fused ``RNN`` / ``LSTM`` / ``GRU`` layers over the ``_fused_rnn`` op
(``rnn_layer``) and the step cells with ``unroll`` (``rnn_cell``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, LSTMCell, RecurrentCell,
                       ResidualCell, RNNCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell", "RNN", "LSTM", "GRU"]
