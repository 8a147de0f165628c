"""``gluon.contrib``: the contrib layers (``nn``), the contrib recurrent
cells (``rnn``) and the ``Estimator`` with its event handlers
(``estimator``), as in ``mxnet_tpu/gluon/contrib/``."""
from . import nn
from . import rnn
from . import estimator

__all__ = ["nn", "rnn", "estimator"]
