"""The recurrent language model of MXNet's
``example/gluon/word_language_model`` (``RNNModel``), from the port's
Gluon blocks: ``nn.Embedding`` -> ``nn.Dropout`` -> ``gluon.rnn.LSTM``
(or ``GRU`` / ``RNN``) -> ``nn.Dropout`` -> ``nn.Dense`` over the
vocabulary, untied.

``lstm_lm_medium`` is the "medium" configuration of Zaremba, Sutskever &
Vinyals (2014), *Recurrent Neural Network Regularization*, as the
example runs it (``--emsize 650 --nhid 650 --dropout 0.5``): vocabulary
10,000, embedding 650, two LSTM layers of 650, dropout 0.5, 19.8 M
parameters.  The model's forward takes (T, N) token ids and the carried
state list and returns ((T * N, vocab) logits, new state list); training
detaches the state between batches (truncated backpropagation through
time).
"""
from __future__ import annotations

from ..base import MXNetError
from ..gluon import nn, rnn
from ..gluon.block import HybridBlock

__all__ = ["RNNModel", "lstm_lm_medium"]

_LAYERS = {"lstm": lambda h, n, p, i: rnn.LSTM(h, n, dropout=p,
                                                input_size=i),
           "gru": lambda h, n, p, i: rnn.GRU(h, n, dropout=p, input_size=i),
           "rnn_tanh": lambda h, n, p, i: rnn.RNN(h, n, "tanh", dropout=p,
                                                  input_size=i),
           "rnn_relu": lambda h, n, p, i: rnn.RNN(h, n, "relu", dropout=p,
                                                  input_size=i)}


class RNNModel(HybridBlock):
    """Embedding, dropout, a fused recurrent layer, dropout, a dense
    decoder (``mode`` lstm, gru, rnn_tanh or rnn_relu)."""

    def __init__(self, mode="lstm", vocab_size=10000, num_embed=650,
                 num_hidden=650, num_layers=2, dropout=0.5,
                 tie_weights=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if tie_weights:
            raise MXNetError("RNNModel: tied weights are not ported")
        self.num_hidden = num_hidden
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, num_embed)
            self.rnn = _LAYERS[mode](num_hidden, num_layers, dropout,
                                     num_embed)
            self.decoder = nn.Dense(vocab_size, in_units=num_hidden)

    def begin_state(self, *args, **kwargs):
        return self.rnn.begin_state(*args, **kwargs)

    def forward(self, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        return self.decoder(output.reshape(-1, self.num_hidden)), hidden


def lstm_lm_medium(**kwargs) -> RNNModel:
    """The medium LSTM language model (vocabulary 10,000, 2 x 650,
    dropout 0.5), uninitialized: ``initialize(init.Uniform(0.05), ctx=)``
    gives Zaremba et al.'s weights."""
    cfg = dict(mode="lstm", vocab_size=10000, num_embed=650, num_hidden=650,
               num_layers=2, dropout=0.5)
    cfg.update(kwargs)
    return RNNModel(**cfg)
