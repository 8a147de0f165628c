"""BERT and its masked-LM head, as ``torch.nn`` modules.

Counterpart of ``mxnet_tpu/models/bert.py`` (BASELINE config 3, BERT-base
MLM pretraining): word, token-type and learned positional embeddings, an
embedding LayerNorm, the post-LN ``TransformerEncoder`` with exact-erf
GELU, a tanh pooler over the first position, and the MLM head
``decoder(mlm_ln(gelu(mlm_dense(seq))))`` with an untied decoder.  Every
LayerNorm runs kernel K1; with no ``valid_length`` and attention dropout
inactive, every attention runs kernels K3-K5 (``flash_attention``), and
with a ``valid_length`` the masked dense path, as in the JAX package.

``BERTForMLM`` and ``BERTModel`` have ``hybrid_forward(F, ...)``, the
JAX blocks' bodies, so ``export`` writes the JAX package's BERT graph
(``mx.mod.Module`` trains it; every LayerNorm node runs K1 and every
fused attention node K3-K5 on the card; at a dropout above 0 the graph
holds ``Dropout`` nodes, the identity outside training).  With a
``valid_length`` the JAX body reads ``inputs.shape``, which a Symbol
lacks, so such a call traces no graph in either package.

The blocks are Gluon ``HybridBlock``s made in the JAX classes' name
scopes with their prefixes, so ``collect_params()`` gives the JAX net's
names (``bertformlm0_bert_encoder_layer0_attn_qkv_weight``), which
``convert.from_mxnet_tpu_params`` maps.  The tensor-parallel sharding rules of
the JAX module are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from .transformer import PositionalEmbedding, TransformerEncoder

__all__ = ["BERTModel", "BERTForMLM", "bert_base", "bert_small"]


@torch.no_grad()
def _init_normal(module: nn.Module, generator: Optional[torch.Generator],
                 sigma: float = 0.02) -> None:
    """``mx.init.Normal(0.02)``: weights and embedding tables from
    N(0, sigma), biases 0, LayerNorm scales 1 and shifts 0."""
    for m in module.modules():
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Dense):
            nn.init.normal_(m.weight, 0.0, sigma, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (Embedding, PositionalEmbedding)):
            nn.init.normal_(m.weight, 0.0, sigma, generator=generator)


class BERTModel(HybridBlock):
    """forward(inputs, token_types=None, valid_length=None) ->
    (sequence output (B, T, units), pooled (B, units))."""

    def __init__(self, vocab_size: int = 30522, units: int = 768,
                 hidden_size: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, max_length: int = 512,
                 type_vocab: int = 2, dropout: float = 0.1, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units,
                                        prefix="word_embed_")
            self.token_type_embed = Embedding(type_vocab, units,
                                              prefix="type_embed_")
            self.pos_embed = PositionalEmbedding(max_length, units,
                                                 prefix="pos_embed_")
            self.embed_ln = LayerNorm(units, prefix="embed_ln_")
            self.embed_drop = Dropout(dropout)
            self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                              num_heads, dropout, "gelu",
                                              prefix="encoder_")
            self.pooler = Dense(units, flatten=False, in_units=units,
                                prefix="pooler_")

    def forward(self, inputs, token_types=None, valid_length=None):
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_drop(self.embed_ln(self.pos_embed(x)))
        mask = None
        if valid_length is not None:
            steps = torch.arange(inputs.shape[1], device=inputs.device)
            keep = steps[None, :] < valid_length.reshape(-1, 1)
            mask = keep[:, :, None] & keep[:, None, :]       # (B, T, T)
        out = self.encoder(x, mask)
        return out, torch.tanh(self.pooler(out[:, 0]))

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None):
        if valid_length is not None:
            # the JAX body reads the input's length, which a Symbol has
            # not: a valid_length traces no graph there, nor here
            raise AttributeError(
                "BERTModel with a valid_length reads the input's shape, "
                "which a Symbol has not (as the JAX block does)")
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_drop(self.embed_ln(self.pos_embed(x)))
        out = self.encoder(x, None)
        first = F.Reshape(F.slice_axis(out, axis=1, begin=0, end=1),
                          shape=(0, -1))
        return out, F.Activation(self.pooler(first), act_type="tanh")


class BERTForMLM(HybridBlock):
    """BERT with the masked-LM head: forward(inputs, token_types=None,
    valid_length=None) -> logits (B, T, vocab).

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; a
    fresh unseeded one when None) on the CPU as ``mx.init.Normal(0.02)``
    draws them, then moved to ``device`` (default:
    :func:`context.default_device`).  With ``init_weights=False`` nothing
    is drawn or moved: the Gluon Parameters wait for
    ``initialize(init, ctx)``, as the JAX net's do."""


    def __init__(self, vocab_size: int = 30522, units: int = 768,
                 hidden_size: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, max_length: int = 512,
                 dropout: float = 0.1, device=None,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.bert = BERTModel(vocab_size, units, hidden_size, num_layers,
                                  num_heads, max_length, dropout=dropout,
                                  prefix="bert_")
            self.mlm_dense = Dense(units, flatten=False, in_units=units,
                                   prefix="mlm_dense_")
            self.mlm_ln = LayerNorm(units, prefix="mlm_ln_")
            self.decoder = Dense(vocab_size, flatten=False, in_units=units,
                                 prefix="decoder_")
        if init_weights:
            device = resolve_device(device)
            _init_normal(self, generator)
            self.to(device)
            self._mark_initialized()

    def forward(self, inputs, token_types=None, valid_length=None):
        seq, _ = self.bert(inputs, token_types, valid_length)
        h = self.mlm_ln(F.gelu(self.mlm_dense(seq), approximate="none"))
        return self.decoder(h)

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None):
        seq, _ = self.bert(inputs, token_types, valid_length)
        h = self.mlm_ln(F.LeakyReLU(self.mlm_dense(seq), act_type="gelu"))
        return self.decoder(h)


def bert_base(vocab_size: int = 30522, **kwargs) -> BERTForMLM:
    """BERT-base (BASELINE config 3): 12 layers, 768/3072, 12 heads."""
    return BERTForMLM(vocab_size=vocab_size, units=768, hidden_size=3072,
                      num_layers=12, num_heads=12, **kwargs)


def bert_small(vocab_size: int = 512, units: int = 64, hidden_size: int = 128,
               num_layers: int = 2, num_heads: int = 4, max_length: int = 64,
               **kwargs) -> BERTForMLM:
    """The JAX package's tiny configuration for dry runs and tests."""
    return BERTForMLM(vocab_size=vocab_size, units=units,
                      hidden_size=hidden_size, num_layers=num_layers,
                      num_heads=num_heads, max_length=max_length, **kwargs)
