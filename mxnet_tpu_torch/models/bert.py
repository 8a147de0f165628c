"""BERT and its masked-LM head, as ``torch.nn`` modules.

Counterpart of ``mxnet_tpu/models/bert.py`` (BASELINE config 3, BERT-base
MLM pretraining): word, token-type and learned positional embeddings, an
embedding LayerNorm, the post-LN ``TransformerEncoder`` with exact-erf
GELU, a tanh pooler over the first position, and the MLM head
``decoder(mlm_ln(gelu(mlm_dense(seq))))`` with an untied decoder.  Every
LayerNorm runs kernel K1; with no ``valid_length`` and attention dropout
inactive, every attention runs kernels K3-K5 (``flash_attention``), and
with a ``valid_length`` the masked dense path, as in the JAX package.

Parameter names follow Gluon's through ``convert.from_mxnet_tpu_params``
(``BERTForMLM.gluon_segments``).  The tensor-parallel sharding rules of
the JAX module are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..context import resolve_device
from ..gluon.nn import LayerNorm
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
        elif isinstance(m, nn.Linear):
            nn.init.normal_(m.weight, 0.0, sigma, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.Embedding, PositionalEmbedding)):
            nn.init.normal_(m.weight, 0.0, sigma, generator=generator)


class BERTModel(nn.Module):
    """forward(inputs, token_types=None, valid_length=None) ->
    (sequence output (B, T, units), pooled (B, units))."""

    def __init__(self, vocab_size: int = 30522, units: int = 768,
                 hidden_size: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, max_length: int = 512,
                 type_vocab: int = 2, dropout: float = 0.1):
        super().__init__()
        self.word_embed = nn.Embedding(vocab_size, units)
        self.token_type_embed = nn.Embedding(type_vocab, units)
        self.pos_embed = PositionalEmbedding(max_length, units)
        self.embed_ln = LayerNorm(units)
        self.embed_drop = nn.Dropout(dropout)
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout, "gelu")
        self.pooler = nn.Linear(units, units)

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


class BERTForMLM(nn.Module):
    """BERT with the masked-LM head: forward(inputs, token_types=None,
    valid_length=None) -> logits (B, T, vocab).

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; a
    fresh unseeded one when None) on the CPU as ``mx.init.Normal(0.02)``
    draws them, then moved to ``device`` (default:
    :func:`context.default_device`)."""

    # module path segment -> Gluon prefix (convert.from_mxnet_tpu_params)
    gluon_segments = {"token_type_embed": "type_embed", "ffn_1": "ffn1",
                      "ffn_2": "ffn2"}

    def __init__(self, vocab_size: int = 30522, units: int = 768,
                 hidden_size: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, max_length: int = 512,
                 dropout: float = 0.1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.bert = BERTModel(vocab_size, units, hidden_size, num_layers,
                              num_heads, max_length, dropout=dropout)
        self.mlm_dense = nn.Linear(units, units)
        self.mlm_ln = LayerNorm(units)
        self.decoder = nn.Linear(units, vocab_size)
        _init_normal(self, generator)
        self.to(device)

    def forward(self, inputs, token_types=None, valid_length=None):
        seq, _ = self.bert(inputs, token_types, valid_length)
        h = self.mlm_ln(F.gelu(self.mlm_dense(seq), approximate="none"))
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
