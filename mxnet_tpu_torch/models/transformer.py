"""Transformer building blocks and the seq2seq Transformer, as
``torch.nn`` modules.

Counterpart of ``mxnet_tpu/models/transformer.py`` (BASELINE config 4,
Transformer-big WMT14): the same layouts (``_split_heads`` to
(B * H, T, hd)), the same masking constants (-1e9 in f32, -3e4 in 16-bit
types), the ``sqrt(units)`` embedding scale, post-LN layers and the tied
output projection.  Every LayerNorm runs kernel K1
(``gluon.nn.LayerNorm``); the decoder's incremental ``step`` attends
through a step-cache object, which for the serving engine is
``serving.paged_cache.PagedStepCache`` (kernel K2).
``Transformer.translate`` is the JAX method's beam search over the paged
KV cache (kernels K1 and K2 in every decode body), and
:class:`DenseStepCache` the dense per-layer cache it is checked against.
``MultiHeadAttention`` routes as the JAX class does: with no mask and
attention dropout inactive (rate 0, or not training) it calls
``ops.kernels.flash_attention`` (kernels K3-K5); otherwise it takes the
dense masked attention, which stays plain torch, as the JAX package leaves
it to XLA, and so does cross-attention.

The blocks are Gluon ``HybridBlock``s made in the JAX classes' name
scopes with their prefixes, so ``collect_params()`` gives the JAX net's
names, which ``convert.from_mxnet_tpu_params`` maps.  Gluon's ``Dense(flatten=False)`` is ``gluon.nn.Dense`` with its
input width given (``torch.nn.functional.linear``; weight (out, in) in
both).  The feed-forward activation is ``"gelu"`` (exact
erf, the JAX ``LeakyReLU(act_type="gelu")``) or one of the ``Activation``
op's (``"relu"``, ``"sigmoid"``, ``"tanh"``, ``"softrelu"``,
``"softsign"``); the defaults are the JAX classes' (gelu in the encoder,
relu in the decoder and in ``Transformer``, the WMT recipe's).  The cells,
and the encoder and decoder, are post-LN unless built with
``pre_norm=True`` (the deep-net variant, the same branches as the JAX
cells); ``Transformer`` builds them post-LN, as the JAX class does
(switch a cell's ``pre_norm`` attribute for the other branch).
``Transformer(tie_embeddings=False)``
projects to the vocabulary through its own ``out_proj`` (Gluon prefix
``out_``) instead of the shared embedding.

Every block also has ``hybrid_forward(F, ...)``, the JAX block's body
over ``F.<op>``, through which a block called with Symbols writes the JAX
package's graph (``export``), node for node: the fused attention as
``_contrib_flash_attention`` (kernels K3-K5 when the graph runs on the
card), the LayerNorms as ``LayerNorm`` ops (kernel K1), and the dense
attention (a mask, or attention dropout while ``autograd`` is training) as
``batch_dot`` / scale / ``softmax`` / ``Dropout`` / ``batch_dot``, with
the causal rule built from ops (``ones_like``, ``linalg_makediag``,
``cumsum``, ``broadcast_like``, ``where``) and the masks at -3e4 (a graph
carries no dtype; -3e4 is exactly 0 after an f32 softmax and stays finite
in a 16-bit export).

Under a step whose rules cut their weights over ``tp``
(``models.bert.bert_sharding_rules``), ``MultiHeadAttention`` and
``PositionwiseFFN`` run Megatron's pattern (``_SHARD_FORMS``,
``parallel.tensor_parallel``): ``qkv`` and ``ffn1`` column-parallel (the
attention on this rank's H/tp heads), ``proj`` and ``ffn2`` row-parallel
with the bias added once, after the all-reduce.

:func:`label_smoothed_ce` is the training loss of BASELINE config 4
(``bench.py:706-751``), with the JAX function's roundings.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import autograd as _autograd
from .. import profiler as _profiler
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.loss import log_softmax
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..ops.contrib_ops import sp_attention as _sp_attention
from ..parallel.ring import gather_sequence as _gather_sequence
from ..parallel.scope import global_count as _global_count
from ..parallel.scope import ring_scope as _ring_scope
from ..parallel.scope import seq_offset as _seq_offset
from ..parallel import tensor_parallel as _tp
from ..ops.kernels import flash_attention
from ..ops.nn import activation as _activation_op
from ..precision import runtime as _prec
from ..symbol.symbol import Symbol

__all__ = ["MultiHeadAttention", "MultiHeadCrossAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder",
           "PositionalEmbedding", "TransformerDecoderCell",
           "TransformerDecoder", "DenseStepCache", "Transformer",
           "transformer_base", "transformer_big", "label_smoothed_ce"]

# the fused attention is a profiler site of the registry op it stands for
# (``flash_attention`` looked up at each call)
_flash_site = _profiler.op_site(
    "_contrib_flash_attention",
    lambda *args, **kwargs: _fused_attention(*args, **kwargs))


def _fused_attention(q, k, v, causal=False, sm_scale=None):
    """K3-K5, or the sequence-parallel route of a step's scope
    (``ops.contrib_ops.sp_attention``)."""
    routed = _sp_attention(q, k, v, causal, 1.0 / math.sqrt(q.shape[-1])
                           if sm_scale is None else sm_scale)
    if routed is not None:
        return routed
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def _split_heads(t, num_heads: int, head_dim: int):
    # (B, T, C) -> (B*H, T, hd)
    B, T, _ = t.shape
    t = t.reshape(B, T, num_heads, head_dim).transpose(1, 2)
    return t.reshape(B * num_heads, T, head_dim)


def _merge_heads(t, num_heads: int):
    # (B*H, T, hd) -> (B, T, C)
    BH, T, hd = t.shape
    t = t.reshape(BH // num_heads, num_heads, T, hd).transpose(1, 2)
    return t.reshape(BH // num_heads, T, num_heads * hd)


def _graph_split_heads(F, t, num_heads: int, head_dim: int):
    # (B, T, C) -> (B*H, T, hd) in MXNet's reshape codes (the JAX
    # ``_split_heads``)
    t = F.Reshape(t, shape=(0, 0, -4, num_heads, head_dim))
    t = F.transpose(t, axes=(0, 2, 1, 3))
    return F.Reshape(t, shape=(-3, 0, 0))


def _graph_merge_heads(F, t, num_heads: int):
    # (B*H, T, hd) -> (B, T, C)
    t = F.Reshape(t, shape=(-4, -1, num_heads, 0, 0))
    return F.Reshape(F.transpose(t, axes=(0, 2, 1, 3)), shape=(0, 0, -3))


def _big_neg(dtype) -> float:
    # -1e9 in f32; the half-safe -3e4 in 16-bit types, where -1e9 would
    # overflow to -inf
    return -3e4 if dtype in (torch.float16, torch.bfloat16) else -1e9


def _graph_mask_scores(F, scores, mask, num_heads: int):
    """``_mask_scores`` over ``F`` ops (the JAX function): -3e4 in a
    Symbol trace, which carries no dtype."""
    big_neg = (-3e4 if isinstance(scores, Symbol)
               else _big_neg(scores.dtype))
    m = F.broadcast_like(F.expand_dims(mask, axis=1),
                         F.Reshape(scores, shape=(-4, -1, num_heads, 0, 0)),
                         lhs_axes=(1,), rhs_axes=(1,))
    m = F.Reshape(m, shape=(-3, 0, 0))
    return F.where(m, scores, F.ones_like(scores) * big_neg)


def _graph_causal(F, scores):
    """The causal rule over ``F`` ops: in a Symbol trace (no host-side T)
    the tril keep-mask is ``cumsum(identity, axis=0)`` (1 iff i >= j) and
    masked scores take -3e4; on tensors the host-built triu addend in the
    scores' type, as the JAX eager path adds it."""
    if not isinstance(scores, Symbol):
        T = scores.shape[-1]
        addend = torch.triu(torch.full((T, T), _big_neg(scores.dtype),
                                       dtype=scores.dtype,
                                       device=scores.device), diagonal=1)
        return F.broadcast_add(scores, addend[None])
    ones_k = F.Reshape(
        F.slice_axis(F.slice_axis(F.ones_like(scores), axis=0, begin=0,
                                  end=1), axis=1, begin=0, end=1),
        shape=(-1,))
    keep = F.cumsum(F.linalg_makediag(ones_k), axis=0)
    keep = F.broadcast_like(F.expand_dims(keep, axis=0), scores,
                            lhs_axes=(0,), rhs_axes=(0,))
    return F.where(keep, scores, F.ones_like(scores) * -3e4)


def _graph_attention(F, q, k, v, head_dim: int, num_heads: int, mask,
                     causal: bool, drop):
    """The dense attention over ``F`` ops, (B*H, T, hd) in and out."""
    scores = F.batch_dot(q, k, transpose_b=True) / math.sqrt(head_dim)
    if causal:
        scores = _graph_causal(F, scores)
    if mask is not None:
        scores = _graph_mask_scores(F, scores, mask, num_heads)
    return F.batch_dot(drop(F.softmax(scores, axis=-1)), v)


def _mask_scores(scores, mask, num_heads: int):
    """mask: (B, Tq, Tk), nonzero = keep, broadcast over the heads of the
    (B*H, Tq, Tk) scores; masked-out positions take the big negative."""
    B, Tq, Tk = mask.shape
    m = (mask != 0)[:, None].expand(B, num_heads, Tq, Tk)
    return torch.where(m.reshape(B * num_heads, Tq, Tk), scores,
                       torch.full_like(scores, _big_neg(scores.dtype)))


def _attention(q, k, v, head_dim: int, num_heads: int, mask=None,
               causal: bool = False, drop=None):
    """softmax(q k^T / sqrt(hd) [+ causal] [masked]) v over (B*H, T, hd);
    the two products are ``batch_dot`` and the softmax ``softmax`` of the
    AMP policy."""
    q_off = 0
    scope = _ring_scope()
    if scope is not None:
        # a sequence-parallel rank holds L/sp queries and keys: attend to
        # the keys of the whole slice (K, V and the mask's key axis
        # gathered over sp), causal from this rank's offset
        k, v = (_gather_sequence(t, scope[0]) for t in (k, v))
        if mask is not None:
            mask = _gather_sequence(
                mask.transpose(1, 2).to(torch.uint8), scope[0]
            ).transpose(1, 2)
        q_off = _seq_offset(q.shape[1])
    q, k = _prec.cast_inputs("batch_dot", q, k)
    scores = torch.bmm(q, k.transpose(1, 2)) / math.sqrt(head_dim)
    if causal:
        Tq, Tk = scores.shape[-2:]
        qpos = q_off + torch.arange(Tq, device=scores.device)[:, None]
        kpos = torch.arange(Tk, device=scores.device)[None, :]
        addend = torch.where(
            kpos > qpos, torch.tensor(_big_neg(scores.dtype),
                                      dtype=scores.dtype,
                                      device=scores.device),
            torch.zeros((), dtype=scores.dtype, device=scores.device))
        scores = scores + addend[None]
    if mask is not None:
        scores = _mask_scores(scores, mask, num_heads)
    scores, = _prec.cast_inputs("softmax", scores)
    attn = torch.softmax(scores, dim=-1)
    if drop is not None:
        attn = drop(attn)
    attn, v = _prec.cast_inputs("batch_dot", attn, v)
    return torch.bmm(attn, v)


def _linear(units: int, in_units: int, prefix: str,
            use_bias: bool = True) -> Dense:
    return Dense(units, flatten=False, use_bias=use_bias, in_units=in_units,
                 prefix=prefix)


class MultiHeadAttention(HybridBlock):
    """Self attention with a fused qkv projection, weight (3*units, in);
    ``use_bias=False`` gives its projections no bias Parameter."""

    def __init__(self, units: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = True, causal: bool = False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads != 0:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.head_dim = units // num_heads
        self.causal = causal
        with self.name_scope():
            self.qkv = _linear(3 * units, units, "qkv_", use_bias)
            self.proj = _linear(units, units, "proj_", use_bias)
            self.attn_drop = Dropout(dropout)

    # Megatron's attention: qkv column-parallel (this rank's heads of q,
    # k and v), proj row-parallel
    _SHARD_FORMS = {"qkv.weight": ((("tp", None),), 3),
                    "qkv.bias": ((("tp",),), 3),
                    "proj.weight": (((None, "tp"),), 1)}

    def forward(self, x, mask=None):
        H, hd = self.num_heads, self.head_dim
        tp = _tp.shard_of(self.qkv.weight) is not None
        if tp:  # this rank's H / tp heads
            H //= _tp.tp_size()
            q, k, v = _tp.column_parallel(self.qkv, x).chunk(3, dim=-1)
        else:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        q, k, v = (_split_heads(t, H, hd) for t in (q, k, v))
        if mask is None and (self.attn_drop.rate == 0.0
                             or not self.training):
            # the fused path of the JAX class
            # (mxnet_tpu/models/transformer.py:91): taken only when
            # attention-prob dropout is inactive, so it computes what the
            # dense path does
            q, k, v = _prec.cast_inputs("_contrib_flash_attention", q, k, v)
            out = _flash_site(q, k, v, causal=self.causal)
        else:
            out = _attention(q, k, v, hd, H, mask, self.causal,
                             self.attn_drop)
        if _tp.shard_of(self.proj.weight) is not None:
            return _tp.row_parallel(self.proj, _merge_heads(out, H))
        return self.proj(_merge_heads(out, H))

    def hybrid_forward(self, F, x, mask=None):
        # the route as the JAX block picks it, by autograd's flag
        q, k, v = F.split(self.qkv(x), num_outputs=3, axis=-1)
        q, k, v = (_graph_split_heads(F, t, self.num_heads, self.head_dim)
                   for t in (q, k, v))
        if mask is None and (self.attn_drop.rate == 0.0
                             or not _autograd.is_training()):
            out = F._contrib_flash_attention(q, k, v, causal=self.causal)
        else:
            out = _graph_attention(F, q, k, v, self.head_dim,
                                   self.num_heads, mask, self.causal,
                                   self.attn_drop)
        return self.proj(_graph_merge_heads(F, out, self.num_heads))


_ACTIVATIONS = {"gelu": lambda h: F.gelu(h, approximate="none"),
                **{a: (lambda h, a=a: _activation_op(h, a))
                   for a in ("relu", "sigmoid", "tanh", "softrelu",
                             "softsign")}}


class PositionwiseFFN(HybridBlock):
    def __init__(self, units: int, hidden_size: int, dropout: float = 0.0,
                 activation: str = "gelu", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if activation not in _ACTIVATIONS:
            raise MXNetError(f"activation must be one of "
                             f"{sorted(_ACTIVATIONS)}, got {activation!r}")
        self.act = _ACTIVATIONS[activation]
        self.activation = activation
        with self.name_scope():
            self.ffn_1 = _linear(hidden_size, units, "ffn1_")
            self.ffn_2 = _linear(units, hidden_size, "ffn2_")
            self.drop = Dropout(dropout)

    # Megatron's feed-forward: ffn1 column-parallel, ffn2 row-parallel
    _SHARD_FORMS = {"ffn_1.weight": ((("tp", None),), 1),
                    "ffn_1.bias": ((("tp",),), 1),
                    "ffn_2.weight": (((None, "tp"),), 1)}

    def forward(self, x):
        h = (_tp.column_parallel(self.ffn_1, x)
             if _tp.shard_of(self.ffn_1.weight) is not None
             else self.ffn_1(x))
        h = self.act(h)
        h = (_tp.row_parallel(self.ffn_2, h)
             if _tp.shard_of(self.ffn_2.weight) is not None
             else self.ffn_2(h))
        return self.drop(h)

    def hybrid_forward(self, F, x):
        h = self.ffn_1(x)
        h = (F.LeakyReLU(h, act_type="gelu") if self.activation == "gelu"
             else F.Activation(h, act_type=self.activation))
        return self.drop(self.ffn_2(h))


class TransformerEncoderCell(HybridBlock):
    """Post-LN (or, with ``pre_norm``, pre-LN) encoder layer."""

    def __init__(self, units: int, hidden_size: int, num_heads: int,
                 dropout: float = 0.0, activation: str = "gelu",
                 pre_norm: bool = False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.pre_norm = pre_norm
        with self.name_scope():
            self.attn = MultiHeadAttention(units, num_heads, dropout,
                                           prefix="attn_")
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       activation, prefix="ffn_")
            self.ln1 = LayerNorm(units, prefix="ln1_")
            self.ln2 = LayerNorm(units, prefix="ln2_")
            self.drop = Dropout(dropout)

    def forward(self, x, mask=None):
        if self.pre_norm:
            x = x + self.drop(self.attn(self.ln1(x), mask))
            return x + self.ffn(self.ln2(x))
        x = self.ln1(x + self.drop(self.attn(x, mask)))
        return self.ln2(x + self.ffn(x))

    def hybrid_forward(self, F, x, mask=None):
        return self.forward(x, mask)


class PositionalEmbedding(HybridBlock):
    """Learned positional embedding: adds rows [0, T) of ``weight``."""

    def __init__(self, max_length: int, units: int, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.max_length = max_length
        self.weight = nn.Parameter(torch.empty(max_length, units))
        self._gluon_param("weight", shape=(max_length, units))

    def forward(self, x):
        # a sequence-parallel rank holds positions [off, off + T)
        off = _seq_offset(x.shape[1])
        return x + self.weight[off:off + x.shape[1]][None]

    def hybrid_forward(self, F, x, weight):
        pos = F.slice_like(F.expand_dims(weight, axis=0), x, axes=(1,))
        return F.broadcast_add(x, pos)


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers: int, units: int, hidden_size: int,
                 num_heads: int, dropout: float = 0.0,
                 activation: str = "gelu", pre_norm: bool = False,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.layers = nn.ModuleList(
                TransformerEncoderCell(units, hidden_size, num_heads,
                                       dropout, activation, pre_norm,
                                       prefix=f"layer{i}_")
                for i in range(num_layers))

    def forward(self, x, mask=None):
        for cell in self.layers:
            x = cell(x, mask)
        return x

    def hybrid_forward(self, F, x, mask=None):
        return self.forward(x, mask)


class MultiHeadCrossAttention(HybridBlock):
    """Decoder->encoder attention: q from x, k/v from the encoder memory;
    weights q (units, in), kv (2*units, in)."""

    def __init__(self, units: int, num_heads: int, dropout: float = 0.0,
                 use_bias: bool = True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads != 0:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.head_dim = units // num_heads
        with self.name_scope():
            self.q_proj = _linear(units, units, "q_", use_bias)
            self.kv = _linear(2 * units, units, "kv_", use_bias)
            self.proj = _linear(units, units, "proj_", use_bias)
            self.attn_drop = Dropout(dropout)

    def forward(self, x, mem, mask=None):
        # x: (B, Tq, C); mem: (B, Tk, C); mask: (B, Tq, Tk), nonzero = keep
        H, hd = self.num_heads, self.head_dim
        # a memory kept in another type (the serving engine's bf16 state)
        # is promoted to the weights', as jnp promotes bf16 x f32
        mem = mem.to(torch.promote_types(mem.dtype, self.kv.weight.dtype))
        k, v = self.kv(mem).chunk(2, dim=-1)
        out = _attention(_split_heads(self.q_proj(x), H, hd),
                         _split_heads(k, H, hd), _split_heads(v, H, hd),
                         hd, H, mask, drop=self.attn_drop)
        return self.proj(_merge_heads(out, H))

    def hybrid_forward(self, F, x, mem, mask=None):
        H, hd = self.num_heads, self.head_dim
        q = _graph_split_heads(F, self.q_proj(x), H, hd)
        k, v = F.split(self.kv(mem), num_outputs=2, axis=-1)
        out = _graph_attention(F, q, _graph_split_heads(F, k, H, hd),
                               _graph_split_heads(F, v, H, hd), hd, H, mask,
                               False, self.attn_drop)
        return self.proj(_graph_merge_heads(F, out, H))


class TransformerDecoderCell(HybridBlock):
    """Causal self-attention + cross-attention + FFN, post-LN (the WMT
    recipe; ``pre_norm=True`` for the deep-net variant)."""

    def __init__(self, units: int, hidden_size: int, num_heads: int,
                 dropout: float = 0.0, activation: str = "relu",
                 pre_norm: bool = False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.pre_norm = pre_norm
        with self.name_scope():
            self.self_attn = MultiHeadAttention(units, num_heads, dropout,
                                                causal=True, prefix="self_")
            self.cross_attn = MultiHeadCrossAttention(units, num_heads,
                                                      dropout,
                                                      prefix="cross_")
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       activation, prefix="ffn_")
            self.ln1 = LayerNorm(units, prefix="ln1_")
            self.ln2 = LayerNorm(units, prefix="ln2_")
            self.ln3 = LayerNorm(units, prefix="ln3_")
            self.drop = Dropout(dropout)

    def forward(self, x, mem, self_mask=None, cross_mask=None):
        if self.pre_norm:
            x = x + self.drop(self.self_attn(self.ln1(x), self_mask))
            x = x + self.drop(self.cross_attn(self.ln2(x), mem, cross_mask))
            return x + self.ffn(self.ln3(x))
        x = self.ln1(x + self.drop(self.self_attn(x, self_mask)))
        x = self.ln2(x + self.drop(self.cross_attn(x, mem, cross_mask)))
        return self.ln3(x + self.ffn(x))

    def hybrid_forward(self, F, x, mem, self_mask=None, cross_mask=None):
        return self.forward(x, mem, self_mask, cross_mask)

    def step(self, x_t, mem, cross_mask_t, cache):
        """Incremental decode of ONE position with cached self-attention
        K/V.  x_t: (B, 1, C); ``cache`` writes this position's k/v and
        attends the query over every row written so far
        (``update_and_attend``).  Inference only."""
        sa = self.self_attn
        h = self.ln1(x_t) if self.pre_norm else x_t
        q_t, k_t, v_t = sa.qkv(h).chunk(3, dim=-1)
        a = sa.proj(cache.update_and_attend(sa, q_t, k_t, v_t))
        if self.pre_norm:
            x = x_t + a
            x = x + self.cross_attn(self.ln2(x), mem, cross_mask_t)
            return x + self.ffn(self.ln3(x))
        x = self.ln1(x_t + a)
        x = self.ln2(x + self.cross_attn(x, mem, cross_mask_t))
        return self.ln3(x + self.ffn(x))


class TransformerDecoder(HybridBlock):
    def __init__(self, num_layers: int, units: int, hidden_size: int,
                 num_heads: int, dropout: float = 0.0,
                 activation: str = "relu", pre_norm: bool = False,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.layers = nn.ModuleList(
                TransformerDecoderCell(units, hidden_size, num_heads,
                                       dropout, activation, pre_norm,
                                       prefix=f"layer{i}_")
                for i in range(num_layers))

    def forward(self, x, mem, self_mask=None, cross_mask=None):
        for cell in self.layers:
            x = cell(x, mem, self_mask, cross_mask)
        return x

    def hybrid_forward(self, F, x, mem, self_mask=None, cross_mask=None):
        return self.forward(x, mem, self_mask, cross_mask)


def _attend_cached(q_t, K, V, keep, num_heads: int, head_dim: int):
    """One-query attention over a fixed-size cache: q_t (B, 1, C); K/V
    (B, Lmax, C) with valid rows marked by keep (B, Lmax), 1 = attend."""
    q = _split_heads(q_t, num_heads, head_dim)
    k = _split_heads(K, num_heads, head_dim)
    v = _split_heads(V, num_heads, head_dim)
    out = _attention(q, k, v, head_dim, num_heads, mask=keep[:, None])
    return _merge_heads(out, num_heads)


class DenseStepCache:
    """Per-layer dense (B, Lmax, C) K/V decode cache: this position's k/v
    are written in place at the host-known row ``t``, and validity is the
    ``keep`` mask (B, Lmax), 1 = attend.  The reference the paged cache
    is checked against (paged decode == dense decode for the same
    tokens)."""

    def __init__(self, K, V, keep, t):
        self.K, self.V, self.keep = K, V, keep
        self.t = int(t)

    def update_and_attend(self, attn, q_t, k_t, v_t):
        t = self.t
        self.K[:, t:t + 1] = k_t
        self.V[:, t:t + 1] = v_t
        return _attend_cached(q_t, self.K, self.V, self.keep,
                              attn.num_heads, attn.head_dim)


class Transformer(HybridBlock):
    """Encoder-decoder Transformer with a shared source/target embedding
    and, by default, a tied output projection (the WMT14 recipe;
    ``tie_embeddings=False`` gives it an ``out_proj`` of its own).

    forward(src, tgt) -> logits (B, Tt, vocab).  Padding id 0 is masked
    out of both attention directions; decoder self-attention is causal.

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``;
    a fresh unseeded one when None) on the CPU — Xavier-uniform for every
    matrix and embedding table, zero biases, unit LayerNorm scales, as
    the JAX package's ``mx.init.Xavier()`` — then moved to ``device``
    (default: :func:`context.default_device`).  With ``init_weights=False``
    nothing is drawn or moved: the Gluon Parameters wait for
    ``initialize(init, ctx)``, as the JAX net's do."""


    def __init__(self, vocab_size: int, units: int = 512,
                 hidden_size: int = 2048, num_heads: int = 8,
                 num_layers: int = 6, max_length: int = 1024,
                 dropout: float = 0.1, pad_id: int = 0,
                 tie_embeddings: bool = True, activation: str = "relu",
                 device=None,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.units = units
        self.pad_id = pad_id
        self.tie_embeddings = tie_embeddings
        with self.name_scope():
            self.embed = Embedding(vocab_size, units, prefix="embed_")
            self.pos = PositionalEmbedding(max_length, units, prefix="pos_")
            self.enc_drop = Dropout(dropout)
            self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                              num_heads, dropout, activation,
                                              prefix="enc_")
            self.decoder = TransformerDecoder(num_layers, units, hidden_size,
                                              num_heads, dropout, activation,
                                              prefix="dec_")
            if not tie_embeddings:
                self.out_proj = _linear(vocab_size, units, "out_")
        if init_weights:
            device = resolve_device(device)
            self.reset_parameters(generator)
            self.to(device)
            self._mark_initialized()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Dense):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (Embedding, PositionalEmbedding)):
                nn.init.xavier_uniform_(m.weight, generator=generator)

    def _encode_h(self, src):
        """(memory, src_keep): the encoder output and the (B, Ts) bool
        key-padding mask, True = attend."""
        src_keep = src != self.pad_id
        B, Ts = src.shape
        enc_mask = src_keep[:, None, :].expand(B, Ts, Ts)
        mem = self.embed(src) * math.sqrt(self.units)
        mem = self.enc_drop(self.pos(mem))
        return self.encoder(mem, enc_mask), src_keep

    def _logits(self, h):
        if not self.tie_embeddings:
            return self.out_proj(h)
        # tied softmax: logits = h E^T with the shared embedding matrix
        # (the JAX class's FullyConnected)
        h, w = _prec.cast_inputs("FullyConnected", h, self.embed.weight)
        return h @ w.t()

    def _decode_h(self, tgt, mem, src_keep):
        B, Tt = tgt.shape
        cross_mask = src_keep[:, None, :].expand(B, Tt, src_keep.shape[1])
        self_mask = (tgt != self.pad_id)[:, None, :].expand(B, Tt, Tt)
        h = self.embed(tgt) * math.sqrt(self.units)
        h = self.enc_drop(self.pos(h))
        return self._logits(self.decoder(h, mem, self_mask, cross_mask))

    def forward(self, src, tgt):
        mem, src_keep = self._encode_h(src)
        return self._decode_h(tgt, mem, src_keep)

    def hybrid_forward(self, F, src, tgt):
        """The JAX block's body over ``F`` ops (its ``_encode_h`` and
        ``_decode_h``): (B, Tq, Tk) key-padding masks by ``not_equal`` and
        ``broadcast_like``, the tied projection a ``FullyConnected`` on the
        embedding's weight."""
        def pad_mask(keep, like):
            return F.broadcast_like(F.expand_dims(keep, axis=1), like,
                                    lhs_axes=(1,), rhs_axes=(1,))

        src_keep = F.not_equal(src, self.pad_id)
        enc_mask = pad_mask(src_keep, src)
        mem = self.embed(src) * math.sqrt(self.units)
        mem = self.encoder(self.enc_drop(self.pos(mem)), enc_mask)
        cross_mask = pad_mask(src_keep, tgt)
        self_mask = pad_mask(F.not_equal(tgt, self.pad_id), tgt)
        h = self.embed(tgt) * math.sqrt(self.units)
        h = self.decoder(self.enc_drop(self.pos(h)), mem, self_mask,
                         cross_mask)
        if not self.tie_embeddings:
            return self.out_proj(h)
        emb = self.embed._reg_params["weight"]
        w = emb.var() if isinstance(h, Symbol) else self.embed.weight
        return F.FullyConnected(h, w, num_hidden=emb.shape[0], no_bias=True,
                                flatten=False)

    def _decode_step(self, tok_t, pos, mem, src_keep, caches):
        """Logits (B, V) for one decode position using per-layer step
        caches (see ``TransformerDecoderCell.step``).  Inference only.

        ``pos`` holds per-row decode positions, (B,), or (1,) broadcasting
        one position.  A position past the positional table clamps to its
        last row, as the JAX package's gather does (the serving engine
        keeps live positions inside the table)."""
        x = self.embed(tok_t) * math.sqrt(self.units)        # (B, 1, C)
        rows = torch.clamp(pos.long(), 0, self.pos.max_length - 1)
        x = x + self.pos.weight[rows][:, None, :]
        cross_mask_t = src_keep[:, None, :]                   # (B, 1, Ts)
        for cell, cache in zip(self.decoder.layers, caches):
            x = cell.step(x, mem, cross_mask_t, cache)
        return self._logits(x.reshape(x.shape[0], -1))

    @torch.no_grad()
    def translate(self, src, bos_id: int, eos_id: int, max_len: int = 32,
                  beam_size: int = 4, alpha: float = 0.6,
                  incremental: bool = True, sync_every: int = 8,
                  page_size: Optional[int] = None):
        """Beam-search decode (GNMT length penalty), the JAX method's.

        src: (B, Ts) int tensor on the model's device.  Returns (B,
        max_len) numpy int32 of the best hypotheses, bos in column 0 (the
        caller trims at eos).  The encoder runs once and its memory is
        repeated for the ``beam_size`` beams.  With ``incremental`` (the
        default) each step is one decode body over the paged KV cache:
        beam row s owns the contiguous pages [1 + s P, 1 + (s + 1) P)
        (page 0 is the trash page), and a beam reorder gathers whole
        pages over each pool with ``index_select``; ``incremental=False``
        re-decodes the whole padded prefix every step (O(L^2), the
        cross-check path).

        Beam state stays on the device: candidates are chosen by a
        stable descending sort of the flattened (B, K V) scores (ties go
        to the lower index, as ``lax.top_k`` breaks them; finished beams
        extend with pad at cost 0, so ties are ordinary), and the host
        reads one finished count every ``sync_every`` steps (0: never)
        for the early exit, then the final state once."""
        B = src.shape[0]
        K, V = int(beam_size), self.embed.weight.shape[0]
        BK = B * K
        dev = src.device
        pad = self.pad_id
        if max_len > self.pos.max_length:
            raise MXNetError(
                f"max_len {max_len} > positional table "
                f"{self.pos.max_length}; build the model with a larger "
                "max_length")
        mem, src_keep = self._encode_h(src)
        mem = mem.repeat_interleave(K, dim=0)               # (BK, Ts, C)
        src_keep = src_keep.repeat_interleave(K, dim=0)     # (BK, Ts)

        tgt = torch.full((BK, max_len), pad, dtype=torch.int32, device=dev)
        tgt[:, 0] = bos_id
        last_tok = torch.full((BK, 1), bos_id, dtype=torch.int32,
                              device=dev)
        scores = torch.full((B, K), float("-inf"), device=dev)
        scores[:, 0] = 0.0  # only beam 0 is live at t = 0
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        # finished beams extend only with pad, at zero cost
        lp_fin = torch.full((V,), float("-inf"), device=dev)
        lp_fin[pad] = 0.0
        b_off = (torch.arange(B, device=dev) * K)[:, None]
        positions = torch.arange(max_len, dtype=torch.int32, device=dev)
        if incremental:
            from ..serving.paged_cache import (PagedKVCache, PagedStepCache,
                                               page_coords, pages_for)

            sa = self.decoder.layers[0].self_attn
            ps = int(page_size or min(16, max_len))
            P = pages_for(max_len, ps)
            cache = PagedKVCache(len(self.decoder.layers), BK * P + 1, ps,
                                 sa.num_heads, sa.head_dim, device=dev,
                                 dtype=mem.dtype)
            table = (1 + torch.arange(BK * P, dtype=torch.int32,
                                      device=dev)).reshape(BK, P)
            pools = cache.pools
            page_off = torch.arange(P, device=dev)[None, :] + 1
            zero_page = torch.zeros((1,), dtype=torch.int64, device=dev)

        for t in range(1, max_len):
            pos = positions[t - 1:t]
            if incremental:
                pages, rows = page_coords(table, pos, ps)
                lengths = pos.expand(BK) + 1
                caches = [PagedStepCache(kp, vp, table, pages, rows,
                                         lengths) for kp, vp in pools]
                step_logits = self._decode_step(last_tok, pos, mem,
                                                src_keep, caches)
            else:
                step_logits = self._decode_h(tgt, mem, src_keep)[:, t - 1]
            lp = torch.log_softmax(step_logits, dim=-1).reshape(B, K, V)
            lp = torch.where(finished[..., None], lp_fin, lp)
            cand = (scores[..., None] + lp).reshape(B, K * V)
            ordered, order = torch.sort(cand, dim=1, descending=True,
                                        stable=True)
            scores, top = ordered[:, :K], order[:, :K]
            beam_idx = top // V
            tok = (top % V).to(torch.int32)
            if K > 1:
                parent = (b_off + beam_idx).reshape(-1)     # (BK,)
                tgt = tgt.index_select(0, parent)
                finished = finished.reshape(-1).index_select(
                    0, parent).reshape(B, K)
                if incremental:
                    # KV pages follow their beams: gather page contents
                    # over the whole pool (page 0 maps to itself)
                    idx = torch.cat([zero_page, (parent[:, None] * P
                                                 + page_off).reshape(-1)])
                    pools = [(kp.index_select(0, idx),
                              vp.index_select(0, idx)) for kp, vp in pools]
            tgt[:, t] = tok.reshape(-1)
            finished = finished | (tok == eos_id) | (tok == pad)
            last_tok = tok.reshape(BK, 1)
            # early exit: one scalar readback every sync_every steps
            if (sync_every and t % sync_every == 0 and t < max_len - 1
                    and int(finished.sum()) >= BK):
                break
        tgt_np = tgt.cpu().numpy().reshape(B, K, max_len)
        scores_np = scores.float().cpu().numpy()
        # GNMT length penalty: score / ((5 + len) / 6) ** alpha
        lengths_np = (tgt_np != pad).sum(-1)
        penal = ((5.0 + lengths_np) / 6.0) ** alpha
        best = np.argmax(scores_np / penal, axis=1)
        return tgt_np[np.arange(B), best]


def label_smoothed_ce(logits, labels, smoothing: float = 0.1,
                      pad_id: int = 0):
    """Label-smoothed cross entropy over (B, T, V) logits, pad positions
    ignored: the scalar mean over the tokens whose label is not
    ``pad_id`` of ``(1 - s) * nll + s * (-mean log p)``.

    ``mxnet_tpu/models/transformer.py::label_smoothed_ce`` step for step,
    in its dtypes: the log-softmax rounds where ``jax.nn.log_softmax``
    does in the logits' type (``gluon.loss.log_softmax``); the weights
    ``1 - s`` and ``s`` round to that type, as the JAX package's scalar
    operands do; the mean over V accumulates in f32 and rounds to it.
    Labels may arrive as floats (``bench.py:743``): the keep mask is then
    of their type and promotes the loss to it, as ``jnp`` promotes."""
    flat = logits.reshape(-1, logits.shape[-1])
    lab = labels.reshape(-1)
    logp = log_softmax(flat, -1)
    nll = -logp.gather(-1, lab.long().clamp(0, flat.shape[-1] - 1)[:, None])
    smooth = -logp.mean(dim=-1, dtype=torch.float32).to(logp.dtype)
    w_nll, w_smooth = (float(torch.tensor(w, dtype=logp.dtype))
                       for w in (1.0 - smoothing, smoothing))
    loss = w_nll * nll[:, 0] + w_smooth * smooth
    keep = (lab != pad_id).to(lab.dtype)
    # a step over several processes averages their losses: divide by the
    # non-pad count of the whole batch (times the processes), not this
    # process's, so the average is the global loss
    count, world = _global_count(keep.sum())
    loss = (loss * keep).sum() / torch.clamp(count, min=1.0)
    return loss * world if world > 1 else loss


def transformer_base(vocab_size: int, **kwargs) -> Transformer:
    """Transformer-base (WMT14): 6 layers, 512/2048, 8 heads."""
    kwargs.setdefault("dropout", 0.1)
    return Transformer(vocab_size, units=512, hidden_size=2048, num_heads=8,
                       num_layers=6, **kwargs)


def transformer_big(vocab_size: int, **kwargs) -> Transformer:
    """Transformer-big (WMT14, BASELINE config 4): 6 layers, 1024/4096,
    16 heads, dropout 0.3."""
    kwargs.setdefault("dropout", 0.3)
    return Transformer(vocab_size, units=1024, hidden_size=4096,
                       num_heads=16, num_layers=6, **kwargs)
