"""Pipeline-parallel BERT: a stacked-parameter encoder that runs its layers
through the GPipe schedule of ``parallel/pipeline.py`` over the ``pp``
axis.

Counterpart of ``mxnet_tpu/models/bert_pp.py``, with its names, shapes and
``_TP_DIM`` table.  Every encoder layer shares one body; the L per-layer
tensors are stacked along a leading dimension that a step shards over
``pp`` (each stage owns L/S layers, :func:`bert_pp_sharding_rules`).  Off
the pp mesh the stack runs as a loop over its L layers (the JAX
``lax.scan``); under a step's pipeline scope each process runs its stage's
layers on the strided microbatches ``rows i::m`` of its block of the
batch.  The embedding and the MLM head run on every rank.  The layer body
computes what the JAX ``_layer`` computes (post-LN, exact-erf GELU, the
qkv stack as (L, 3, U, U), eps 1e-5) with the port's ``LayerNormFunction``
(kernel K1 on a card) and ``flash_attention`` (kernels K3-K5, non-causal,
no mask) on their plain versions on the CPU.  With the stack's weights cut
over ``tp`` (Megatron's layout of ``_TP_DIM``), the column-parallel
products take their input through ``copy_to_tp`` and the two row-parallel
ones all-reduce over ``tp``, as the JAX body psums them.

As in the JAX module there is no dropout inside the stacked encoder and no
attention mask.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..ops.kernels import LayerNormFunction, flash_attention
from ..parallel import tensor_parallel as _tp
from ..parallel.scope import pipeline_scope
from ..parallel.sharding import ShardingRules
from .transformer import PositionalEmbedding

__all__ = ["StackedTransformerEncoder", "BERTForMLMPipelined",
           "bert_pp_small", "bert_pp_sharding_rules"]

# Megatron layout of the stacked encoder leaves: which non-layer dim (if
# any) carries the 'tp' shard.  qkv/ffn1 are column-parallel (output dim),
# proj/ffn2 row-parallel (input dim); ln/bias-after-psum replicate.
_TP_DIM = {
    "qkv_weight": 2, "qkv_bias": 2,      # (L, 3, U, U) / (L, 3, U)
    "ffn1_weight": 1, "ffn1_bias": 1,    # (L, H, U) / (L, H)
    "proj_weight": 2,                    # (L, U, U) input dim
    "ffn2_weight": 2,                    # (L, U, H) input dim
}
_NAMES = ("qkv_weight", "qkv_bias", "proj_weight", "proj_bias",
          "ffn1_weight", "ffn1_bias", "ffn2_weight", "ffn2_bias",
          "ln1_gamma", "ln1_beta", "ln2_gamma", "ln2_beta")


def _layer_norm(y, gamma, beta):
    """LayerNorm over the last axis through K1 (``LayerNormFunction``)."""
    u = y.shape[-1]
    return LayerNormFunction.apply(y.reshape(-1, u).contiguous(), gamma,
                                   beta, 1e-5).reshape(y.shape)


def _attention(q, k, v):
    """Non-causal attention over (N, T, hd) through K3-K5."""
    return flash_attention(q, k, v, causal=False)


def _forms(enc):
    """The stack's forms: its layer dim over ``pp`` (or whole), the
    ``_TP_DIM`` dim over ``tp`` (or whole)."""
    out = {}
    for name in _NAMES:
        ndim = getattr(enc, name).dim()
        specs = []
        for lead in ("pp", None):
            specs.append((lead,) + (None,) * (ndim - 1))
            if name in _TP_DIM:
                spec = [lead] + [None] * (ndim - 1)
                spec[_TP_DIM[name]] = "tp"
                specs.append(tuple(spec))
        out[name] = (tuple(specs), 1)
    return out


class StackedTransformerEncoder(HybridBlock):
    """L post-LN encoder layers with stacked (L, ...) parameters.

    Matches ``TransformerEncoderCell`` semantics (post-LN, gelu FFN, fused
    qkv) with dropout 0; see the module docstring."""

    _SHARD_FORMS = _forms

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._L = num_layers
        self._units = units
        self._hidden = hidden_size
        self._heads = num_heads
        self._head_dim = units // num_heads
        L, U, H = num_layers, units, hidden_size
        shapes = {"qkv_weight": (L, 3, U, U), "qkv_bias": (L, 3, U),
                  "proj_weight": (L, U, U), "proj_bias": (L, U),
                  "ffn1_weight": (L, H, U), "ffn1_bias": (L, H),
                  "ffn2_weight": (L, U, H), "ffn2_bias": (L, U),
                  "ln1_gamma": (L, U), "ln1_beta": (L, U),
                  "ln2_gamma": (L, U), "ln2_beta": (L, U)}
        for name in _NAMES:
            setattr(self, name, nn.Parameter(torch.empty(shapes[name])))
            init = ("ones" if name.endswith("gamma") else
                    "zeros" if name.endswith("beta") else None)
            self._gluon_param(name, shape=shapes[name], init=init)

    def stacked(self):
        return {n: getattr(self, n) for n in _NAMES}

    def _tp(self) -> bool:
        """Whether the stack's weights are cut over ``tp`` (size one
        included: its collectives are then the identity)."""
        sh = _tp.shard_of(self.qkv_weight)
        return sh is not None and "tp" in sh.spec

    def _layer(self, p, x, ln=_layer_norm, attention=_attention):
        """One post-LN encoder layer on ``p``, one layer's slice of the
        stack (of this rank's shards under tp); ``ln`` and ``attention``
        default to the kernels' routes."""
        hd = self._head_dim
        tp = self._tp()
        b, t, _ = x.shape
        qw, qb = p["qkv_weight"], p["qkv_bias"]  # (3, Uloc, U), (3, Uloc)
        xin = _tp.copy_to_tp(x) if tp else x
        q, k, v = (F.linear(xin, qw[i], qb[i]) for i in range(3))
        nh = q.shape[-1] // hd  # heads this shard owns (nh/tp)

        def heads(y):  # (B, T, Uloc) -> (B * nh, T, hd)
            return y.reshape(b, t, nh, hd).transpose(1, 2).reshape(
                b * nh, t, hd)

        out = attention(heads(q), heads(k), heads(v))
        out = out.reshape(b, nh, t, hd).transpose(1, 2).reshape(b, t, -1)
        out = F.linear(out, p["proj_weight"])  # row-parallel: partial
        if tp:
            out = _tp.reduce_from_tp(out)
        out = out + p["proj_bias"]
        x = ln(x + out, p["ln1_gamma"], p["ln1_beta"])
        xin = _tp.copy_to_tp(x) if tp else x
        h = F.gelu(F.linear(xin, p["ffn1_weight"], p["ffn1_bias"]),
                   approximate="none")
        h = F.linear(h, p["ffn2_weight"])  # row-parallel: partial
        if tp:
            h = _tp.reduce_from_tp(h)
        h = h + p["ffn2_bias"]
        return ln(x + h, p["ln2_gamma"], p["ln2_beta"])

    def forward(self, x):
        stacked = self.stacked()
        tp = self._tp()
        if tp and self._heads % _tp.tp_size():
            raise MXNetError(f"{self._heads} heads not divisible by "
                             f"tp={_tp.tp_size()}")
        pp = pipeline_scope()
        if pp is None:
            for i in range(self.qkv_weight.shape[0]):
                x = self._layer({k: v[i] for k, v in stacked.items()}, x)
            return x
        from ..parallel.pipeline import pipeline_apply

        mesh, batch_axes, m = pp
        dp_total = 1
        for a in batch_axes:
            dp_total *= mesh.axis_size(a)
        bsz = x.shape[0] * dp_total  # the global batch, as the JAX step's
        if bsz % m:
            raise MXNetError(
                f"batch {bsz} not divisible by pp microbatches {m}")
        if (bsz // m) % dp_total:
            raise MXNetError(
                f"per-microbatch batch {bsz // m} not divisible by the "
                f"data-parallel extent {dp_total} ({batch_axes}); lower "
                f"pp_microbatches or raise the batch size")
        S = mesh.axis_size("pp")
        if self._L % S:
            raise MXNetError(
                f"{self._L} stacked layers not divisible by pp={S} stages")
        sh = _tp.shard_of(self.qkv_weight)
        if sh is None or sh.spec[0] != "pp":
            raise MXNetError(
                "the stacked encoder's layers are not sharded over pp "
                "(bert_pp_sharding_rules): a pipeline over a whole stack on "
                f"every stage is {_tp.A94}")
        # strided microbatches (rows i::m) of this process's block
        xm = x.reshape(x.shape[0] // m, m, *x.shape[1:]).transpose(
            0, 1).contiguous()
        ym = pipeline_apply(mesh, self._layer, stacked, xm,
                            batch_axes=batch_axes, stage_local=True)
        return ym.transpose(0, 1).reshape(x.shape)

    def hybrid_forward(self, F, x, **params):
        return self.forward(x)


class BERTForMLMPipelined(HybridBlock):
    """BERT MLM with the stacked encoder; train with DataParallelStep over
    a mesh whose 'pp' axis is >1 (plus 'dp') and rules from
    bert_pp_sharding_rules().

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``) as
    ``mx.init.Normal(0.02)`` draws them (weights and tables N(0, 0.02),
    biases and LayerNorm shifts 0, scales 1), then moved to ``device``
    (default: :func:`context.default_device`); with
    ``init_weights=False`` the Parameters wait for ``initialize``."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 dropout=0.1, device=None,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units,
                                        prefix="word_embed_")
            self.pos_embed = PositionalEmbedding(max_length, units,
                                                 prefix="pos_embed_")
            self.embed_ln = LayerNorm(units, prefix="embed_ln_")
            self.embed_drop = Dropout(dropout)
            self.encoder = StackedTransformerEncoder(
                num_layers, units, hidden_size, num_heads,
                prefix="enc_stack_")
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

    def forward(self, inputs):
        x = self.embed_drop(self.embed_ln(
            self.pos_embed(self.word_embed(inputs))))
        seq = self.encoder(x)
        h = self.mlm_ln(F.gelu(self.mlm_dense(seq), approximate="none"))
        return self.decoder(h)

    def hybrid_forward(self, F, inputs):
        return self.forward(inputs)


@torch.no_grad()
def _init_normal(module, generator, sigma: float = 0.02) -> None:
    from .bert import _init_normal as _flat

    _flat(module, generator, sigma)
    for m in module.modules():
        if isinstance(m, StackedTransformerEncoder):
            for name, t in m.stacked().items():
                if name.endswith("weight"):
                    nn.init.normal_(t, 0.0, sigma, generator=generator)
                elif name.endswith("gamma"):
                    t.fill_(1.0)
                else:
                    t.zero_()


def bert_pp_sharding_rules() -> ShardingRules:
    """Stacked encoder params shard their LAYER dim over 'pp' and (where
    the Megatron layout allows) a weight dim over 'tp'; embeddings and
    the MLM head stay replicated (they run on every rank)."""
    rules = [
        (rf".*enc_stack_{key}$",
         ("pp",) + (None,) * (dim - 1) + ("tp",))
        for key, dim in _TP_DIM.items()
    ]
    rules.append((r".*enc_stack_.*", ("pp",)))
    return ShardingRules(rules)


def bert_pp_small(vocab_size=512, units=64, hidden_size=128, num_layers=4,
                  num_heads=4, max_length=64, **kwargs) -> BERTForMLMPipelined:
    return BERTForMLMPipelined(vocab_size=vocab_size, units=units,
                               hidden_size=hidden_size,
                               num_layers=num_layers, num_heads=num_heads,
                               max_length=max_length, **kwargs)
