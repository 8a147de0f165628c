"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel (built from ``mxnet_tpu_torch/csrc`` on first use) for tensors
on a CUDA device, or raises; it never falls back.  Each counts its kernel
launches in a plain integer attribute (``layer_norm.launches``,
``add_layer_norm.launches``, ``paged_decode_attention.launches``,
``flash_attention_fwd.launches``, ``flash_attention_dq.launches``,
``flash_attention_dkv.launches``, ``softmax_cross_entropy.launches``),
added to under a lock (``_build.count_launch``), so launches from several
threads (two serving replicas) all count.

``registry`` maps op-classes of ``ops.registry`` to these kernels for the
``fused_kernels`` pass; it is imported by the pass, not here.
"""
from .flash_attention import (FlashAttentionFunction, flash_attention,
                              flash_attention_dkv, flash_attention_dkv_ref,
                              flash_attention_dq, flash_attention_dq_ref,
                              flash_attention_fwd, flash_attention_ref)
from .layer_norm import (AddLayerNormFunction, LayerNormFunction,
                         add_layer_norm, add_layer_norm_bwd,
                         add_layer_norm_ref, layer_norm, layer_norm_bwd,
                         layer_norm_ref)
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_ref)
from .softmax_cross_entropy import (SoftmaxCrossEntropyFunction,
                                    softmax_cross_entropy,
                                    softmax_cross_entropy_bwd,
                                    softmax_cross_entropy_ref)

__all__ = ["layer_norm", "layer_norm_ref", "layer_norm_bwd",
           "LayerNormFunction", "add_layer_norm", "add_layer_norm_ref",
           "add_layer_norm_bwd", "AddLayerNormFunction",
           "paged_decode_attention", "paged_decode_attention_ref",
           "flash_attention", "flash_attention_ref", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dq_ref",
           "flash_attention_dkv", "flash_attention_dkv_ref",
           "FlashAttentionFunction", "softmax_cross_entropy",
           "softmax_cross_entropy_ref", "softmax_cross_entropy_bwd",
           "SoftmaxCrossEntropyFunction"]
