"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel (built from ``mxnet_tpu_torch/csrc`` on first use) for tensors
on a CUDA device, or raises; it never falls back.  Each counts its kernel
launches in a plain integer attribute (``layer_norm.launches``,
``paged_decode_attention.launches``, ``flash_attention_fwd.launches``,
``flash_attention_dq.launches``, ``flash_attention_dkv.launches``).
"""
from .flash_attention import (FlashAttentionFunction, flash_attention,
                              flash_attention_dkv, flash_attention_dkv_ref,
                              flash_attention_dq, flash_attention_dq_ref,
                              flash_attention_fwd, flash_attention_ref)
from .layer_norm import (LayerNormFunction, layer_norm, layer_norm_bwd,
                         layer_norm_ref)
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_ref)

__all__ = ["layer_norm", "layer_norm_ref", "layer_norm_bwd",
           "LayerNormFunction", "paged_decode_attention",
           "paged_decode_attention_ref", "flash_attention",
           "flash_attention_ref", "flash_attention_fwd", "flash_attention_dq",
           "flash_attention_dq_ref", "flash_attention_dkv",
           "flash_attention_dkv_ref", "FlashAttentionFunction"]
