"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel (built from ``mxnet_tpu_torch/csrc`` on first use) for tensors
on a CUDA device, or raises; it never falls back.  Each counts its kernel
launches in a plain integer attribute (``layer_norm.launches``,
``paged_decode_attention.launches``).
"""
from .layer_norm import layer_norm, layer_norm_ref
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_ref)

__all__ = ["layer_norm", "layer_norm_ref", "paged_decode_attention",
           "paged_decode_attention_ref"]
