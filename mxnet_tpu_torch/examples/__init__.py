"""The example training scripts of the port, run by name:

    python -m mxnet_tpu_torch.examples.train_mnist [--network lenet|mlp]
    python -m mxnet_tpu_torch.examples.train_imagenet --rec train.rec
    python -m mxnet_tpu_torch.examples.train_detection --model ssd
    python -m mxnet_tpu_torch.examples.train_wmt --model base

Each takes the JAX package's example's arguments and defaults.  They run
on the CUDA card; ``--device cpu`` runs them on the CPU, where every
kernel takes its plain PyTorch version.  ``--device auto`` (the default)
means the card and raises when there is none: nothing falls back to the
CPU on its own.
"""
from __future__ import annotations

__all__ = ["context_of"]


def context_of(device: str):
    """The Context of a ``--device`` argument: ``cpu``, or ``auto`` for
    ``gpu(0)``, which must exist."""
    import torch

    import mxnet_tpu_torch as mx

    if device == "cpu":
        return mx.cpu()
    if device != "auto":
        raise mx.MXNetError(f"--device must be auto or cpu, got {device!r}")
    if not torch.cuda.is_available():
        raise mx.MXNetError(
            "--device auto runs on the CUDA card and torch sees none; pass "
            "--device cpu to run on the CPU")
    return mx.gpu(0)
