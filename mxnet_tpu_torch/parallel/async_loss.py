"""The lazy loss handle ``DataParallelStep.step()`` returns.

Counterpart of ``mxnet_tpu/parallel/async_loss.py::AsyncLoss``: the step
returns before the device finishes, holding the loss as a device scalar
and, on a CUDA device, an event recorded on the current stream behind the
step's work.  ``wait()``, ``float()`` and ``item()`` synchronise on the
event and read the value once.  (The JAX module's in-flight ring, stacked
losses and ``drain_all`` are not ported.)
"""
from __future__ import annotations

import torch

__all__ = ["AsyncLoss"]


class AsyncLoss:
    def __init__(self, value: torch.Tensor):
        self._value = value.detach()
        self._host = None
        self._event = None
        if self._value.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self._value.device))

    def wait(self) -> float:
        """Block until the value is on the host and return it."""
        if self._host is None:
            if self._event is not None:
                self._event.synchronize()
            self._host = float(self._value.item())
            self._value = None  # drop the device reference
        return self._host

    def item(self) -> float:
        return self.wait()

    def __float__(self) -> float:
        return self.wait()
