"""Vision transforms, the port's counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py`` (reference:
gluon/data/vision/transforms.py ~L1-500).  Transforms are blocks on HWC
uint8/float images (tensors, or NDArrays through the Gluon call), with
the JAX module's expressions.  The random ones draw from numpy's global
generator in the JAX module's order.  ``Resize`` and ``RandomResizedCrop``
resample bilinearly with half-pixel centres and, when shrinking, a
kernel widened by the scale (``jax.image.resize``'s "bilinear", which
antialiases): ``torch.nn.functional.interpolate(..., antialias=True)``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from ...block import Block, HybridBlock
from ...nn.basic_layers import HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation"]


class Compose(HybridSequential):
    def __init__(self, transforms):
        super().__init__()
        with self.name_scope():
            for t in transforms:
                self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        from ....ndarray.ndarray import dtype_torch

        return x.to(dtype_torch(self._dtype))


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference: image.to_tensor)."""

    def forward(self, x):
        x = x.float() / 255.0
        if x.dim() == 4:
            return x.permute(0, 3, 1, 2)
        return x.permute(2, 0, 1)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        mean = torch.from_numpy(self._mean).to(x.device)
        std = torch.from_numpy(self._std).to(x.device)
        return (x - mean) / std


def _resize_hw(img, h, w):
    """Bilinear resize of the H, W axes of an HWC or NHWC image, in f32,
    back in the image's dtype."""
    x = img.float()
    batched = x.dim() == 4
    x = (x if batched else x[None]).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    x = x.permute(0, 2, 3, 1)
    return (x if batched else x[0]).to(img.dtype)


class Resize(HybridBlock):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        return _resize_hw(x, h, w)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[-3], x.shape[-2]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return x[..., y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    """Random area/aspect crop + resize (reference: transforms ~L300)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = int(x.shape[-3]), int(x.shape[-2])
        area = H * W
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            aspect = np.exp(np.random.uniform(*log_ratio))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if 0 < w <= W and 0 < h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                crop = x[..., y0:y0 + h, x0:x0 + w, :]
                break
        else:
            crop = x
        tw, th = self._size
        return _resize_hw(crop, th, tw)


class _RandomApply(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return self._apply(x)
        return x


class RandomFlipLeftRight(_RandomApply):
    def _apply(self, x):
        return torch.flip(x, dims=(-2,))


class RandomFlipTopBottom(_RandomApply):
    def _apply(self, x):
        return torch.flip(x, dims=(-3,))


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._b, self._b)
        return x * alpha


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._c, self._c)
        gray = x.mean()
        return x * alpha + gray * (1 - alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._s, self._s)
        coef = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                            device=x.device)
        gray = (x * coef.reshape(1, 1, 3)).sum(dim=-1, keepdim=True)
        return x * alpha + gray * (1 - alpha)
