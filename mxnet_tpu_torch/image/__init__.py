"""Image API: decode, resize and the augmenters with ``ImageIter``
(``image.py``), and the detection pipeline with ``ImageDetIter``
(``detection.py``), as ``mxnet_tpu/image/`` exports them."""
from .image import (imdecode, imencode, imread, imresize, resize_short,
                    fixed_crop, center_crop, random_crop, random_size_crop,
                    color_normalize,
                    CreateAugmenter, Augmenter, ResizeAug, ForceResizeAug,
                    RandomCropAug, CenterCropAug, RandomSizedCropAug,
                    RandomOrderAug, HorizontalFlipAug,
                    CastAug, BrightnessJitterAug, ContrastJitterAug,
                    SaturationJitterAug, HueJitterAug, ColorJitterAug,
                    LightingAug, RandomGrayAug, ColorNormalizeAug, ImageIter)
from .detection import (DetAugmenter, DetBorrowAug, DetRandomSelectAug,
                        DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomPadAug, CreateDetAugmenter, ImageDetIter,
                        pack_det_label)
