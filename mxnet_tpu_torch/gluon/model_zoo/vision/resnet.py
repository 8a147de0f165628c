"""ResNet V1, V1b and V2: ``models/resnet.py``, under the JAX zoo's path
(``mxnet_tpu/gluon/model_zoo/vision/resnet.py``)."""
from ....models.resnet import *  # noqa: F401,F403
from ....models.resnet import __all__  # noqa: F401
