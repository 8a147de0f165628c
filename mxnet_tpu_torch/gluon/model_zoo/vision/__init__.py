"""The vision models of ``mxnet_tpu/gluon/model_zoo/vision/``: ResNet V1,
V1b and V2, AlexNet, VGG (with BatchNorm), SqueezeNet, DenseNet,
MobileNet V1 and V2 and Inception V3, with ``get_model``'s table of the
JAX package's 36 names and ``register_model``.

The nets are Gluon ``HybridBlock``s built in the JAX classes' name scopes
and order, so ``collect_params()`` gives the JAX nets' names; each
family's body is its ``hybrid_forward``, so ``export`` writes the JAX
graph.  ``get_model`` returns a net whose Parameters wait for
``initialize(init, ctx)``, as MXNet's does (the ResNet constructors,
called directly, draw their weights: ``models/resnet.py``); every layer
but ResNet's learns its input width at the first call.  No weights are
fetched: ``pretrained=True`` raises.
"""
import functools

from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all
from .alexnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403

_models = {name: functools.partial(globals()[name], init_weights=False)
           for name in _resnet_all if name.startswith("resnet")}
_models.update({
    "alexnet": alexnet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
    "inceptionv3": inception_v3,
})


def get_model(name, **kwargs):
    """The net ``name`` (any case) of the table, built with ``kwargs``."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"Model {name} is not supported yet. Available: "
                         f"{sorted(_models)}")
    if kwargs.pop("pretrained", False):
        raise MXNetError(
            "pretrained weights are unavailable without a network; "
            "initialize() and train, or load_parameters() from a local file")
    return _models[name](**kwargs)


def register_model(name, fn):
    """Add ``fn`` (a callable taking ``get_model``'s keyword arguments)
    to the table under ``name``."""
    _models[name.lower()] = fn
