"""ResNet V1 and V2 (basic blocks), AlexNet and VGG with BatchNorm of the
port's model zoo against the JAX package's, on the CPU
(``torch_zoo_parity``): ``thumbnail`` ResNets at 32^2, AlexNet at 64^2,
``vgg11_bn`` at 32^2, 10 classes each, with the JAX net's weights
carried by ``convert``.  Per net: the
``collect_params()`` names and Gluon shapes after a forward, eval logits
within 1e-5 and training-mode logits (BatchNorm on the batch) within
5e-4 of the largest JAX logit, Dropout at rate 0 in both.
"""
from torch_zoo_parity import family_tests


def _zoo(name, **kw):
    return lambda v, **k: v.get_model(name, classes=10, **kw, **k)


FAMILIES = {
    "resnet18_v1": (_zoo("resnet18_v1", thumbnail=True), 2, 32),
    "resnet18_v2": (_zoo("resnet18_v2", thumbnail=True), 2, 32),
    "alexnet": (_zoo("alexnet"), 2, 64),
    "vgg11_bn": (_zoo("vgg11_bn"), 2, 32),
}

(test_params_match_jax_after_a_forward, test_eval_logits_match_jax,
 test_train_logits_match_jax) = family_tests(FAMILIES)
