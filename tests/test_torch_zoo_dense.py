"""ResNet V2's bottleneck, SqueezeNet and DenseNet of the port's model zoo
against the JAX package's, on the CPU (``torch_zoo_parity``):
``resnet50_v2(thumbnail=True)`` at 32^2, ``squeezenet1.1`` at 64^2 (its
pools in the ``full`` convention) and ``DenseNet(16, 8, (2, 2, 2, 2))``
at 32^2, 10 classes each, with the JAX net's weights carried by
``convert``: names and Gluon shapes after a forward, eval logits within
1e-5 and training-mode logits within 5e-4 of the largest JAX logit,
Dropout at rate 0 in both.  SqueezeNet and DenseNet concatenate on the
channel axis.
"""
from torch_zoo_parity import family_tests


def _zoo(name, **kw):
    return lambda v, **k: v.get_model(name, classes=10, **kw, **k)


FAMILIES = {
    "resnet50_v2": (_zoo("resnet50_v2", thumbnail=True), 2, 32),
    "squeezenet1.1": (_zoo("squeezenet1.1"), 2, 64),
    "densenet": (lambda v, **k: v.DenseNet(16, 8, (2, 2, 2, 2), classes=10,
                                           **k), 2, 32),
}

(test_params_match_jax_after_a_forward, test_eval_logits_match_jax,
 test_train_logits_match_jax) = family_tests(FAMILIES)
