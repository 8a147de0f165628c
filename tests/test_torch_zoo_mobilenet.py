"""MobileNet V1 and V2 of the port's model zoo against the JAX package's,
on the CPU (``torch_zoo_parity``): ``mobilenet0.25`` and
``mobilenetv2_0.25`` (10 classes) at batch 4, 64^2, with the JAX net's
weights carried by ``convert``: names and Gluon shapes after a forward,
eval logits within 1e-5 and training-mode logits within 5e-4 of the
largest JAX logit.  Their depthwise convolutions have ``groups ==
channels``; ``RELU6`` is ``clip``.
"""
from torch_zoo_parity import family_tests


def _zoo(name):
    return lambda v, **k: v.get_model(name, classes=10, **k)


FAMILIES = {"mobilenet0.25": (_zoo("mobilenet0.25"), 4, 64),
            "mobilenetv2_0.25": (_zoo("mobilenetv2_0.25"), 4, 64)}

(test_params_match_jax_after_a_forward, test_eval_logits_match_jax,
 test_train_logits_match_jax) = family_tests(FAMILIES)
