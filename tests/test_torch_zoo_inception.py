"""Inception V3 of the port's model zoo against the JAX package's, on the
CPU (``torch_zoo_parity``): ``inception_v3(classes=10)`` at batch 2 and
its 299^2 input (its closing 8 x 8 pool fixes the size), with the JAX
net's weights carried by ``convert``: names and Gluon shapes after a
forward, eval logits within 1e-5 and training-mode logits within 5e-4 of
the largest JAX logit, Dropout at rate 0 in both.
"""
from torch_zoo_parity import family_tests

FAMILIES = {"inceptionv3": (
    lambda v, **k: v.get_model("inceptionv3", classes=10, **k), 2, 299)}

(test_params_match_jax_after_a_forward, test_eval_logits_match_jax,
 test_train_logits_match_jax) = family_tests(FAMILIES)
