"""The port's elementwise ops (``mxnet_tpu_torch/ops/elemwise.py``)
against the JAX package's (``mxnet_tpu/ops/elemwise.py``) on the CPU,
one case per op and attribute set (``torch_op_parity``): the unary math
family on each function's domain, the broadcasting binaries, the
comparisons and logical ops on integer-valued inputs (so that ties
occur; 0/1 outputs compared exactly), every ``_*_scalar`` op, ``clip``,
``add_n``, ``Cast``, the overflow checks and the identities.

Tolerances: f32 forward within 1e-6 relative (+1e-7 absolute) of the
JAX value, gradients within 1e-5; the special functions whose XLA and
ATen approximations differ by more than that (``gamma``, ``gammaln`` and
``digamma``: up to 2e-6 absolute on values of order one, 4e-5 relative
near a zero of ``gammaln``) within 1e-5 relative + 1e-6 absolute
forward and 1e-4 on their gradients.
"""
import numpy as np
import pytest

from torch_op_parity import Case, check, ints, rng_for, uniform

S = (3, 4)

# op -> (lo, hi) of its inputs
UNARY = {
    "relu": (-1, 1), "sigmoid": (-3, 3), "hard_sigmoid": (-4, 4),
    "softsign": (-2, 2), "tanh": (-2, 2), "exp": (-2, 2),
    "expm1": (-1, 1), "log": (0.2, 3), "log2": (0.2, 3),
    "log10": (0.2, 3), "log1p": (-0.5, 2), "sqrt": (0.1, 3),
    "rsqrt": (0.2, 3), "cbrt": (0.2, 3), "rcbrt": (0.2, 3),
    "square": (-2, 2), "abs": (-2, 2), "sign": (-2, 2),
    "floor": (-3, 3), "ceil": (-3, 3), "round": (-3, 3), "rint": (-3, 3),
    "trunc": (-3, 3), "fix": (-3, 3), "negative": (-2, 2),
    "reciprocal": (0.3, 3), "erf": (-2, 2), "erfinv": (-0.9, 0.9),
    "gamma": (0.5, 3), "gammaln": (0.5, 3), "digamma": (0.5, 3),
    "sin": (-3, 3), "cos": (-3, 3), "tan": (-1.2, 1.2),
    "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9), "arctan": (-3, 3),
    "sinh": (-2, 2), "cosh": (-2, 2), "arcsinh": (-3, 3),
    "arccosh": (1.2, 3), "arctanh": (-0.9, 0.9), "degrees": (-3, 3),
    "radians": (-90, 90), "logical_not": None,
    "identity": (-1, 1), "_copy": (-1, 1), "stop_gradient": (-1, 1),
    "BlockGrad": (-1, 1), "make_loss": (-1, 1),
}
SPECIAL = {"gamma", "gammaln", "digamma"}

BINARY = ("add", "sub", "mul", "div", "mod", "power", "maximum", "minimum",
          "hypot", "plus", "minus")
CMP = ("equal", "not_equal", "greater", "greater_equal", "lesser",
       "lesser_equal", "logical_and", "logical_or", "logical_xor")

SCALAR = {  # op -> (lo, hi, scalar)
    "_plus_scalar": (-1, 1, 0.7), "_minus_scalar": (-1, 1, 0.7),
    "_rminus_scalar": (-1, 1, 0.7), "_mul_scalar": (-1, 1, -1.3),
    "_div_scalar": (-1, 1, 0.7), "_rdiv_scalar": (0.3, 2, 1.7),
    "_mod_scalar": (-3, 3, 0.7), "_rmod_scalar": (0.3, 2, 3.3),
    "_power_scalar": (0.3, 2, 2.5), "_rpower_scalar": (-1, 1, 1.7),
    "_maximum_scalar": (-1, 1, 0.2), "_minimum_scalar": (-1, 1, 0.2),
}


def _cases():
    cases = []
    for op, dom in UNARY.items():
        rng = rng_for(op)
        x = ints(rng, S, -1, 2) if dom is None else uniform(rng, S, *dom)
        tol = (dict(rtol=1e-5, atol=1e-6, grad_rtol=1e-4, grad_atol=1e-5)
               if op in SPECIAL else dict(rtol=1e-6, atol=1e-7))
        cases.append(Case(op, [x], **tol))
    for name in BINARY:
        rng = rng_for(name)
        lo, hi = {"power": (0.3, 2), "mod": (-3, 3)}.get(name, (-2, 2))
        a = uniform(rng, (2, 3, 4), lo, hi)
        b = uniform(rng, (3, 1), 0.4, 2) if name in ("mod", "power", "div") \
            else uniform(rng, (3, 1), -2, 2)
        cases.append(Case("broadcast_" + name, [a, b], rtol=1e-6, atol=1e-7))
    for name in ("add", "sub", "mul", "div"):
        rng = rng_for("elemwise_" + name)
        cases.append(Case("elemwise_" + name,
                          [uniform(rng, S), uniform(rng, S, 0.5, 2)],
                          rtol=1e-6, atol=1e-7))
    for name in ("maximum", "minimum"):
        rng = rng_for(name)
        cases.append(Case(name, [uniform(rng, S), uniform(rng, (1, 4))]))
    for name in CMP:
        rng = rng_for(name)
        cases.append(Case("broadcast_" + name,
                          [ints(rng, (2, 3, 4)), ints(rng, (3, 1))]))
        cases.append(Case(f"_{name}_scalar", [ints(rng, S)],
                          {"scalar": 1.0}))
        cases.append(Case(f"_{name}_scalar", [ints(rng, S, dtype=np.int32)],
                          {"scalar": 1.5}, tag="int"))
    for op, (lo, hi, s) in SCALAR.items():
        rng = rng_for(op)
        cases.append(Case(op, [uniform(rng, S, lo, hi)], {"scalar": s},
                          rtol=1e-6, atol=1e-7))
    rng = rng_for("misc")
    x = uniform(rng, S, -2, 2)
    cases += [
        Case("clip", [x], {"a_min": -0.3, "a_max": 0.4}),
        Case("add_n", [x, uniform(rng, S), uniform(rng, S)],
             {"num_args": 3}),
        Case("ElementWiseSum", [x, uniform(rng, S)], {"num_args": 2}),
        Case("Cast", [x], {"dtype": "float16"}, exact=True),
        Case("Cast", [x * 3], {"dtype": "int32"}, tag="int"),
        Case("smooth_l1", [x], {"scalar": 1.5}),
        Case("all_finite", [x]),
        Case("all_finite", [np.where(x > 1, np.inf, x).astype(np.float32)],
             tag="inf"),
        Case("multi_all_finite", [x, np.full((2,), np.nan, np.float32)],
             {"num_arrays": 2}),
        Case("multi_all_finite", [x, x[:1]], {"num_arrays": 2}, tag="ok"),
    ]
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check(case)


def test_integer_scalar_comparison_is_exact_in_the_input_dtype():
    """1 < 1.5 on an int32 array: the scalar is not truncated and the
    0/1 answer keeps the array's dtype."""
    import torch

    from mxnet_tpu_torch.ops import registry

    x = torch.tensor([0, 1, 2], dtype=torch.int32)
    out = registry.get_op("_lesser_scalar").fn(x, scalar=1.5)
    assert out.dtype == torch.int32 and out.tolist() == [1, 1, 0]
