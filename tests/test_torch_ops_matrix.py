"""The port's shape, linear-algebra and creation ops
(``mxnet_tpu_torch/ops/matrix.py``, ``ops/creation.py``) against the
JAX package's (``mxnet_tpu/ops/matrix.py``, ``ops/creation.py``) on the
CPU, one case per op and attribute set (``torch_op_parity``): MXNet's
reshape codes 0, -1, -2, -3, -4 and ``reverse``, negative slice steps,
``dot`` / ``batch_dot`` with each transpose flag, ``pad`` in its three
modes, and the 15 ``linalg_*`` ops on batched, well-conditioned
matrices with each ``transpose`` / ``rightside`` / ``lower`` flag.

Tolerances: shape ops are exact moves (1e-6 on values and gradients);
products 1e-5; ``linalg_*`` 1e-4 relative on values and gradients (the
factorizations come from different LAPACK builds).  ``linalg_gelqf``
takes LAPACK's Householder signs in both packages, compared directly.
"""
import numpy as np
import pytest

from torch_op_parity import Case, check, ints, rng_for, uniform

LIN = dict(rtol=1e-4, atol=1e-5, grad_rtol=1e-4, grad_atol=1e-4)
MM = dict(rtol=1e-5, atol=1e-6, grad_rtol=1e-5, grad_atol=1e-5)


def _spd(rng, b, n):
    m = rng.standard_normal((b, n, n)).astype(np.float32)
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32))


def _tri(rng, b, n, lower=True):
    m = uniform(rng, (b, n, n), -0.5, 0.5) + 2 * np.eye(n, dtype=np.float32)
    return np.tril(m) if lower else np.triu(m)


def _cases():
    r = rng_for("matrix")
    x = uniform(r, (2, 3, 4))
    c = []
    for shape, rev in (((0, -1), False), ((4, 0, -1), False), ((-2,), False),
                       ((-3, -2), False), ((-4, 1, 2, -2), False),
                       ((0, -1), True)):
        tag = "_".join(map(str, shape)) + ("_rev" if rev else "")
        c.append(Case("reshape", [x], {"shape": shape, "reverse": rev},
                      tag=tag))
    c.append(Case("Reshape", [x], {"shape": (-1, 4)}))
    c += [
        Case("Flatten", [x]),
        Case("transpose", [x]),
        Case("transpose", [x], {"axes": (1, 0, 2)}, tag="axes"),
        Case("expand_dims", [x], {"axis": 1}),
        Case("squeeze", [uniform(r, (2, 1, 3, 1))]),
        Case("squeeze", [uniform(r, (2, 1, 3, 1))], {"axis": (1, 3)},
             tag="axes"),
        Case("swapaxes", [x], {"dim1": 0, "dim2": 2}),
        Case("SwapAxis", [x], {"dim1": 1, "dim2": 2}),
        Case("flip", [x], {"axis": 1}),
        Case("reverse", [x], {"axis": (0, 2)}),
        Case("tile", [x], {"reps": (2, 1, 3)}),
        Case("tile", [x], {"reps": (2,)}, tag="short"),
        Case("repeat", [x], {"repeats": 2, "axis": 1}),
        Case("repeat", [x], {"repeats": 3}, tag="flat"),
        Case("broadcast_to", [uniform(r, (1, 3, 1))], {"shape": (2, 0, 4)}),
        Case("broadcast_like", [uniform(r, (1, 3, 1)), x]),
        Case("broadcast_like", [uniform(r, (1, 3, 1)), x],
             {"lhs_axes": (0,), "rhs_axes": (0,)}, grad=(0,), tag="axes"),
        Case("broadcast_axis", [uniform(r, (1, 3, 1))],
             {"axis": (0, 2), "size": (2, 4)}),
        Case("Concat", [x, uniform(r, (2, 1, 4)), x], {"dim": 1,
                                                        "num_args": 3}),
        Case("stack", [x, x * 2], {"axis": 1, "num_args": 2}),
        Case("split", [uniform(r, (2, 6, 4))], {"num_outputs": 3,
                                                 "axis": 1}),
        Case("split", [uniform(r, (2, 3, 4))],
             {"num_outputs": 3, "axis": 1, "squeeze_axis": True},
             tag="squeeze"),
        Case("SliceChannel", [uniform(r, (2, 6, 4))], {"num_outputs": 2}),
        Case("split_v2", [uniform(r, (2, 6, 4))],
             {"indices_or_sections": (1, 3), "axis": 1}),
        Case("split_v2", [uniform(r, (4, 3))], {"sections": 2},
             tag="sections"),
        Case("slice", [x], {"begin": (0, 1), "end": (2, 3)}),
        Case("slice", [x], {"begin": (None, 3), "end": (None, 0),
                            "step": (None, -1)}, tag="negstep"),
        Case("slice", [x], {"begin": (1, 0, 0), "end": (2, 3, 4),
                            "step": (1, 2, 3)}, tag="step"),
        Case("slice_axis", [x], {"axis": 2, "begin": 1, "end": 3}),
        Case("slice_axis", [x], {"axis": 1, "begin": 1, "end": None},
             tag="open"),
        Case("slice_like", [uniform(r, (4, 5)), uniform(r, (2, 3))],
             grad=(0,)),
        Case("slice_like", [uniform(r, (4, 5)), uniform(r, (2, 3))],
             {"axes": (1,)}, grad=(0,), tag="axes"),
    ]
    img = uniform(r, (2, 3, 4, 5))
    widths = (0, 0, 0, 0, 1, 2, 2, 1)
    c += [Case("pad", [img], {"mode": m, "pad_width": widths,
                              "constant_value": 0.5}, tag=m)
          for m in ("constant", "edge", "reflect")]
    c += [
        Case("dot", [uniform(r, (3, 4)), uniform(r, (4, 5))], **MM),
        Case("dot", [uniform(r, (4, 3)), uniform(r, (4, 5))],
             {"transpose_a": True}, tag="ta", **MM),
        Case("dot", [uniform(r, (3, 4)), uniform(r, (5, 4))],
             {"transpose_b": True}, tag="tb", **MM),
        Case("dot", [x, uniform(r, (4, 5))], tag="3d", **MM),
        Case("dot", [uniform(r, (4,)), uniform(r, (4,))], tag="1d", **MM),
        Case("batch_dot", [x, uniform(r, (2, 4, 5))], **MM),
        Case("batch_dot", [uniform(r, (2, 4, 3)), uniform(r, (2, 5, 4))],
             {"transpose_a": True, "transpose_b": True}, tag="tt", **MM),
        Case("where", [ints(r, (2, 3, 4), 0, 2), x, uniform(r, (2, 3, 4))],
             grad=(1, 2)),
        Case("depth_to_space", [uniform(r, (1, 8, 2, 3))],
             {"block_size": 2}),
        Case("space_to_depth", [uniform(r, (1, 2, 4, 6))],
             {"block_size": 2}),
        Case("diag", [uniform(r, (4,))], {"k": 1}),
        Case("diag", [uniform(r, (4, 5))], {"k": -1}, tag="2d"),
        Case("diag", [x], tag="3d"),
        Case("shape_array", [x]),
        Case("size_array", [x]),
        Case("zeros_like_legacy", [x]),
        Case("batch_take", [uniform(r, (4, 5)),
                            np.array([0, 4, 7, -1], np.float32)], grad=(0,)),
        Case("khatri_rao", [uniform(r, (3, 2)), uniform(r, (4, 2))], **MM),
        Case("reshape_like", [x, uniform(r, (6, 4))], grad=(0,)),
        Case("reshape_like", [x, uniform(r, (12, 5))],
             {"lhs_begin": 1, "lhs_end": 3, "rhs_begin": 0, "rhs_end": 1},
             grad=(0,), tag="range"),
        Case("cumsum", [x], **MM),
        Case("cumsum", [x], {"axis": 1, "dtype": "float32"}, tag="axis",
             **MM),
        Case("logsumexp", [x], **MM),
        Case("logsumexp", [x], {"axis": 1, "keepdims": True}, tag="axis",
             **MM),
        Case("onehot_encode", [np.array([0, 3, 1, 4], np.float32),
                               uniform(r, (4, 5))]),
        Case("choose_element_0index", [uniform(r, (4, 5)),
                                       np.array([0, 3, 1, 4], np.float32)]),
        Case("fill_element_0index", [uniform(r, (4, 5)), uniform(r, (4,)),
                                     np.array([0, 3, 1, 4], np.float32)]),
    ]
    # linalg, batched
    a34, b45 = uniform(r, (2, 3, 4)), uniform(r, (2, 4, 5))
    spd = _spd(r, 2, 4)
    low = _tri(r, 2, 4)
    full = uniform(r, (2, 4, 4), -0.5, 0.5) + 3 * np.eye(4, dtype=np.float32)
    c += [
        Case("linalg_gemm2", [a34, b45], {"alpha": 0.5}, **LIN),
        Case("linalg_gemm2", [uniform(r, (2, 4, 3)), uniform(r, (2, 5, 4))],
             {"transpose_a": True, "transpose_b": True}, tag="tt", **LIN),
        Case("linalg_gemm", [a34, b45, uniform(r, (2, 3, 5))],
             {"alpha": 0.5, "beta": 2.0}, **LIN),
        Case("linalg_gemm", [uniform(r, (3, 4, 2)), uniform(r, (4, 5, 2)),
                             uniform(r, (3, 5, 2))], {"axis": 0},
             tag="axis0", **LIN),
        Case("linalg_syrk", [a34], {"alpha": 0.7}, **LIN),
        Case("linalg_syrk", [a34], {"transpose": True}, tag="t", **LIN),
        Case("linalg_potrf", [spd], **LIN),
        Case("linalg_potri", [low[0]], **LIN),  # the JAX op is 2-D only
        Case("linalg_trsm", [low, uniform(r, (2, 4, 3))], {"alpha": 2.0},
             **LIN),
        Case("linalg_trsm", [low, uniform(r, (2, 3, 4))],
             {"transpose": True, "rightside": True}, tag="t_right", **LIN),
        Case("linalg_trsm", [_tri(r, 2, 4, lower=False),
                             uniform(r, (2, 4, 3))], {"lower": False},
             tag="upper", **LIN),
        Case("linalg_trmm", [full, uniform(r, (2, 4, 3))], {"alpha": 0.5},
             **LIN),
        Case("linalg_trmm", [full, uniform(r, (2, 3, 4))],
             {"transpose": True, "rightside": True, "lower": False},
             tag="t_right_upper", **LIN),
        Case("linalg_sumlogdiag", [spd], **LIN),
        Case("linalg_extractdiag", [full], {"offset": 1}, **LIN),
        Case("linalg_makediag", [uniform(r, (2, 3))], {"offset": -1},
             **LIN),
        Case("linalg_inverse", [full], **LIN),
        Case("linalg_det", [full], **LIN),
        Case("linalg_slogdet", [full - 3.5 * np.eye(4, dtype=np.float32)],
             **LIN),
        Case("linalg_gelqf", [uniform(r, (2, 3, 5))], **LIN),
    ]
    # creation
    c += [
        Case("_zeros", [], {"shape": (2, 3)}),
        Case("_ones", [], {"shape": (2, 3), "dtype": "int64"}),
        Case("_full", [], {"shape": (3,), "value": 2.5}),
        Case("_arange", [], {"start": 2.0, "stop": 11.0, "step": 1.5,
                             "repeat": 2}),
        Case("_arange", [], {"start": 5.0, "dtype": "int32"}, tag="stop"),
        Case("_eye", [], {"N": 3, "M": 5, "k": 1}),
        Case("_eye", [], {"N": 4, "k": -2}, tag="square"),
        Case("_linspace", [], {"start": -1.0, "stop": 2.0, "num": 7}),
        Case("_linspace", [], {"start": 0.0, "stop": 1.0, "num": 4,
                               "endpoint": False}, tag="open"),
        Case("zeros_like", [x]),
        Case("ones_like", [ints(r, (3,), dtype=np.int32)]),
    ]
    return c


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check(case)


def test_nd_linalg_names_are_the_flat_stubs():
    from mxnet_tpu_torch import cpu, nd

    assert sorted(nd.linalg.__all__) == sorted(
        n[len("linalg_"):] for n in nd.__all__ if n.startswith("linalg_"))
    a = nd.array(np.eye(3, dtype=np.float32) * 2, ctx=cpu())
    assert nd.linalg.det(a).asscalar() == nd.linalg_det(a).asscalar() == 8.0
    assert nd.linalg.potrf is nd.linalg_potrf
