"""The port's reductions, orderings and indexing ops
(``mxnet_tpu_torch/ops/reduce_ops.py``, ``ops/indexing.py``) against the
JAX package's (``mxnet_tpu/ops/reduce_ops.py``, ``ops/indexing.py``) on
the CPU, one case per op and attribute set (``torch_op_parity``).

Orders and indices are exact: ``argmax`` / ``argmin`` / ``topk`` /
``argsort`` / ``sort`` run on integer-valued inputs full of ties, where
both packages must pick the same positions (lowest index first for
``topk``, the flipped stable order for a descending ``argsort``), and
return MXNet's float32 indices.  Index ops are exact in their values and
their gradients' scatter; ``take`` and ``pick`` in both modes (clip,
wrap) on out-of-range indices, the ``Sequence*`` ops with and without
``use_sequence_length`` on both time axes.  Float reductions within 1e-5
(sums in another order), 1e-6 for ``L2Normalization``.
"""
import numpy as np
import pytest

from torch_op_parity import Case, check, ints, rng_for, uniform

RED = dict(rtol=1e-5, atol=1e-6)


def _cases():
    r = rng_for("reduce")
    x = uniform(r, (2, 3, 4), 0.5, 1.5)
    c = []
    for op in ("sum", "mean", "prod", "nansum", "nanprod", "max", "min"):
        y = uniform(r, (2, 3, 4), 0.5, 1.5)
        if op.startswith("nan"):
            y[0, 1, 2] = np.nan
        c += [Case(op, [y], **RED),
              Case(op, [y], {"axis": 1, "keepdims": True}, tag="axis", **RED),
              Case(op, [y], {"axis": (0, 2), "exclude": True}, tag="exclude",
                   **RED)]
    c += [Case(op, [x], {"axis": 2}, **RED)
          for op in ("sum_axis", "max_axis", "min_axis")]
    c += [
        Case("norm", [x], **RED),
        Case("norm", [x], {"ord": 1, "axis": (1, 2), "keepdims": True},
             tag="l1", **RED),
    ]
    t = ints(r, (3, 6), 0, 4)  # ties
    c += [
        Case("argmax", [t]),
        Case("argmax", [t], {"axis": 1, "keepdims": True}, tag="axis"),
        Case("argmin", [t], {"axis": 0}),
        Case("argmax_channel", [t]),
        Case("topk", [t], {"k": 3}),
        Case("topk", [t], {"k": 2, "axis": 0, "ret_typ": "both"},
             tag="both"),
        Case("topk", [t], {"k": 4, "ret_typ": "value", "is_ascend": True},
             tag="ascend_value"),
        Case("topk", [t], {"k": 5, "axis": None}, tag="flat"),
        Case("sort", [t]),
        Case("sort", [t], {"axis": 0, "is_ascend": False}, tag="desc"),
        Case("argsort", [t]),
        Case("argsort", [t], {"is_ascend": False, "dtype": "int32"},
             tag="desc"),
    ]
    c += [Case("L2Normalization", [uniform(r, (2, 3, 4))], {"mode": m},
               tag=m) for m in ("instance", "channel", "spatial")]
    # indexing
    a = uniform(r, (5, 4))
    idx = np.array([[0, 7], [-2, 3]], np.float32)
    c += [
        Case("take", [a, idx], grad=(0,)),
        Case("take", [a, idx], {"mode": "wrap", "axis": 1}, grad=(0,),
             tag="wrap"),
        Case("pick", [a, np.array([0, 3, 5, -1, 2], np.float32)],
             grad=(0,)),
        Case("pick", [a, np.array([[1, 0, 2, 3]], np.float32)],
             {"axis": 0, "keepdims": True, "mode": "wrap"}, grad=(0,),
             tag="keep_wrap"),
        Case("gather_nd", [uniform(r, (3, 4, 2)),
                           np.array([[0, 2, 1], [3, 0, 1]], np.float32)],
             grad=(0,)),
        Case("scatter_nd", [uniform(r, (3,)),
                            np.array([[0, 2, 1], [3, 0, 1]], np.float32)],
             {"shape": (3, 4)}, grad=(0,)),
        Case("_scatter_set_nd", [uniform(r, (3, 4)),
                                 np.array([[0, 2], [3, 0]], np.float32),
                                 uniform(r, (2,))], {"shape": (3, 4)},
             grad=(0, 2)),
        Case("one_hot", [np.array([0, 3, -1, 5, 2], np.float32)],
             {"depth": 4, "on_value": 2.0, "off_value": -1.0}),
        Case("Embedding", [np.array([[0, 3], [9, 1]], np.float32),
                           uniform(r, (5, 3))],
             {"input_dim": 5, "output_dim": 3}, grad=(1,)),
    ]
    seq = uniform(r, (5, 3, 2))
    lens = np.array([2, 5, 3], np.float32)
    for op in ("SequenceMask", "SequenceLast", "SequenceReverse"):
        kw = {"value": -1.0} if op == "SequenceMask" else {}
        c += [
            Case(op, [seq, lens], grad=(0,)),
            Case(op, [seq, lens], {"use_sequence_length": True, **kw},
                 grad=(0,), tag="lengths"),
            Case(op, [seq.transpose(1, 0, 2).copy(), lens],
                 {"use_sequence_length": True, "axis": 1, **kw}, grad=(0,),
                 tag="axis1"),
        ]
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    shape = (3, 4, 5)
    flat = np.array([0, 7, 59, 23], np.float32)
    multi = np.stack(np.unravel_index(flat.astype(int), shape)).astype(
        np.float32)
    c += [
        Case("boolean_mask", [uniform(r, (5, 3)), mask]),
        Case("_ravel_multi_index", [multi], {"shape": shape}),
        Case("ravel_multi_index", [multi], {"shape": shape}),
        Case("_unravel_index", [flat], {"shape": shape}),
        Case("unravel_index", [flat], {"shape": shape}),
    ]
    return c


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check(case)


def test_embedding_layer_is_the_embedding_op():
    """``gluon.nn.Embedding`` and ``nd.Embedding`` give one answer, float
    indices included, clipped into the vocabulary."""
    from mxnet_tpu_torch import autograd, cpu, gluon, nd

    emb = gluon.nn.Embedding(5, 3)
    emb.initialize(ctx=cpu())
    ids = nd.array([[0, 4], [9, 1]], ctx=cpu())
    w = emb.collect_params()[emb.prefix + "weight"].data()
    np.testing.assert_array_equal(
        emb(ids).asnumpy(), nd.Embedding(ids, w, input_dim=5,
                                         output_dim=3).asnumpy())
    with autograd.record():
        out = emb(ids)
    out.backward()
    g = emb.collect_params()[emb.prefix + "weight"].grad().asnumpy()
    np.testing.assert_array_equal(g.sum(1), [3, 3, 0, 0, 6])
