"""Helpers of the symbolic-API parity tests (``test_torch_symbol.py``,
``test_torch_executor.py``, ``test_torch_module.py``,
``test_torch_rnn_legacy.py``, ...): a graph built by one function in both
packages, bound on the CPU, fed the same numpy values, run forward (and
backward), and compared.

``build(mx)`` takes the package (``mxnet_tpu`` or ``mxnet_tpu_torch``) and
returns a Symbol; the two packages spell the symbolic API alike.
Tolerances (the slice's): shapes, types and names exactly (the digits of
auto-named op nodes aside, ``uncounted``), outputs rtol
1e-5 / atol 1e-6, gradients within 1e-5 of the largest max abs over
the run's gradients (``assert_grads_close``).
"""
import re

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-5


def ctx_of(mx):
    return mx.cpu()


def nd_array(mx, value):
    value = np.asarray(value)
    if mx is tmx:
        return tmx.nd.array(value, ctx=tmx.cpu(), dtype=value.dtype)
    return jmx.nd.array(value, dtype=value.dtype)


def run_graph(mx, build, shapes, feeds, grad_req="write", is_train=True,
              backward=True, out_grads=None, steps=1):
    """Bind ``build(mx)`` by ``shapes``, feed ``feeds`` (numpy by name),
    run ``steps`` forward (and backward) passes: a dict of the symbol's
    names and inferred shapes and types, the outputs and the gradients
    (numpy)."""
    sym = build(mx)
    exe = sym.simple_bind(ctx=ctx_of(mx), grad_req=grad_req, **shapes)
    for _ in range(steps):
        exe.forward(is_train=is_train, **feeds)
        if backward:
            og = None if out_grads is None else [nd_array(mx, g)
                                                 for g in out_grads]
            exe.backward(og)
    return {"arguments": sym.list_arguments(),
            "aux": sym.list_auxiliary_states(),
            "outputs_names": sym.list_outputs(),
            "infer_shape": sym.infer_shape(**shapes),
            "infer_type": sym.infer_type(
                **{k: "float32" for k in shapes}),
            "outputs": [o.asnumpy() for o in exe.outputs],
            "grads": {k: v.asnumpy() for k, v in exe.grad_dict.items()
                      if v is not None},
            "aux_values": {k: v.asnumpy() for k, v in exe.aux_dict.items()},
            "exe": exe}


def assert_grads_close(got, want, tol=GRAD_TOL):
    """Every array of ``got`` within ``tol`` of the largest max abs over
    ``want``'s arrays (a gradient that is rounding noise, such as a bias
    ahead of a BatchNorm, has no scale of its own)."""
    assert sorted(got) == sorted(want)
    scale = max((float(np.abs(v).max()) for v in want.values() if v.size),
                default=0.0)
    for k in want:
        err = float(np.abs(got[k] - want[k]).max()) if want[k].size else 0.0
        assert err <= tol * scale, (k, err, scale)


def uncounted(names):
    """Names with their digits masked: each package counts its own
    auto-named op nodes (``pooling0`` in one may be ``pooling3`` in the
    other)."""
    return [re.sub(r"\d+", "#", n) for n in names]


def assert_same_run(t, j):
    """The port's run ``t`` equals the JAX run ``j``."""
    for key in ("arguments", "aux", "infer_shape"):
        assert t[key] == j[key], key
    assert uncounted(t["outputs_names"]) == uncounted(j["outputs_names"])
    assert [None if d is None else np.dtype(d) for ds in t["infer_type"]
            for d in ds] == [None if d is None else np.dtype(d)
                             for ds in j["infer_type"] for d in ds]
    assert len(t["outputs"]) == len(j["outputs"])
    for a, b in zip(t["outputs"], j["outputs"]):
        np.testing.assert_allclose(a, b, **OUT_TOL)
    assert_grads_close(t["grads"], j["grads"])
    for k, v in j["aux_values"].items():
        np.testing.assert_allclose(t["aux_values"][k], v, **OUT_TOL)


def both(build, shapes, feeds, **kw):
    return (run_graph(tmx, build, shapes, feeds, **kw),
            run_graph(jmx, build, shapes, feeds, **kw))
