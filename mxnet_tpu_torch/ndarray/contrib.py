"""The ``nd.contrib`` namespace: every registered ``_contrib_<name>`` op as
``nd.contrib.<name>`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``'s
``_populate``), and the control-flow operators ``foreach``,
``while_loop`` and ``cond``.

The JAX package lowers the control flow to ``lax.scan`` / ``lax.cond``,
or unrolls it in Python while autograd records eagerly.  The port has no
trace: the loops always run in Python over NDArrays, so autograd sees
every op and gradients reach the arrays the body closes over.  The
results are the JAX functions': ``foreach`` stacks each step's outputs
on a new axis 0; ``while_loop`` stacks them to ``max_iterations``
rows, zero rows after the last step (its ``lax.scan`` shape), and when
the body never runs it calls ``func`` once for the outputs' shapes and
returns zeros, as the scan does.
"""
from __future__ import annotations

from ..base import MXNetError
from ..ops import registry as _reg

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stack(arrays):
    return _reg.invoke_by_name("stack", list(arrays), axis=0)


def _truth(p) -> bool:
    from .ndarray import NDArray

    if isinstance(p, NDArray):
        return bool(p.asnumpy().reshape(()))
    return bool(p)


def foreach(body, data, init_states):
    """``body(data_i, states) -> (outputs, states)`` over axis 0 of
    ``data`` (an array or a list of them); returns (stacked outputs,
    final states)."""
    data_list = _as_list(data)
    data_multi = isinstance(data, (list, tuple))
    n_state = len(_as_list(init_states))
    cur = init_states
    collected, out_multi = None, False
    for i in range(data_list[0].shape[0]):
        xs = [d[i] for d in data_list]
        outs, cur = body(xs if data_multi else xs[0], cur)
        if len(_as_list(cur)) != n_state:
            raise MXNetError("foreach body must return the same number of "
                             "states as init_states")
        outs_l = _as_list(outs)
        if collected is None:
            collected = [[] for _ in outs_l]
            out_multi = isinstance(outs, (list, tuple))
        for lst, o in zip(collected, outs_l):
            lst.append(o)
    stacked = [_stack(lst) for lst in collected or []]
    return (stacked if out_multi else stacked[0]), cur


def while_loop(cond, func, loop_vars, max_iterations=None):
    """While ``cond(*vars)`` holds and fewer than ``max_iterations``
    steps ran: ``func(*vars) -> (step outputs, new vars)``.  Returns the
    step outputs stacked to ``max_iterations`` rows (zeros after the
    last step) and the final vars."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations")
    from . import zeros

    loop_list = _as_list(loop_vars)
    vars_multi = isinstance(loop_vars, (list, tuple))
    cur = list(loop_list)
    collected, out_multi, steps = None, False, 0
    for _ in range(int(max_iterations)):
        if not _truth(cond(*cur)):
            break
        outs, new_vars = func(*cur)
        outs_l = _as_list(outs)
        if collected is None:
            collected = [[] for _ in outs_l]
            out_multi = isinstance(outs, (list, tuple))
        for lst, o in zip(collected, outs_l):
            lst.append(o)
        cur = _as_list(new_vars)
        steps += 1
    if collected is None:
        # the body never ran: its outputs' shapes from one call, as the
        # JAX op's scan traces it, and every row zero
        outs, _ = func(*cur)
        out_multi = isinstance(outs, (list, tuple))
        collected = [[] for _ in _as_list(outs)]
        probes = _as_list(outs)
    else:
        probes = [lst[0] for lst in collected]
    stacked = []
    for lst, probe in zip(collected, probes):
        pad = [zeros(probe.shape, ctx=probe.context, dtype=probe.dtype)
               for _ in range(int(max_iterations) - steps)]
        stacked.append(_stack(lst + pad))
    outputs = stacked if out_multi else stacked[0]
    return outputs, (cur if vars_multi else cur[0])


def cond(pred, then_func, else_func, inputs=None):
    """``then_func(*inputs)`` if ``pred`` (a scalar array, or a callable
    of ``inputs``) holds, else ``else_func(*inputs)``; branches without
    ``inputs`` are called with none."""
    from .ndarray import NDArray

    in_list = _as_list(inputs) if inputs is not None else []
    if not in_list and not isinstance(pred, NDArray):
        raise MXNetError("cond needs `inputs` and/or an NDArray pred")
    p = pred if isinstance(pred, NDArray) or not callable(pred) \
        else pred(*in_list)
    branch = then_func if _truth(p) else else_func
    return branch(*in_list) if in_list else branch()


def _make(op):
    def stub(*args, **kwargs):
        from .ndarray import NDArray, array

        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = next((a.context for a in args if isinstance(a, NDArray)), None)
        inputs = [a if isinstance(a, NDArray) else array(a, ctx=ctx)
                  for a in args]
        return _reg.invoke(op, inputs, out=out, **kwargs)

    stub.__name__ = op.name
    stub.__doc__ = op.__doc__
    return stub


def _populate():
    from .. import ops  # noqa: F401  (registers the ops)

    g = globals()
    for name in _reg.list_ops():
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            g[short] = _make(_reg.get_op(name))
            __all__.append(short)


_populate()
