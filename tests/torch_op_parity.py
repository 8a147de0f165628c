"""The harness of the ``test_torch_ops_*`` files: one registered op of the
port against the JAX package's op of the same name, on the CPU.

A :class:`Case` holds numpy inputs drawn from a seed and the op's
attributes.  :func:`check` runs the JAX op (eagerly, op by op) and the
port's on the same inputs and compares every output: integer and bool
outputs, and every output of a case marked ``exact``, bit for bit;
floats within the case's ``rtol`` / ``atol``.  The dtypes must agree, up
to the JAX package's canonicalization (without x64 an int64 the op asks
for is int32 there).  Where the JAX op is differentiable, the gradients
of a seeded random cotangent with respect to the case's float inputs
(``grad``: their indices, every float input by default) are compared
through ``jax.vjp`` and ``torch.autograd.grad``, within ``grad_rtol`` /
``grad_atol``.  The JAX ops that draw (``Dropout``, ``_fused_rnn``) take
a key input the port's lack: ``key_at`` is where the JAX op takes it (a
fixed key; the cases draw nothing).  A case marked ``jit`` runs the
JAX op and its vjp as one jitted program each (the ops built of many
small ones, which eager dispatch runs slowly), on tolerances that allow
XLA's fusion to contract multiply-adds.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg


@dataclasses.dataclass
class Case:
    op: str
    inputs: Sequence[np.ndarray]
    attrs: dict = dataclasses.field(default_factory=dict)
    grad: Optional[Sequence[int]] = None
    rtol: float = 1e-6
    atol: float = 1e-6
    grad_rtol: float = 1e-5
    grad_atol: float = 1e-5
    exact: bool = False
    tag: str = ""
    key_at: Optional[int] = None
    jit: bool = False

    @property
    def id(self):
        return self.op + (f"-{self.tag}" if self.tag else "")


def rng_for(name: str) -> np.random.RandomState:
    """A RandomState seeded by a name, so a case's inputs do not depend on
    the order of the table."""
    return np.random.RandomState(zlib.crc32(name.encode()) & 0x7FFFFFFF)


def uniform(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def ints(rng, shape, lo=0, hi=3, dtype=np.float32):
    return rng.randint(lo, hi, shape).astype(dtype)


def _listify(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _is_float(a) -> bool:
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _compare(got, want, case, what, rtol, atol):
    assert len(got) == len(want), f"{what}: {len(got)} vs {len(want)} outputs"
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = np.asarray(g)
        assert g.shape == w.shape, f"{what}[{i}] shape {g.shape} vs {w.shape}"
        if case.exact or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{what}[{i}]")


def _torch_dtype_as_jax(t: torch.Tensor):
    np_dt = torch.empty((), dtype=t.dtype).numpy().dtype
    return np.dtype(jax.dtypes.canonicalize_dtype(np_dt))


def check(case: Case) -> None:
    jop, top = jreg.get_op(case.op), treg.get_op(case.op)
    assert jop.differentiable == top.differentiable
    attrs = dict(case.attrs)
    jx = [jnp.asarray(a) for a in case.inputs]
    tx = [torch.from_numpy(np.array(a)) for a in case.inputs]
    gi = [i for i, a in enumerate(case.inputs) if _is_float(a)] \
        if case.grad is None else list(case.grad)
    if not jop.differentiable:
        gi = []
    if case.key_at is not None:
        jx.insert(case.key_at, jax.random.PRNGKey(0))
    jgi = [i + (case.key_at is not None and i >= case.key_at) for i in gi]
    for i in gi:
        tx[i].requires_grad_(True)
    with torch.enable_grad():
        tout = _listify(top.fn(*tx, **attrs))
    jfwd = lambda *a: jop.fn(*a, **attrs)  # noqa: E731
    jout = _listify((jax.jit(jfwd) if case.jit else jfwd)(*jx))
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert _torch_dtype_as_jax(t) == np.dtype(j.dtype), (
            f"output {i} dtype {t.dtype} vs {j.dtype}")
    _compare([t.detach().numpy() for t in tout], jout, case, "forward",
             case.rtol, case.atol)
    if not gi:
        return
    rng = rng_for(case.id + "/ct")
    float_out = [k for k, j in enumerate(jout) if _is_float(j)]
    cts = {k: rng.standard_normal(np.shape(jout[k])).astype(
        np.asarray(jout[k]).dtype) for k in float_out}

    def jfun(*diff):
        args = list(jx)
        for i, d in zip(jgi, diff):
            args[i] = d
        out = _listify(jop.fn(*args, **attrs))
        return [out[k] for k in float_out]

    def jgrad(prim, ct):
        return jax.vjp(jfun, *prim)[1](ct)

    jgrads = (jax.jit(jgrad) if case.jit else jgrad)(
        [jx[i] for i in jgi], [jnp.asarray(cts[k]) for k in float_out])
    outs = [tout[k] for k in float_out if tout[k].requires_grad]
    seeds = [torch.from_numpy(cts[k]) for k in float_out
             if tout[k].requires_grad]
    if outs:
        tgrads = torch.autograd.grad(outs, [tx[i] for i in gi], seeds,
                                     allow_unused=True)
    else:
        tgrads = [None] * len(gi)
    tgrads = [np.zeros(tx[i].shape, np.float32) if g is None
              else g.numpy() for i, g in zip(gi, tgrads)]
    _compare(tgrads, [np.asarray(g) for g in jgrads],
             dataclasses.replace(case, exact=False), "grad", case.grad_rtol,
             case.grad_atol)
