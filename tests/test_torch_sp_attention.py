"""The port's sequence-parallel attention routes vs the JAX package's.

One gloo group of 4 CPU processes (``tests/torch_dist_cases.py
attention``) runs ``ring_self_attention``, ``ulysses_self_attention`` and
the K/V-gather route (``parallel.ring.gather_attention``) on an sp4 mesh,
causal and not, each rank on its L/4 block of the same numpy q, k, v and
output cotangent (N 8, L 64, D 16).  The JAX side runs the functions of
the same names on a 4-device ``sp`` mesh of its virtual CPU devices, and,
for the gather, ``_contrib_flash_attention`` with no scope (what GSPMD
computes for the JAX step), with gradients from ``jax.vjp``.  Outputs and
q/k/v gradients, the ranks' blocks put together, agree within 2e-5 of
max |JAX|.  The same holds on meshes over permuted device lists (an sp4
mesh over ranks [2, 0, 3, 1], and dp2 x sp2 over [1, 0, 3, 2], whose sp
slices are not in their process groups' order).
"""
import os
import sys

import jax
import numpy as np
import pytest

from mxnet_tpu.ops.contrib_ops import flash_attention_op
from mxnet_tpu.parallel import make_mesh
from mxnet_tpu.parallel.ring import ring_self_attention
from mxnet_tpu.parallel.ulysses import ulysses_self_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_dist_cases as cases  # noqa: E402

TOL = 2e-5


def _jax_routes():
    mesh = make_mesh(sp=4, devices=jax.devices("cpu")[:4])
    return {
        "ring": lambda q, k, v, c: ring_self_attention(mesh, q, k, v,
                                                       causal=c),
        "ulysses": lambda q, k, v, c: ulysses_self_attention(mesh, q, k, v,
                                                             causal=c),
        "gather": lambda q, k, v, c: flash_attention_op(q, k, v, causal=c),
    }


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp_attention")
    wait = cases.start_group(out, 4, "attention")
    q, k, v, do = cases.attention_inputs()
    ref = {}
    for name, fn in _jax_routes().items():
        for causal in (False, True):
            def fwd_bwd(a, b, c, g, fn=fn, causal=causal):
                o, vjp = jax.vjp(lambda x, y, z: fn(x, y, z, causal), a, b, c)
                return (o,) + tuple(vjp(g))

            key = f"{name}-{int(causal)}"
            for what, val in zip(("out", "dq", "dk", "dv"),
                                 jax.jit(fwd_bwd)(q, k, v, do)):
                ref[f"{key}-{what}"] = np.asarray(val)
    assert wait() == 0
    parts = [dict(np.load(out / f"attention-{r}.npz")) for r in range(4)]
    return parts, ref


def _assembled(parts, prefix, dp=0):
    """The blocks of the ranks at ``dp`` of a mesh, in its sp order."""
    mine = sorted((p for p in parts if int(p[prefix + "coords"][0]) == dp),
                  key=lambda p: int(p[prefix + "coords"][1]))
    return {key[len(prefix):]: np.concatenate([p[key] for p in mine], axis=1)
            for key in mine[0]
            if key.startswith(prefix) and not key.endswith("coords")
            and (prefix or "/" not in key)}


def _check(got, ref, key):
    want = ref[key]
    err = np.abs(got[key] - want).max() / np.abs(want).max()
    assert err <= TOL, (key, err)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("route", ["ring", "ulysses", "gather"])
@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
def test_sp_attention_matches_jax(results, route, causal, what):
    parts, ref = results
    _check(_assembled(parts, ""), ref, f"{route}-{int(causal)}-{what}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("route", ["ring", "ulysses", "gather"])
@pytest.mark.parametrize("mesh,dp", [("perm_sp4", 0), ("perm_dp2sp2", 0),
                                     ("perm_dp2sp2", 1)])
def test_sp_attention_on_a_permuted_device_list(results, mesh, dp, route,
                                                causal):
    """A mesh over a permuted device list (``make_mesh(devices=...)``):
    each rank's block is its mesh index's, whatever its group rank."""
    parts, ref = results
    got = _assembled(parts, f"{mesh}/", dp)
    for what in ("out", "dq", "dk", "dv"):
        _check(got, ref, f"{route}-{int(causal)}-{what}")
