"""The 1-D, 2-D and 3-D convolution and pooling family of the port against
the JAX package's, on the CPU.

The ops (``Convolution`` with ``num_group`` and ``dilate``,
``Deconvolution`` with ``adj``, ``Pooling`` max / avg with and without
``count_include_pad`` / sum / lp (``p_value`` 1 and 2, with exact zeros
in the data) in the ``valid`` and ``full`` conventions and as global
pools, ``im2col`` / ``col2im``) at each rank in both layouts, through
``torch_op_parity``: the forward and the gradient of a seeded cotangent
(``jax.vjp`` against ``torch.autograd.grad``), within 1e-5 relative and
absolute.  ``lp`` at ``p_value`` 2 takes data bounded away from 0,
where the square root's gradient is finite in both.

This file holds the 1-D and 2-D cases (``torch_conv_nd_cases``);
``test_torch_conv_nd_3d.py`` the 3-D ones and the ``gluon.nn`` layers.
"""
import pytest
import torch

from torch_conv_nd_cases import conv_nd_cases
from torch_op_parity import check

CASES = conv_nd_cases((1, 2))


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check(case)


def test_ops_refuse_a_layout_of_another_rank():
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import nn as tops

    x = torch.zeros(1, 2, 5)
    with pytest.raises(MXNetError, match="NCW or NWC"):
        tops.pooling(x, kernel=(2,), layout="NCHW")
    with pytest.raises(MXNetError, match="1, 2 or 3"):
        tops.pooling(torch.zeros(1, 2, 2, 2, 2, 2), kernel=(2,) * 4)
    with pytest.raises(MXNetError, match="2-d kernel on 3-d data"):
        tops.convolution(x, torch.zeros(2, 2, 3, 3), kernel=(3, 3))
