"""The 3-D convolution and pooling ops, and the ``gluon.nn`` convolution
and pooling layers of every rank, of the port against the JAX package's
on the CPU.

The ops: ``tests/test_torch_conv_nd.py``'s cases (``torch_conv_nd_cases``)
on NCDHW and NDHWC data, within 1e-5 relative and absolute on the forward
and the gradient.  The layers: each of the 18 classes has the JAX layer's
``collect_params()`` names and Gluon shapes after one forward, and, with
the JAX layer's values carried by ``convert.from_mxnet_tpu_params``,
gives its output within 1e-5; the Gluon layout comes back out as the JAX
layer's values, bit for bit.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import from_mxnet_tpu_params, gluon_name
from torch_conv_nd_cases import SPATIAL, conv_nd_cases, last
from torch_op_parity import check, rng_for, uniform

CASES = conv_nd_cases((3,))


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check(case)


# ---------------------------------------------------------------------------
# the gluon.nn layers
# ---------------------------------------------------------------------------
# name -> (the constructor's arguments, the input's spatial rank, layout)
LAYERS = {
    "Conv1D": ((6, 3), dict(strides=2, padding=1, groups=2,
                            activation="relu"), 1, "NCW"),
    "Conv1D-nwc": ((6, 3), dict(dilation=2), 1, "NWC"),
    "Conv2D": ((6, (3, 2)), dict(strides=(2, 1), padding=(1, 0)), 2,
               "NCHW"),
    "Conv2D-nhwc": ((6, 3), dict(groups=2, use_bias=False), 2, "NHWC"),
    "Conv3D": ((6, 3), dict(padding=1, activation="tanh"), 3, "NCDHW"),
    "Conv3D-ndhwc": ((6, (2, 3, 1)), dict(strides=2), 3, "NDHWC"),
    "Conv1DTranspose": ((6, 3), dict(strides=2, padding=1,
                                     output_padding=1), 1, "NCW"),
    "Conv1DTranspose-nwc": ((6, 3), dict(groups=2), 1, "NWC"),
    "Conv2DTranspose": ((6, 3), dict(strides=2, output_padding=1,
                                     groups=2), 2, "NCHW"),
    "Conv2DTranspose-nhwc": ((6, (3, 2)), dict(padding=(1, 0)), 2, "NHWC"),
    "Conv3DTranspose": ((6, 2), dict(strides=2, use_bias=False), 3,
                        "NCDHW"),
    "Conv3DTranspose-ndhwc": ((6, 3), dict(padding=1, activation="relu"),
                              3, "NDHWC"),
    "MaxPool1D": ((), dict(pool_size=3, strides=2, ceil_mode=True), 1,
                  "NCW"),
    "MaxPool2D": ((), dict(pool_size=3, strides=2, padding=1), 2, "NHWC"),
    "MaxPool3D": ((), dict(pool_size=2), 3, "NDHWC"),
    "AvgPool1D": ((), dict(pool_size=3, padding=1,
                           count_include_pad=False), 1, "NWC"),
    "AvgPool2D": ((), dict(pool_size=2, ceil_mode=True), 2, "NCHW"),
    "AvgPool3D": ((), dict(pool_size=3, strides=2, padding=1), 3, "NCDHW"),
    "GlobalMaxPool1D": ((), {}, 1, "NCW"),
    "GlobalMaxPool2D": ((), {}, 2, "NHWC"),
    "GlobalMaxPool3D": ((), {}, 3, "NDHWC"),
    "GlobalAvgPool1D": ((), {}, 1, "NWC"),
    "GlobalAvgPool2D": ((), {}, 2, "NCHW"),
    "GlobalAvgPool3D": ((), {}, 3, "NCDHW"),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_names_shapes_and_output_match_jax(name):
    cls = name.split("-")[0]
    args, kw, n, layout = LAYERS[name]
    prefix = f"{cls.lower()}_probe_"
    jl = getattr(jmx.gluon.nn, cls)(*args, layout=layout, prefix=prefix,
                                    **kw)
    tl = getattr(tmx.gluon.nn, cls)(*args, layout=layout, prefix=prefix,
                                    **kw)
    r = rng_for(f"layer/{name}")
    x = uniform(r, (2, 4) + SPATIAL[n])
    if layout.endswith("C"):
        x = last(x)
    jmx.random.seed(0)
    jl.initialize(jmx.init.Xavier())
    want = jl(jmx.nd.array(x)).asnumpy()
    tl.initialize(tmx.init.Uniform(0.5), ctx=tmx.cpu())
    tl(tmx.nd.array(x, ctx=tmx.cpu()))
    jp, tp = jl.collect_params(), tl.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    assert [p.shape for p in tp.values()] == [p.shape for p in jp.values()]
    from_mxnet_tpu_params(tl, {k: p.data().asnumpy() for k, p in jp.items()},
                          prefix)
    got = tl(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the file's Gluon layout back out of the port's
    for k, p in tp.items():
        np.testing.assert_array_equal(p._reduce().numpy(),
                                      jp[k].data().asnumpy())
    if cls.startswith("Conv"):
        assert gluon_name(tl, "weight") == "weight"
