"""The port's layer, warping and contrib ops (``mxnet_tpu_torch/ops/nn.py``,
``ops/warp_ops.py``, ``ops/contrib_ops.py``) against the JAX package's
(``mxnet_tpu/ops/nn.py``, ``warp_ops.py``, ``contrib_ops.py``) on the
CPU, one case per op and attribute set (``torch_op_parity``), and the
registry as a whole: the port holds exactly the JAX registry's op names,
and every op of the ten modules this port mirrors has a parity case in
one of the ``test_torch_ops_*`` files, ``test_torch_rnn.py`` or (the
random ops, by distribution) ``test_torch_ops_random.py``.

The legacy output ops (``SoftmaxOutput``, the three regression outputs,
``MakeLoss``, ``SVMOutput``) are checked on their gradients, which
ignore the incoming cotangent in both packages.  ``ctc_loss`` runs both
blank conventions with and without explicit lengths.  ``UpSampling``
(bilinear) and ``BilinearResize2D`` hold the port's separable weights to
``jax.image.resize``, antialiased when shrinking.

Tolerances: 1e-6 for moves and masks; 1e-5 (relative and absolute) for
products, normalizations, resizing and sampling; 1e-4 on the gradients
of ``ctc_loss`` and ``DeformableConvolution`` (long chains of f32
products in different orders).  The JAX ops built of many small ones
run jitted (``torch_op_parity``).
"""
import importlib

import numpy as np
import pytest

from torch_op_parity import Case, check, ints, rng_for, uniform

F5 = dict(rtol=1e-5, atol=1e-5, grad_rtol=1e-5, grad_atol=1e-5)
F4 = dict(rtol=1e-5, atol=1e-5, grad_rtol=1e-4, grad_atol=1e-4)
J5 = dict(F5, jit=True)
J4 = dict(F4, jit=True)


def _ctc_labels(first):
    lab = np.array([[1, 2, 2, 0], [3, 1, 0, 0], [4, 0, 0, 0]], np.float32)
    return lab if first else np.where(lab > 0, lab - 1, -1).astype(
        np.float32)


def _cases():
    r = rng_for("nn")
    c = []
    img = uniform(r, (2, 4, 5, 5))
    c += [
        Case("Deconvolution", [img, uniform(r, (4, 3, 3, 3)),
                               uniform(r, (3,))],
             {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "adj": (1, 1), "num_filter": 3, "no_bias": False}, **F5),
        Case("Deconvolution", [img, uniform(r, (4, 2, 3, 3))],
             {"kernel": (3, 3), "num_filter": 4, "num_group": 2,
              "dilate": (2, 2)}, tag="group", **F5),
        Case("Deconvolution", [img.transpose(0, 2, 3, 1).copy(),
                               uniform(r, (4, 3, 3, 3))],
             {"kernel": (3, 3), "stride": (2, 2), "num_filter": 3,
              "layout": "NHWC"}, tag="nhwc", **F5),
        Case("softmin", [uniform(r, (3, 5))], {"axis": 0,
                                                "temperature": 2.0}, **F5),
        Case("SoftmaxActivation", [uniform(r, (2, 3, 4))], **F5),
        Case("SoftmaxActivation", [uniform(r, (2, 3, 4))],
             {"mode": "channel"}, tag="channel", **F5),
        Case("InstanceNorm", [uniform(r, (2, 3, 4, 5)), uniform(r, (3,)),
                              uniform(r, (3,))], {"eps": 1e-3}, **F5),
        Case("GroupNorm", [uniform(r, (2, 4, 3, 3)), uniform(r, (4,)),
                           uniform(r, (4,))], {"num_groups": 2}, **F5),
        Case("LRN", [uniform(r, (2, 6, 3, 3))], {"nsize": 5, "alpha": 0.01},
             **F5),
        Case("Dropout", [uniform(r, (3, 4))], key_at=1),
        Case("Dropout", [uniform(r, (3, 4))], {"training": True, "p": 0.0},
             key_at=1, tag="p0"),
        Case("UpSampling", [uniform(r, (2, 3, 3, 4))], {"scale": 2}),
        Case("UpSampling", [uniform(r, (2, 3, 3, 4))],
             {"scale": 2, "sample_type": "bilinear"}, tag="bilinear", **F5),
        Case("BilinearResize2D", [uniform(r, (2, 3, 4, 5))],
             {"height": 7, "width": 9}, **F5),
        Case("BilinearResize2D", [uniform(r, (2, 3, 8, 9))],
             {"height": 3, "width": 4}, tag="shrink", **F5),
        Case("BilinearResize2D", [uniform(r, (2, 3, 4, 6))],
             {"scale_height": 1.5, "scale_width": 0.5}, tag="scale", **F5),
    ]
    logits = uniform(r, (4, 5), -2, 2)
    lab = np.array([0, 2, 4, 2], np.float32)
    c += [
        Case("SoftmaxOutput", [logits, lab], grad=(0,), **F5),
        Case("SoftmaxOutput", [logits, lab],
             {"use_ignore": True, "ignore_label": 2.0,
              "normalization": "valid", "grad_scale": 2.0}, grad=(0,),
             tag="ignore_valid", **F5),
        Case("SoftmaxOutput", [uniform(r, (2, 3, 4)),
                               ints(r, (2, 4), 0, 3)],
             {"multi_output": True, "normalization": "batch",
              "smooth_alpha": 0.1}, grad=(0,), tag="multi", **F5),
    ]
    d, y = uniform(r, (4, 3)), uniform(r, (4, 3))
    c += [Case(op, [d, y], {"grad_scale": 0.5}, grad=(0,), **F5)
          for op in ("LinearRegressionOutput", "MAERegressionOutput",
                     "LogisticRegressionOutput")]
    c += [Case("MakeLoss", [d], {"grad_scale": 0.5,
                                 "normalization": n, "valid_thresh": 0.1},
               tag=n, **F5) for n in ("null", "batch", "valid")]
    c += [Case("SVMOutput", [logits, lab], {"margin": 0.5,
                                            "use_linear": lin,
                                            "regularization_coefficient": 0.3},
               grad=(0,), tag=f"linear{int(lin)}", **F5)
          for lin in (False, True)]
    acts = uniform(r, (6, 3, 5), -2, 2)
    for first in (True, False):
        blank = "first" if first else "last"
        c.append(Case("ctc_loss", [acts, _ctc_labels(first)],
                      {"blank_label": blank}, grad=(0,), tag=blank, **J4))
    c.append(Case("ctc_loss", [acts, _ctc_labels(True),
                               np.array([6, 5, 4], np.float32),
                               np.array([2, 2, 1], np.float32)],
                  {"use_data_lengths": True, "use_label_lengths": True},
                  grad=(0,), tag="lengths", **J4))
    widths = (0, 0, 0, 0, 1, 2, 2, 1)
    c += [Case("Pad", [img], {"mode": m, "pad_width": widths,
                              "constant_value": -0.5}, tag=m)
          for m in ("constant", "edge", "reflect")]
    c += [
        Case("Crop", [img], {"h_w": (2, 3), "offset": (1, 1)}),
        Case("Crop", [img], {"h_w": (3, 3), "center_crop": True},
             tag="center"),
        Case("Crop", [img, uniform(r, (2, 4, 3, 2))], {"num_args": 2},
             grad=(0,), tag="like"),
        Case("moments", [uniform(r, (2, 3, 4))], {"axes": (0, 2)}, **F5),
        Case("moments", [uniform(r, (2, 3, 4))],
             {"axes": (1,), "keepdims": True}, tag="keep", **F5),
        Case("im2col", [img], {"kernel": (3, 3), "stride": (2, 2),
                               "pad": (1, 1)}),
        Case("im2col", [img], {"kernel": (2, 3), "dilate": (2, 1)},
             tag="dilate"),
        Case("col2im", [uniform(r, (2, 36, 9))],
             {"output_size": (5, 5), "kernel": (3, 3), "stride": (2, 2),
              "pad": (1, 1)}, **F5),
    ]
    # warp
    c += [
        Case("BilinearSampler", [uniform(r, (2, 3, 4, 5)),
                                 uniform(r, (2, 2, 3, 4), -1.1, 1.1)], **J5),
        Case("GridGenerator", [uniform(r, (2, 6))],
             {"target_shape": (3, 4)}, **F5),
        Case("GridGenerator", [uniform(r, (2, 2, 3, 4), -2, 2)],
             {"transform_type": "warp"}, tag="warp", **F5),
        Case("SpatialTransformer",
             [uniform(r, (2, 3, 4, 5)),
              (np.array([1, 0, 0, 0, 1, 0], np.float32)
               + uniform(r, (2, 6), -0.2, 0.2))],
             {"target_shape": (3, 4)}, **F5),
        Case("Correlation", [uniform(r, (1, 3, 6, 6)),
                             uniform(r, (1, 3, 6, 6))],
             {"max_displacement": 2, "pad_size": 2}, **J5),
        Case("Correlation", [uniform(r, (1, 3, 7, 7)),
                             uniform(r, (1, 3, 7, 7))],
             {"kernel_size": 3, "max_displacement": 2, "stride1": 2,
              "stride2": 2, "pad_size": 3, "is_multiply": False},
             tag="window_abs", **J5),
    ]
    # contrib
    qkv = uniform(r, (4, 2, 18))
    c += [
        Case("_contrib_interleaved_matmul_selfatt_qk", [qkv], {"heads": 2},
             **F5),
        Case("_contrib_interleaved_matmul_selfatt_valatt",
             [qkv, uniform(r, (4, 4, 4))], {"heads": 2}, **F5),
        Case("_contrib_AdaptiveAvgPooling2D", [uniform(r, (2, 3, 7, 5))],
             {"output_size": (3, 2)}, **J5),
        Case("_contrib_AdaptiveAvgPooling2D", [uniform(r, (2, 3, 4, 4))],
             tag="global", **J5),
        Case("_contrib_DeformableConvolution",
             [uniform(r, (1, 4, 5, 5)), uniform(r, (1, 36, 3, 3)),
              uniform(r, (6, 4, 3, 3)), uniform(r, (6,))],
             {"kernel": (3, 3), "num_filter": 6,
              "num_deformable_group": 2}, **J4),
        Case("_contrib_DeformableConvolution",
             [uniform(r, (1, 4, 5, 5)), uniform(r, (1, 18, 2, 2)),
              uniform(r, (6, 2, 3, 3))],
             {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
              "stride": (2, 2), "no_bias": True}, tag="group", **J4),
        Case("histogram", [uniform(r, (20,), 0, 1)],
             {"bin_cnt": 5, "range": (0.0, 1.0)}),
        Case("histogram", [uniform(r, (20,), 0, 1),
                           np.array([0, 0.2, 0.5, 1.0], np.float32)],
             tag="edges"),
        Case("histogram", [uniform(r, (20,))], {"bins": 4}, tag="auto"),
    ]
    return c


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check(case)


def test_registry_holds_the_jax_registry():
    import mxnet_tpu.ops  # noqa: F401
    import mxnet_tpu_torch.ops  # noqa: F401
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    assert set(treg._OPS) == set(jreg._OPS)
    for name in jreg._OPS:
        assert treg._OPS[name].differentiable == jreg._OPS[name].differentiable


# the JAX modules this slice ports; every op registered there has a case
PORTED = ("elemwise", "creation", "reduce_ops", "matrix", "indexing", "nn",
          "random_ops", "rnn_ops", "contrib_ops", "warp_ops")
CASE_FILES = ("test_torch_ops_elemwise", "test_torch_ops_matrix",
              "test_torch_ops_reduce_index", "test_torch_ops_nn",
              "test_torch_rnn")
# covered elsewhere: the fused-kernel ops by their kernel tests
# (test_torch_kernels.py, test_torch_ndarray.py), the layer ops of the
# ResNet and BERT paths by test_torch_resnet.py / test_torch_ndarray.py
ELSEWHERE = {"FullyConnected", "Convolution", "Pooling", "Activation",
             "LeakyReLU", "softmax", "log_softmax", "softmax_cross_entropy",
             "LayerNorm", "BatchNorm", "_contrib_add_layer_norm",
             "_contrib_flash_attention"}


def test_every_ported_op_has_a_parity_case():
    from mxnet_tpu.ops import registry as jreg

    covered = set(ELSEWHERE)
    for name in CASE_FILES:
        covered |= {c.op for c in importlib.import_module(name).CASES}
    covered |= set(importlib.import_module("test_torch_ops_random").OPS)
    ported = {n for n, op in jreg._OPS.items()
              if op.fn.__module__.rsplit(".", 1)[-1] in PORTED}
    assert len(ported) > 230
    assert sorted(ported - covered) == []
