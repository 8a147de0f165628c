"""``contrib.onnx`` export of the port against the JAX package's on the
CPU: for the graphs of ``tests/test_onnx.py`` (conv/bn/pool/fc, the
mini-transformer, BERT-small, the seq2seq Transformer, ResNet-18 and
MobileNet-v2) both packages' ``export_model`` run on one graph file and
one set of weights (``torch_onnx_parity.py``), and the two ONNX models
decode to the same nodes (op_type, inputs, outputs, attributes), the same
graph inputs and outputs, and initializers with the same names, types and
bytes.  A bfloat16 initializer crosses the two codecs bit for bit.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.contrib.onnx import proto as TP
from torch_onnx_parity import CASES, both, decoded


@pytest.mark.parametrize("name", CASES)
def test_export_is_the_jax_export_node_for_node(name, tmp_path):
    jpath, tpath, _, _ = both(name, tmp_path)
    jm, tm = decoded(jpath), decoded(tpath)
    assert jm["opset"] == tm["opset"] == [("", 11)]
    jg, tg = jm["graph"], tm["graph"]
    assert len(tg["node"]) == len(jg["node"]) > 0
    for a, b in zip(jg["node"], tg["node"]):
        assert a == b, (a, b)
    assert tg["input"] == jg["input"] and tg["output"] == jg["output"]
    assert [t["name"] for t in tg["initializer"]] == \
        [t["name"] for t in jg["initializer"]]
    for a, b in zip(jg["initializer"], tg["initializer"]):
        assert (a["data_type"], a["dims"]) == (b["data_type"], b["dims"])
        assert a["array"].dtype == b["array"].dtype
        assert a["array"].tobytes() == b["array"].tobytes(), a["name"]


def test_bfloat16_initializer_crosses_bit_for_bit(tmp_path):
    """A bf16 tensor written by the JAX codec (through its numpy bfloat16
    type) decodes in the port as torch.bfloat16 with the same bits, and
    the port's encoding of that tensor is the JAX bytes."""
    import ml_dtypes

    from mxnet_tpu.contrib.onnx import proto as JP

    arr = (np.random.RandomState(0).randn(3, 5) * 7).astype(
        ml_dtypes.bfloat16)
    jbytes = JP.make_tensor("w", arr)
    got = TP.parse_tensor(jbytes)
    assert got["array_is"] == "torch.bfloat16"
    assert got["array"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["array"].view(torch.int16).numpy().view(np.uint16),
        arr.view(np.uint16))
    assert TP.make_tensor("w", got["array"]) == jbytes
    back = JP.parse_tensor(TP.make_tensor("w", got["array"]))
    np.testing.assert_array_equal(back["array"].view(np.uint16),
                                  arr.view(np.uint16))
