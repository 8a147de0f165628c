"""``contrib.onnx`` import across the packages on the CPU: each package
imports the other's file of each graph of ``tests/test_onnx.py``
(``torch_onnx_parity.py``) and runs it; both outputs agree with the
port's eager output within the JAX tests' tolerances (atol 1e-5 / rtol
1e-5; BERT atol 2e-5 / rtol 1e-4; the seq2seq Transformer atol 1e-5 /
rtol 1e-4).
"""
import numpy as np
import pytest

from torch_onnx_parity import CASES, TOL, both, run_jax, run_port


@pytest.mark.parametrize("name", CASES)
def test_each_package_imports_the_others_file(name, tmp_path):
    jpath, tpath, feeds, want = both(name, tmp_path)
    tol = TOL[{"bert_small": "bert", "seq2seq": "seq2seq"}.get(
        name, "default")]
    port_of_jax = run_port(jpath, feeds)
    jax_of_port = run_jax(tpath, feeds)
    assert len(port_of_jax) == len(jax_of_port) == len(want)
    for w, a, b in zip(want, port_of_jax, jax_of_port):
        np.testing.assert_allclose(a, w, **tol)
        np.testing.assert_allclose(b, w, **tol)
