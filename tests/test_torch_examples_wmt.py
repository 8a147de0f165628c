"""``python -m mxnet_tpu_torch.examples.train_wmt`` against the JAX
package's ``examples/train_wmt.py`` on the CPU (the helpers and the
tolerance are ``torch_example_parity.py``'s): the first-step loss of the
example's ``--model tiny`` Transformer with the JAX weights carried
across, dropout 0 in both; the file-backed corpus run as a subprocess;
``--dp 2`` refused, naming ROADMAP A.9.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_example_parity import (CPU, assert_loss_close, carry, jax_example,
                                  run_example)


def test_wmt_first_step_loss_is_the_jax_examples():
    from mxnet_tpu.models.transformer import label_smoothed_ce as jlsce
    from mxnet_tpu_torch.examples import train_wmt as tex
    from mxnet_tpu_torch.models.transformer import label_smoothed_ce

    jex = jax_example("train_wmt")
    V = 64
    src, tgt_in, tgt_out = tex.synthetic_batch(np.random.RandomState(0), 4,
                                               8, V)
    for a, b in zip((src, tgt_in, tgt_out), jex.synthetic_batch(
            np.random.RandomState(0), 4, 8, V)):
        np.testing.assert_array_equal(a, b)
    jnet = jex.Transformer(V, units=64, hidden_size=128, num_heads=4,
                           num_layers=2, dropout=0.0)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    jlogits = jnet(jmx.nd.array(src, dtype="int32"),
                   jmx.nd.array(tgt_in, dtype="int32"))
    jloss = float(np.asarray(jlsce(jlogits, jmx.nd.array(
        tgt_out.astype(np.float32)), smoothing=0.1).asnumpy()))
    tnet = tex.build_net("tiny", V)
    for m in tnet.modules():
        if hasattr(m, "rate"):
            m.rate = 0.0
    tnet.initialize(tmx.init.Xavier(), ctx=CPU)
    carry(jnet, tnet)
    tnet.eval()
    with torch.no_grad():
        logits = tnet(torch.from_numpy(src), torch.from_numpy(tgt_in))
        tloss = float(label_smoothed_ce(
            logits, torch.from_numpy(tgt_out.astype(np.float32)),
            smoothing=0.1))
    assert_loss_close(tloss, jloss)


def test_train_wmt_runs(tmp_path):
    """The file-backed corpus path, as test_examples_e2e.py runs it."""
    src_f, tgt_f = tmp_path / "s.txt", tmp_path / "t.txt"
    src_f.write_text("4 5 6 7\n8 9 10\n")
    tgt_f.write_text("7 6 5 4\n10 9 8\n")
    res = run_example("train_wmt", "--model", "tiny", "--vocab-size", 16,
                      "--batch-size", 2, "--steps", 3, "--src", src_f,
                      "--tgt", tgt_f)
    assert res.returncode == 0, (res.stdout[-1500:], res.stderr[-1500:])
    assert "final loss" in res.stdout, res.stdout[-500:]


@pytest.mark.parametrize("mesh", [["--dp", "2"], ["--sp", "4"]])
def test_train_wmt_mesh_arguments_name_a9(mesh):
    from mxnet_tpu_torch.examples import train_wmt

    # a mesh is ported (A.9 part 1): it needs the launcher's processes,
    # and one process says how to start them
    with pytest.raises(SystemExit, match="mxnet_tpu_torch.tools.launch"):
        train_wmt.main(["--model", "tiny", "--device", "cpu"] + mesh)
