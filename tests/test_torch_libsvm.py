"""``io.LibSVMIter`` against the JAX iterator on small files.

The JAX iterator densifies each batch and converts it to ``csr``; the
port builds the batch's components straight from the parsed rows.  The
batches must agree exactly: ``indptr``, ``indices`` and values, the
labels and ``pad``, in 0-based and 1-based files, with the heuristic's
warning, ``round_batch`` on and off, repeated ids and zero values in a
row, and a separate label file.
"""
import warnings

import numpy as np
import pytest

from mxnet_tpu import io as jio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch.base import MXNetError

N_FEAT = 50
CPU = mx.cpu()


def _write(path, rows, labels, one_based):
    off = 1 if one_based else 0
    with open(path, "w") as f:
        for lab, row in zip(labels, rows):
            f.write(f"{lab:g} " + " ".join(f"{c + off}:{v:g}"
                                           for c, v in row) + "\n")


def _rows(seed, n, top=True):
    """``n`` rows of 0-based (id, value) pairs; some rows repeat an id,
    hold a zero value or are empty; with ``top`` one row uses the last
    id."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        k = rng.randint(0, 8)
        ids = rng.choice(N_FEAT - 1, k, replace=False)
        vals = np.round(rng.uniform(-2, 2, k), 3)
        row = list(zip(ids.tolist(), vals.tolist()))
        if i % 5 == 1 and row:
            row.append((row[0][0], 9.5))  # a repeated id: the last wins
        if i % 7 == 2:
            row.append((int(rng.randint(0, N_FEAT - 1)), 0.0))
        rows.append(row)
    if top:
        rows[3].append((N_FEAT - 1, 1.25))
    return rows, rng.randint(0, 2, n).astype(np.float32)


def _batches(it):
    out = []
    for b in it:
        csr = b.data[0]
        assert csr.stype == "csr"
        out.append({"indptr": csr.indptr.asnumpy().astype(np.int64),
                    "indices": csr.indices.asnumpy().astype(np.int64),
                    "values": csr.data.asnumpy(),
                    "dense": csr.asnumpy(),
                    "label": b.label[0].asnumpy(), "pad": b.pad,
                    "shape": tuple(csr.shape)})
    return out


def _same(got, want):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        for k in ("indptr", "indices", "values", "dense", "label"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["pad"] == w["pad"] and g["shape"] == w["shape"]


@pytest.mark.parametrize("one_based", [False, True])
@pytest.mark.parametrize("round_batch", [True, False])
def test_batches_equal_jax(tmp_path, one_based, round_batch):
    rows, labels = _rows(0, 23)
    path = str(tmp_path / "d.libsvm")
    _write(path, rows, labels, one_based)
    kw = dict(data_shape=(N_FEAT,), batch_size=5, round_batch=round_batch,
              one_based=one_based)
    got = _batches(tio.LibSVMIter(path, ctx=CPU, **kw))
    want = _batches(jio.LibSVMIter(path, **kw))
    _same(got, want)
    assert len(got) == (5 if round_batch else 4)
    if round_batch:
        assert got[-1]["pad"] == 2
        # the filled rows are the file's first rows
        np.testing.assert_array_equal(got[-1]["dense"][3:],
                                      got[0]["dense"][:2])


def test_heuristic_shifts_and_warns_as_jax(tmp_path):
    rows, labels = _rows(1, 12)
    path = str(tmp_path / "h.libsvm")
    _write(path, rows, labels, one_based=True)
    kw = dict(data_shape=(N_FEAT,), batch_size=4)
    with pytest.warns(UserWarning, match="assuming a 1-based file"):
        it = tio.LibSVMIter(path, ctx=CPU, **kw)
    with pytest.warns(UserWarning, match="assuming a 1-based file"):
        jit = jio.LibSVMIter(path, **kw)
    _same(_batches(it), _batches(jit))
    # a 0-based file that reaches n_feat - 1 is left alone, silently
    path0 = str(tmp_path / "z.libsvm")
    _write(path0, rows, labels, one_based=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _batches(tio.LibSVMIter(path0, ctx=CPU, **kw))
    _same(got, _batches(jio.LibSVMIter(path0, **kw)))


def test_label_file_reset_and_descriptors(tmp_path):
    rows, labels = _rows(2, 9)
    path, lpath = str(tmp_path / "d.libsvm"), str(tmp_path / "l.txt")
    _write(path, rows, np.zeros(9), one_based=False)
    with open(lpath, "w") as f:
        f.write("".join(f"{v:g}\n" for v in labels * 3))
    kw = dict(data_shape=(N_FEAT,), label_libsvm=lpath, batch_size=4,
              one_based=False)
    it = tio.LibSVMIter(path, ctx=CPU, **kw)
    first = _batches(it)
    _same(first, _batches(jio.LibSVMIter(path, **kw)))
    it.reset()
    _same(_batches(it), first)
    assert it.provide_data[0].shape == (4, N_FEAT)
    assert it.provide_label[0].shape == (4,)
    assert it.iter_next() is False  # the epoch is spent


def test_out_of_range_and_zero_index_refused(tmp_path):
    path = str(tmp_path / "bad.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1 3:2\n0 60:1\n")
    with pytest.raises(MXNetError, match="out of range"):
        tio.LibSVMIter(path, data_shape=(N_FEAT,), one_based=False,
                       ctx=CPU)
    with pytest.raises(MXNetError, match="one_based=True but found"):
        tio.LibSVMIter(path, data_shape=(N_FEAT,), one_based=True,
                       ctx=CPU)


def test_sparse_dot_of_a_batch_equals_jax(tmp_path):
    from mxnet_tpu import nd as jnd
    from mxnet_tpu.ndarray import sparse as jsparse
    from mxnet_tpu_torch import nd as tnd
    from mxnet_tpu_torch.ndarray import sparse as tsparse

    rows, labels = _rows(3, 16)
    path = str(tmp_path / "d.libsvm")
    _write(path, rows, labels, one_based=True)
    kw = dict(data_shape=(N_FEAT,), batch_size=8, one_based=True)
    w = np.random.RandomState(4).randn(N_FEAT, 1).astype(np.float32)
    r = np.random.RandomState(5).randn(8, 1).astype(np.float32)
    tb = next(iter(tio.LibSVMIter(path, ctx=CPU, **kw))).data[0]
    jb = next(iter(jio.LibSVMIter(path, **kw))).data[0]
    for transpose_a, rhs in ((False, w), (True, r)):
        got = tsparse.dot(tb, tnd.array(rhs, ctx=CPU),
                          transpose_a=transpose_a).asnumpy()
        want = jsparse.dot(jb, jnd.array(rhs),
                           transpose_a=transpose_a).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        dense = tb.asnumpy().astype(np.float64)
        ref = (dense.T if transpose_a else dense) @ rhs.astype(np.float64)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
