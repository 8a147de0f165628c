"""The port's data iterators (``mxnet_tpu_torch/io``) against the JAX
package's (``mxnet_tpu/io``), on the CPU.

``NDArrayIter`` (shuffled by ``(seed, epoch)``, pad, discard, roll-over,
gang parts, ``get_state`` / ``set_state``), ``ResizeIter``, ``CSVIter``
and ``PrefetchingIter`` give the JAX iterators' batches exactly, on the
iterator's device.  ``DevicePrefetchIter`` and ``stage_batches`` stage
batches onto a ``DataParallelStep``'s device through its ``stage`` and
drain it at the end; the staged batches equal the unstaged ones.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tm
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch.parallel import DataParallelStep

CPU = tm.cpu()


def _arrays(n=10):
    data = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    label = np.arange(n, dtype=np.float32)
    return data, label


def _batches(it):
    return [([d.asnumpy() for d in b.data],
             [l.asnumpy() for l in (b.label or [])], b.pad,
             None if b.index is None else np.asarray(b.index)) for b in it]


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp, gi), (wd, wl, wp, wi) in zip(got, want):
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)
        assert gp == wp
        if wi is not None:
            np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, last_batch_handle="discard"),
    dict(batch_size=4, last_batch_handle="roll_over"),
    dict(batch_size=3, shuffle=True, seed=7),
    dict(batch_size=2, shuffle=True, seed=3, num_parts=2, part_index=1),
    dict(batch_size=2, num_parts=2, part_index=0,
         last_batch_handle="discard"),
])
def test_ndarray_iter_matches(kw):
    data, label = _arrays()
    t = tio.NDArrayIter(data, label, ctx=CPU, **kw)
    j = mx.io.NDArrayIter(data, label, **kw)
    for _ in range(2):                    # two epochs: (seed, epoch) order
        _same(_batches(t), _batches(j))
        t.reset()
        j.reset()
    assert t.provide_data == j.provide_data
    assert [d.shape for d in t.provide_label] == [d.shape
                                                  for d in j.provide_label]
    assert t.getdata()[0].context == CPU


def test_ndarray_iter_dict_inputs_and_state():
    data, label = _arrays(9)
    kw = dict(batch_size=2, shuffle=True, seed=5)
    t = tio.NDArrayIter({"a": data, "b": data * 2}, {"y": label}, ctx=CPU,
                        **kw)
    j = mx.io.NDArrayIter({"a": data, "b": data * 2}, {"y": label}, **kw)
    t.next(), t.next()
    j.next(), j.next()
    state = t.get_state()
    assert state == j.get_state()
    t2 = tio.NDArrayIter({"a": data, "b": data * 2}, {"y": label}, ctx=CPU,
                         **kw)
    t2.set_state(state)
    _same(_batches(t2), _batches(j))
    with pytest.raises(tm.MXNetError):
        tio.NDArrayIter(data, label, batch_size=2, num_parts=2,
                        shuffle=True, ctx=CPU)
    with pytest.raises(tm.MXNetError):
        t2.set_state(dict(state, num_data=3))


def test_resize_iter_matches():
    data, label = _arrays()
    t = tio.ResizeIter(tio.NDArrayIter(data, label, batch_size=3, ctx=CPU), 7)
    j = mx.io.ResizeIter(mx.io.NDArrayIter(data, label, batch_size=3), 7)
    _same(_batches(t), _batches(j))
    t.reset()
    j.reset()
    _same(_batches(t), _batches(j))


def test_csv_iter_matches(tmp_path):
    data = np.random.RandomState(0).rand(7, 6).astype(np.float32)
    label = np.arange(7, dtype=np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    for rb in (True, False):
        kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
                  label_csv=str(tmp_path / "l.csv"), batch_size=3,
                  round_batch=rb)
        t, j = tio.CSVIter(ctx=CPU, **kw), mx.io.CSVIter(**kw)
        _same(_batches(t), _batches(j))
        assert t.provide_data[0].shape == (3, 2, 3)


def test_prefetching_iter_matches_and_resets():
    data, label = _arrays()
    t = tio.PrefetchingIter(tio.NDArrayIter(data, label, batch_size=4,
                                            ctx=CPU),
                            rename_data=[{"data": "x"}])
    j = mx.io.PrefetchingIter(mx.io.NDArrayIter(data, label, batch_size=4),
                              rename_data=[{"data": "x"}])
    _same(_batches(t), _batches(j))
    assert t.provide_data[0].name == "x"
    t.reset()
    assert len(_batches(t)) == 3


def _step():
    net = torch.nn.Linear(4, 1)
    return DataParallelStep(net, lambda out, y: ((out[:, 0] - y) ** 2),
                            optimizer="sgd",
                            optimizer_params={"learning_rate": 0.0},
                            device="cpu")


def test_device_prefetch_iter_stages_through_the_step():
    data, label = _arrays()
    step = _step()
    staged = _batches(tio.DevicePrefetchIter(
        tio.NDArrayIter(data, label, batch_size=4, ctx=CPU), step))
    plain = _batches(tio.NDArrayIter(data, label, batch_size=4, ctx=CPU))
    _same(staged, plain)
    s_data, s_label = step.stage(data[:2], label[:2])
    assert s_data[0].context == CPU and s_label.shape == (2,)
    loss = step.step(s_data[0], s_label)
    assert np.isfinite(float(loss))
    step.drain()


def test_stage_batches_over_a_loader():
    data, label = _arrays(8)
    step = _step()
    loader = tm.gluon.data.DataLoader(
        tm.gluon.data.ArrayDataset(data, label), batch_size=4, ctx=CPU)
    got = list(tio.stage_batches(loader, step))
    assert len(got) == 2
    for (x, y), i in zip(got, (0, 4)):
        np.testing.assert_array_equal(x.asnumpy(), data[i:i + 4])
        np.testing.assert_array_equal(y.asnumpy(), label[i:i + 4])
    staged = list(tm.gluon.data.DataLoader(
        tm.gluon.data.ArrayDataset(data, label), batch_size=4, ctx=CPU,
        prefetch_to=step))
    np.testing.assert_array_equal(staged[1][0].asnumpy(), data[4:])


def test_data_desc_and_batch():
    d = tio.DataDesc("data", (2, 3))
    assert (d.name, d.shape, d.layout) == ("data", (2, 3), "NCHW")
    assert repr(d) == repr(mx.io.DataDesc("data", (2, 3)))
    assert tio.DataDesc.get_batch_axis("NHWC") == 0
    with pytest.raises(tm.MXNetError):
        tio.DataBatch(np.zeros(2))
    assert "data shapes" in str(tio.DataBatch([tm.nd.zeros((2, 3), ctx=CPU)]))
