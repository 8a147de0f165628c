"""The port's kvstore over processes and device lists, its Trainer, and
its launcher.

One gloo group of 2 CPU processes (``tests/torch_dist_cases.py
kvstore``, through ``python -m mxnet_tpu_torch.tools.launch``) repeats the
JAX package's dist_sync worker (``tests/dist/dist_sync_kvstore_worker.py``:
push sums, rank 0's ``init`` broadcast, the server-side SGD), counts
``push_bucketed``'s flat buckets, and trains a Trainer with
``kvstore="dist_sync"`` on half of each batch per process, which must
equal one process on the whole batches.  In one process: ``split_and_load``
over ``[cpu(0), cpu(1)]`` with the ``device`` store equals one device, and
the JAX Trainer over the same two contexts; ``create`` maps the types as
the JAX one does.  The launcher rejects a missing command and exits
non-zero when a worker does.  The same gloo group then runs
``examples.bert_pretrain`` on a dp1 x sp2 mesh (Ulysses), which must
print the one-process run's losses.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_dist_cases as cases  # noqa: E402

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_kvstore")
    assert cases.start_group(out, 2, "kvstore", "bert_pretrain")() == 0
    got = [dict(np.load(out / f"kvstore-{r}.npz")) for r in range(2)]
    got[0]["bert_pretrain"] = (out / "bert_pretrain-0.txt").read_text()
    return got


@pytest.mark.parametrize("rank", [0, 1])
def test_dist_sync_push_pull_and_init(results, rank):
    got = results[rank]
    assert int(got["num_workers"]) == 2 and int(got["rank"]) == rank
    np.testing.assert_array_equal(got["push_sum"], np.full((4, 3), 3.0))
    np.testing.assert_array_equal(got["init_broadcast"],
                                  np.full((4, 3), 7.0))
    np.testing.assert_allclose(got["server_sgd"],
                               np.full((4, 3), 1.0 - 0.1 * 3 * 4),
                               rtol=1e-6)


@pytest.mark.parametrize("rank", [0, 1])
def test_agree_resume_step_takes_the_minimum(results, rank):
    assert int(results[rank]["resume_step"]) == 10


@pytest.mark.parametrize("rank", [0, 1])
def test_push_bucketed_counts_buckets_and_sums(results, rank):
    got = results[rank]
    assert int(got["n_buckets"]) == 3  # 6 keys of 32 bytes, 64 a bucket
    want = np.stack([np.full(8, 2 * k + 1.0) for k in range(10, 16)])
    np.testing.assert_array_equal(got["bucket_sums"], want)


@pytest.mark.parametrize("rank", [0, 1])
def test_dist_sync_trainer_equals_one_process(results, rank):
    one = cases.trainer_run(kvstore="device")
    for name, want in one.items():
        np.testing.assert_allclose(results[rank][f"trainer-{name}"], want,
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def _device_list_run(mx, gluon, nd, autograd, ctxs):
    mx.random.seed(0)
    torch.manual_seed(0)
    np.random.seed(0)
    net = gluon.nn.Dense(3, in_units=4, prefix="dl_")
    net.initialize(mx.init.Xavier(), ctx=ctxs)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            kvstore="device")
    for x, y in cases.trainer_batches():
        xs = gluon.utils.split_and_load(nd.array(x, ctx=ctxs[0]), ctxs)
        ys = gluon.utils.split_and_load(nd.array(y, ctx=ctxs[0]), ctxs)
        with autograd.record():
            losses = [((net(a) - b) ** 2).sum() for a, b in zip(xs, ys)]
        autograd.backward(losses)
        trainer.step(x.shape[0])
    return net


def test_device_list_parameters_and_split_and_load():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    ctxs = [mx.cpu(0), mx.cpu(1)]
    net = _device_list_run(mx, gluon, nd, autograd, ctxs)
    one = _device_list_run(mx, gluon, nd, autograd, [mx.cpu(0)])
    for (name, p), q in zip(net.collect_params().items(),
                            one.collect_params().values()):
        assert p.list_ctx() == ctxs
        copies = p.list_data()
        assert len(copies) == 2
        assert copies[0]._data.data_ptr() != copies[1]._data.data_ptr()
        assert p.data(mx.cpu(1)) is copies[1]
        for c in copies:
            np.testing.assert_allclose(c.asnumpy(), q.data().asnumpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    parts = gluon.utils.split_and_load(
        nd.array(np.zeros((4, 2), np.float32), ctx=mx.cpu()), ctxs)
    assert [a.context for a in parts] == ctxs


def test_device_list_matches_jax_trainer():
    """The same device-list loop in the JAX package (its contexts are
    distinct virtual devices) from the port's initial weights."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu import autograd as jautograd
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import nd as jnd
    from mxnet_tpu_torch import autograd, gluon, nd

    ctxs = [mx.cpu(0), mx.cpu(1)]
    mx.random.seed(0)
    torch.manual_seed(0)
    start = gluon.nn.Dense(3, in_units=4, prefix="dl_")
    start.initialize(mx.init.Xavier(), ctx=mx.cpu())
    init = {k: p.data().asnumpy() for k, p in start.collect_params().items()}
    net = _device_list_run(mx, gluon, nd, autograd, ctxs)

    jctxs = [jmx.cpu(0), jmx.cpu(1)]
    jnet = jgluon.nn.Dense(3, in_units=4, prefix="dl_")
    jnet.initialize(jmx.init.Zero(), ctx=jctxs)
    for k, p in jnet.collect_params().items():
        p.set_data(init[k])
    trainer = jgluon.Trainer(jnet.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9},
                             kvstore="device")
    for x, y in cases.trainer_batches():
        xs = jgluon.utils.split_and_load(jnd.array(x), jctxs)
        ys = jgluon.utils.split_and_load(jnd.array(y), jctxs)
        with jautograd.record():
            losses = [((jnet(a) - b) ** 2).sum() for a, b in zip(xs, ys)]
        jautograd.backward(losses)
        trainer.step(x.shape[0])
    for (name, p), jp in zip(net.collect_params().items(),
                             jnet.collect_params().values()):
        for c, jc in zip(p.list_data(), jp.list_data()):
            np.testing.assert_allclose(c.asnumpy(), jc.asnumpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name,kind", [
    ("local", "local"), ("device", "device"), ("nccl", "device"),
    ("local_allreduce_device", "device")])
def test_create_maps_types_as_jax(name, kind):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx

    assert mx.kv.create(name).type == kind == jmx.kv.create(name).type


def test_dist_async_raises():
    import mxnet_tpu_torch as mx

    with pytest.raises(mx.MXNetError, match="dist_async"):
        mx.kv.create("dist_async")


def test_launcher_rejects_a_missing_command(capsys):
    from mxnet_tpu_torch.tools import launch

    with pytest.raises(SystemExit) as exc:
        launch.main(["-n", "2", "--force-cpu"])
    assert exc.value.code != 0
    assert "no worker command" in capsys.readouterr().err


def test_launcher_exits_nonzero_when_a_worker_fails(capfd):
    from mxnet_tpu_torch.tools import launch

    worker = ("import os, sys, time; r = int(os.environ['MX_PROC_ID']); "
              "print('rank', r, os.environ['DMLC_NUM_WORKER'], flush=True); "
              "time.sleep(0.2 if r else 30); sys.exit(3 if r else 0)")
    rc = launch.main(["-n", "2", "--term-timeout", "2", sys.executable,
                      "-c", worker])
    assert rc == 3
    assert "[rank 1] rank 1 2" in capfd.readouterr().out


def _losses(text):
    return [line.split("loss")[1].split()[0].strip("=")
            for line in text.splitlines() if "loss" in line]


def test_bert_pretrain_example_over_the_launcher(results, capsys):
    from mxnet_tpu_torch.examples import bert_pretrain

    meshed = results[0]["bert_pretrain"]
    bert_pretrain.main(cases.BERT_PRETRAIN_ARGS)
    one = capsys.readouterr().out
    assert "on mesh dp1xsp2xpp1xtp1" in meshed
    assert _losses(meshed) == _losses(one) and len(_losses(one)) == 2
