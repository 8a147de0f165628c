"""The port stands alone and never drops to the CPU on its own.

``mxnet_tpu_torch`` and ``chip_smoke.py`` import torch, numpy and the
standard library only: no ``jax`` and nothing of ``mxnet_tpu``, checked
both on the modules a fresh interpreter loads and on the source text.
Entry points default to the CUDA card and raise without one unless the
caller passes ``device="cpu"``; ``chip_smoke.py`` fails without a card
and without the package beside it.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mxnet_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|mxnet_tpu)(?=[.\s,]|$)",
                       re.M)

_CHILD = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import mxnet_tpu_torch
for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__, "mxnet_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in set(sys.modules) - before
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "mxnet_tpu" or n.startswith("mxnet_tpu."))
print("LOADED", len([n for n in sys.modules
                     if n.startswith("mxnet_tpu_torch")]))
print("BAD", bad)
print("MISSING", sorted(m for m in NEEDED if m not in sys.modules))
"""
# the modules each slice added, which the walk above must load
NEEDED = ("mxnet_tpu_torch.optimizer.optimizer",
          "mxnet_tpu_torch.optimizer.fused",
          "mxnet_tpu_torch.optimizer.foreach",
          "mxnet_tpu_torch.optimizer.lr_scheduler",
          "mxnet_tpu_torch.ops.optimizer_ops",
          "mxnet_tpu_torch.gluon.utils",
          "mxnet_tpu_torch.parallel.data_parallel",
          "mxnet_tpu_torch.models.transformer",
          "mxnet_tpu_torch.gluon.parameter",
          "mxnet_tpu_torch.gluon.block",
          "mxnet_tpu_torch.gluon.trainer",
          "mxnet_tpu_torch.gluon.loss",
          "mxnet_tpu_torch.kvstore",
          "mxnet_tpu_torch.metric",
          "mxnet_tpu_torch.random",
          "mxnet_tpu_torch.initializer",
          "mxnet_tpu_torch.ndarray.utils",
          "mxnet_tpu_torch.serving.sampling",
          "mxnet_tpu_torch.serving.speculative",
          "mxnet_tpu_torch.serving.scheduler",
          "mxnet_tpu_torch.serving.router",
          "mxnet_tpu_torch.telemetry",
          "mxnet_tpu_torch.fault",
          "mxnet_tpu_torch.memwatch",
          "mxnet_tpu_torch.checkpoint",
          "mxnet_tpu_torch.metrics_server",
          "mxnet_tpu_torch.precision.config",
          "mxnet_tpu_torch.precision.runtime",
          "mxnet_tpu_torch.precision.amp_pass",
          "mxnet_tpu_torch.precision.loss_scale",
          "mxnet_tpu_torch.precision.quantize",
          "mxnet_tpu_torch.contrib.amp",
          "mxnet_tpu_torch.contrib.amp.amp",
          "mxnet_tpu_torch.contrib.quantization",
          "mxnet_tpu_torch.ops.quantization",
          "mxnet_tpu_torch.recordio",
          "mxnet_tpu_torch.image",
          "mxnet_tpu_torch.image.image",
          "mxnet_tpu_torch.image.detection",
          "mxnet_tpu_torch.io",
          "mxnet_tpu_torch.io.io",
          "mxnet_tpu_torch.gluon.data",
          "mxnet_tpu_torch.gluon.data.dataset",
          "mxnet_tpu_torch.gluon.data.sampler",
          "mxnet_tpu_torch.gluon.data.dataloader",
          "mxnet_tpu_torch.gluon.data.vision",
          "mxnet_tpu_torch.gluon.data.vision.datasets",
          "mxnet_tpu_torch.gluon.data.vision.transforms",
          "mxnet_tpu_torch.ops.cv_ops",
          "mxnet_tpu_torch.models.ssd",
          "mxnet_tpu_torch.models.faster_rcnn",
          "mxnet_tpu_torch.ops.creation",
          "mxnet_tpu_torch.ops.indexing",
          "mxnet_tpu_torch.ops.random_ops",
          "mxnet_tpu_torch.ops.rnn_ops",
          "mxnet_tpu_torch.ops.warp_ops",
          "mxnet_tpu_torch.ndarray.random",
          "mxnet_tpu_torch.ndarray.linalg",
          "mxnet_tpu_torch.gluon.rnn.rnn_layer",
          "mxnet_tpu_torch.gluon.rnn.rnn_cell",
          "mxnet_tpu_torch.models.word_lm",
          "mxnet_tpu_torch.name",
          "mxnet_tpu_torch.attribute",
          "mxnet_tpu_torch.symbol",
          "mxnet_tpu_torch.symbol.symbol",
          "mxnet_tpu_torch.symbol.executor",
          "mxnet_tpu_torch.symbol.contrib",
          "mxnet_tpu_torch.subgraph",
          "mxnet_tpu_torch.model",
          "mxnet_tpu_torch.callback",
          "mxnet_tpu_torch.monitor",
          "mxnet_tpu_torch.module",
          "mxnet_tpu_torch.module.base_module",
          "mxnet_tpu_torch.module.module",
          "mxnet_tpu_torch.module.bucketing_module",
          "mxnet_tpu_torch.rnn",
          "mxnet_tpu_torch.rnn.rnn_cell",
          "mxnet_tpu_torch.rnn.io",
          "mxnet_tpu_torch.rnn.rnn",
          "mxnet_tpu_torch.visualization")


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_port_loads_no_jax_and_no_mxnet_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    child = f"NEEDED = {NEEDED!r}\n" + _CHILD
    out = subprocess.run([sys.executable, "-c", child], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(ln.split(" ", 1) for ln in out.stdout.splitlines()
                 if ln.startswith(("LOADED", "BAD", "MISSING")))
    assert int(lines["LOADED"]) >= 10
    assert lines["BAD"] == "[]", lines["BAD"]
    assert lines["MISSING"] == "[]", lines["MISSING"]


def test_port_sources_import_no_jax_and_no_mxnet_tpu():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 12
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from mxnet_tpu.serving import x")
    assert not FORBIDDEN.search("from mxnet_tpu_torch import x")


def test_entry_points_need_cuda_unless_asked_for_cpu():
    _no_cuda()
    from mxnet_tpu_torch import MXNetError, default_device
    from mxnet_tpu_torch.models.transformer import Transformer
    from mxnet_tpu_torch.serving import ServingEngine, TransformerAdapter

    cfg = dict(units=32, hidden_size=64, num_heads=4, num_layers=1,
               max_length=16, dropout=0.0)
    with pytest.raises(MXNetError, match='device="cpu"'):
        default_device()
    with pytest.raises(MXNetError, match='device="cpu"'):
        Transformer(16, **cfg)
    net = Transformer(16, device="cpu", **cfg)
    assert next(net.parameters()).device.type == "cpu"
    with pytest.raises(MXNetError, match='device="cpu"'):
        ServingEngine(TransformerAdapter(net, src_max_len=4), slots=1,
                      page_size=4, max_len=8)
    ServingEngine(TransformerAdapter(net, src_max_len=4), slots=1,
                  page_size=4, max_len=8, device="cpu")


def test_detection_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    """The detection pipeline's entry points (iterators, the loader, the
    detectors' initialization) default to the card and raise without
    one; with ``ctx=cpu()`` they run here."""
    _no_cuda()
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.models import faster_rcnn_small, ssd_300

    data = np.zeros((4, 2), np.float32)
    for make in (lambda **k: NDArrayIter(data, batch_size=2, **k),
                 lambda **k: DataLoader(ArrayDataset(data), batch_size=2,
                                        **k)):
        with pytest.raises(MXNetError, match='device="cpu"'):
            make()
        make(ctx=mx.cpu())
    for net in (ssd_300(2), faster_rcnn_small(2)):
        with pytest.raises(MXNetError, match='device="cpu"'):
            net.initialize(mx.init.Xavier())
        net.initialize(mx.init.Xavier(), ctx=mx.cpu(), force_reinit=True)


def test_symbolic_entry_points_need_cuda_unless_asked_for_cpu():
    """The symbolic API binds on the card by default (``bind``,
    ``simple_bind``, ``Module``, ``BucketSentenceIter``) and raises
    without one; given the CPU it runs here."""
    _no_cuda()
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError

    net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2)
    for make in (lambda **k: net.simple_bind(data=(1, 3), **k),
                 lambda **k: mx.mod.Module(net, label_names=None, **k)):
        with pytest.raises(MXNetError, match='device="cpu"'):
            make()
    net.simple_bind(ctx=mx.cpu(), data=(1, 3))
    mx.mod.Module(net, label_names=None, context=mx.cpu())
    sents = [[1, 2], [3, 4]]
    with pytest.raises(MXNetError, match='device="cpu"'):
        mx.rnn.BucketSentenceIter(sents, batch_size=2, buckets=[2])
    mx.rnn.BucketSentenceIter(sents, batch_size=2, buckets=[2],
                              ctx=mx.cpu())
    assert {"sym", "mod", "rnn", "model", "callback", "monitor", "viz",
            "name", "AttrScope"} <= set(dir(mx))
    assert mx.gluon.SymbolBlock is not None and np is not None


def test_chip_smoke_fails_without_a_card(tmp_path):
    _no_cuda()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository it exits non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# JAX names the port does not have, each with what queues it in ROADMAP.md
# (or why it has no counterpart); everything else the JAX namespaces
# export, the port's export too.
_A9 = "A.9 (multi-GPU: meshes, Plan, sharding, pipeline, ring)"
_SUPERSTEP = "A.6's superstep, with A.1"
QUEUED = {
    "mx": {"env_vars": "A.11.6",
           "runtime": "A.11.6", "util": "A.11.6", "is_np_array": "A.11.6",
           "test_utils": "A.11.6", "rtc": "A.11.8",
           "aot_cache": "not queued: the port compiles no executables",
           "tpu": "the TPU context: the port's cards are gpu(i)",
           "num_tpus": "the TPU context: the port's cards are gpu(i)"},
    "nd": {"from_jax": "no counterpart: jax arrays",
           "np": "an import, not a name", "Optional": "an import",
           "dtype_np": "an import"},
    "parallel": dict(
        {n: _A9 for n in (
            "Plan", "compile_step_with_plan", "device_mesh", "dist",
            "dp_plan", "global_allreduce", "host_barrier", "local_mesh",
            "make_mesh", "make_train_step", "mesh", "pipeline",
            "pipeline_apply", "pipeline_plan", "plan", "planner", "ring",
            "ring_attention", "ring_attention_scope", "ring_plan",
            "ring_scope", "ring_scope_mesh", "ring_self_attention", "scope",
            "sharding", "tensor_parallel_plan", "ulysses", "ulysses_plan",
            "ulysses_self_attention")},
        StackedAsyncLoss=_SUPERSTEP, SuperstepLossView=_SUPERSTEP,
        superstep_k=_SUPERSTEP),
    "models": {n: _A9 for n in ("BERTForMLMPipelined",
                                "StackedTransformerEncoder", "bert_pp",
                                "bert_pp_sharding_rules", "bert_pp_small")},
    "gluon": {},
    "gluon.nn": {},
    "gluon.model_zoo.vision": {},
    "io": {"native": "A.13 (item 6): the native libmxio pipeline"},
    "serving": {},
}


def test_public_names_match_jax_or_are_queued():
    """Every public name of ``mx``, ``mx.nd``, ``mx.parallel``,
    ``mx.models``, ``mx.gluon``, ``mx.gluon.nn``,
    ``mx.gluon.model_zoo.vision``, ``mx.io`` and ``mx.serving`` in the JAX
    package is in
    the port's namespace too, or listed above with the ROADMAP item that
    queues it; a listed name the port has gained fails, so the list stays
    current."""
    import mxnet_tpu as jmx
    import mxnet_tpu.io.native  # noqa: F401 - a JAX ImageRecordIter loads it
    import mxnet_tpu.serving  # noqa: F401 - not loaded by the package

    import mxnet_tpu_torch as tmx
    import mxnet_tpu_torch.serving  # noqa: F401

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    for key, jmod, tmod in (("mx", jmx, tmx), ("nd", jmx.nd, tmx.nd),
                            ("parallel", jmx.parallel, tmx.parallel),
                            ("models", jmx.models, tmx.models),
                            ("gluon", jmx.gluon, tmx.gluon),
                            ("gluon.nn", jmx.gluon.nn, tmx.gluon.nn),
                            ("gluon.model_zoo.vision",
                             jmx.gluon.model_zoo.vision,
                             tmx.gluon.model_zoo.vision),
                            ("io", jmx.io, tmx.io),
                            ("serving", jmx.serving, tmx.serving)):
        missing = public(jmod) - public(tmod)
        assert missing == set(QUEUED[key]), (key, sorted(
            missing ^ set(QUEUED[key])))
    for name in ("Context", "current_context", "cpu_pinned", "num_gpus",
                 "waitall", "NDArray", "KVStore", "lr_scheduler",
                 "parallel", "contrib", "engine"):
        assert name in public(tmx), name
    assert {"AsyncLoss", "StepFence", "InflightRing", "drain_all",
            "inflight_limit"} <= public(tmx.parallel)
