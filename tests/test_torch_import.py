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
          "mxnet_tpu_torch.metrics_server")


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
