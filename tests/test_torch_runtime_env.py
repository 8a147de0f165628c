"""The port's ``util``, ``runtime``, ``env_vars`` and ``rtc`` against the
JAX package's, on the CPU.

``util`` and ``rtc`` keep the JAX surface (``rtc`` raises, naming the
port's kernel route); ``runtime.Features`` keeps the JAX key set with
this build's values; ``env_vars`` registers every JAX variable under its
name and every variable only the port reads.  The registry's drift guard
(``tests/test_env_vars_registry.py``'s intent) is an AST scan of
``mxnet_tpu_torch/`` and ``chip_smoke.py``: every quoted ``MX_*``,
``MXNET_*`` or ``DMLC_*`` name outside a docstring is registered, and
every variable registered as honored is read somewhere in the port.
"""
import ast
import logging
import os
import pathlib
import re

import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import env_vars as jenv
from mxnet_tpu import rtc as jrtc
from mxnet_tpu import runtime as jruntime
from mxnet_tpu import util as jutil
from mxnet_tpu_torch import env_vars, rtc, runtime, util
from mxnet_tpu_torch.base import MXNetError

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "mxnet_tpu_torch"
DISPOSITIONS = {"honored", "absorbed", "tool", "not honored"}


# --------------------------------------------------------------------------
# util
# --------------------------------------------------------------------------
def test_util_surface_is_the_jax_one(tmp_path):
    assert util.__all__ == jutil.__all__
    assert tmx.is_np_array is util.is_np_array
    for name in ("is_np_array", "is_np_shape"):
        assert getattr(util, name)() is getattr(jutil, name)() is False
    with pytest.raises(NotImplementedError):
        util.set_np()
    assert util.reset_np() is None

    def f():
        return 1

    assert util.use_np(f) is f
    d = tmp_path / "a" / "b"
    util.makedirs(str(d))
    util.makedirs(str(d))  # exists: no error
    assert d.is_dir()


def test_util_card_queries_read_torch():
    assert util.get_gpu_count() == (torch.cuda.device_count()
                                    if torch.cuda.is_available() else 0)
    if torch.cuda.is_available():
        free, total = util.get_gpu_memory(0)
        assert 0 < free <= total
    else:
        with pytest.raises(MXNetError, match="cpu"):
            util.get_gpu_memory(0)


# --------------------------------------------------------------------------
# runtime
# --------------------------------------------------------------------------
def test_features_keep_the_jax_keys_with_this_builds_values():
    feats = runtime.Features()
    assert list(feats) == list(jruntime.Features())
    assert {f.name for f in runtime.feature_list()} == set(feats)
    for name in ("TPU", "XLA", "PALLAS", "MIOPEN", "ICI_COLLECTIVES"):
        assert feats.is_enabled(name) is False, name
    assert feats.is_enabled("cuda") is torch.cuda.is_available()
    assert feats.is_enabled("CUDNN") is torch.backends.cudnn.is_available()
    import torch.distributed as dist

    assert feats.is_enabled("NCCL") is bool(
        dist.is_available() and dist.is_nccl_available())
    # the dist_sync stores run on torch.distributed
    assert feats.is_enabled("DIST_KVSTORE") is bool(dist.is_available())
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    assert feats.is_enabled("OPENCV") is has_cv2
    with pytest.raises(RuntimeError, match="unknown"):
        feats.is_enabled("NVRTC")
    assert repr(feats).startswith("[TPU ✖, XLA ✖, PALLAS ✖")


# --------------------------------------------------------------------------
# rtc
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cls", ["CudaModule", "CudaKernel"])
def test_rtc_raises_and_names_the_ports_kernel_route(cls):
    assert rtc.__all__ == jrtc.__all__
    with pytest.raises(jmx.base.MXNetError):
        getattr(jrtc, cls)("")
    with pytest.raises(MXNetError) as err:
        getattr(rtc, cls)("")
    msg = str(err.value)
    assert "csrc" in msg and "_build.py" in msg and "Pallas" not in msg


# --------------------------------------------------------------------------
# env_vars
# --------------------------------------------------------------------------
def test_registry_holds_every_jax_variable_and_the_ports_own():
    assert set(jenv.ENV_VARS) <= set(env_vars.ENV_VARS)
    assert set(env_vars.ENV_VARS) - set(jenv.ENV_VARS) == {"CUDA_HOME",
                                                           "MX_LOCAL_RANK"}
    for name, (disp, detail) in env_vars.ENV_VARS.items():
        assert disp in DISPOSITIONS, name
        assert detail, name
        if disp == "not honored":
            assert "ROADMAP" in detail or "not queued" in detail, name
    # the ones the JAX package honors and the port reads nowhere name what
    # queues them: the superstep (A.1), the AOT cache; the rendezvous
    # variables are honored since A.9 part 1, the planner's MX_PLAN since
    # part 2, the elastic resize's since part 3
    for name in ("MX_COORDINATOR", "MX_RENDEZVOUS_TIMEOUT", "MX_FORCE_CPU",
                 "MX_LOCAL_RANK", "MX_PLAN", "MX_ELASTIC",
                 "MX_PREV_NUM_PROCS"):
        assert env_vars.ENV_VARS[name][0] == "honored", name
    assert env_vars.ENV_VARS["MX_SUPERSTEP"][1] == env_vars._STEP
    assert env_vars.ENV_VARS["MX_EXECUTABLE_CACHE_DIR"][1] == env_vars._AOT


_NAME = re.compile(r"(MXNET|MX|DMLC)_[A-Z0-9][A-Z0-9_]*")


def _string_reads(paths):
    """name -> files for every string constant outside a docstring that
    is an environment variable name of the registry's families, or is
    registered (CUDA_HOME)."""
    reads = {}
    for path in paths:
        tree = ast.parse(path.read_text())
        docs = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                body = node.body
                if body and isinstance(body[0], ast.Expr) and isinstance(
                        body[0].value, ast.Constant):
                    docs.add(id(body[0].value))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                v = node.value
                if _NAME.fullmatch(v) or v in env_vars.ENV_VARS:
                    reads.setdefault(v, set()).add(
                        str(path.relative_to(ROOT)))
    return reads


def _port_files():
    return sorted(PORT.rglob("*.py"))


def test_every_env_var_the_port_reads_is_registered():
    reads = _string_reads(_port_files() + [ROOT / "chip_smoke.py"])
    assert len(reads) > 40, "the scan found almost nothing: it broke"
    missing = {k: sorted(v) for k, v in reads.items()
               if k not in env_vars.ENV_VARS}
    assert not missing, missing


def test_every_honored_variable_is_read_by_the_port():
    reads = _string_reads([p for p in _port_files()
                           if p.name != "env_vars.py"])
    unread = [k for k, (disp, _) in env_vars.ENV_VARS.items()
              if disp == "honored" and k not in reads]
    assert not unread, unread
    # a tool variable is read by its tool
    tools = _string_reads(sorted((ROOT / "tools").glob("*.py")))
    for k, (disp, _) in env_vars.ENV_VARS.items():
        if disp == "tool":
            assert k in tools, k


def test_describe_and_check(caplog, monkeypatch):
    table = env_vars.describe()
    for name in env_vars.ENV_VARS:
        assert name in table
    monkeypatch.setattr(env_vars, "_warned", False)
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch"):
        env_vars.check({"MXNET_GPU_MEM_POOL_TYPE": "Round",
                        "MXNET_NOT_A_THING": "1",
                        "MXNET_ENGINE_TYPE": "NaiveEngine", "HOME": "/"})
        env_vars.check({"MXNET_GPU_WORKER_NTHREADS": "2"})  # once only
    text = caplog.text
    assert "MXNET_GPU_MEM_POOL_TYPE=Round has no effect" in text
    assert "MXNET_NOT_A_THING is not recognized" in text
    assert "MXNET_ENGINE_TYPE" not in text
    assert "MXNET_GPU_WORKER_NTHREADS" not in text
    monkeypatch.setattr(env_vars, "_warned", False)
    env_vars.check(dict(os.environ))  # the real environment: no raise
