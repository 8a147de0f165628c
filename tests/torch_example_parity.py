"""Helpers of the example-script parity tests (``test_torch_examples*.py``):
the JAX package's ``examples/<name>.py`` as a module, the JAX net's values
carried into the port net by position, the first-step loss tolerance, and
a port example run as a CPU subprocess."""
import importlib.util
import os
import pathlib
import subprocess
import sys

import mxnet_tpu_torch as tmx

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = tmx.cpu()
LOSS_REL = 1e-5


def jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def carry(jnet, tnet):
    """The JAX net's values into the port net, parameter by parameter in
    ``collect_params()`` order (Gluon layout)."""
    jp = list(jnet.collect_params().values())
    tp = list(tnet.collect_params().values())
    assert len(jp) == len(tp) > 0
    for a, b in zip(jp, tp):
        assert tuple(a.shape) == tuple(b.shape), (a.name, b.name)
        b.set_data(a.data().asnumpy())


def assert_loss_close(got, want):
    assert abs(got - want) <= LOSS_REL * max(1.0, abs(want)), (got, want)


def run_example(name, *args, device="cpu", timeout=300):
    cmd = [sys.executable, "-m", f"mxnet_tpu_torch.examples.{name}"]
    if device is not None:
        cmd += ["--device", device]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(cmd + [str(a) for a in args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
