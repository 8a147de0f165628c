"""An autouse fixture for the port's test files that build JAX Gluon
blocks or Symbols: each test draws from fresh JAX auto-name counters,
and the counters it found are back when it ends.  So a file's auto-named
blocks do not shift the names that later tests in the same process draw
(``tests/test_precision.py`` pairs two nets' parameters by their sorted
auto-names, and ``dense10`` sorts before ``dense9``)."""
import pytest

from mxnet_tpu.gluon import block as _jblock
from mxnet_tpu.symbol import symbol as _jsymbol


@pytest.fixture(autouse=True)
def fresh_jax_names(monkeypatch):
    monkeypatch.setattr(_jblock._scope, "_counters", {})
    monkeypatch.setattr(_jsymbol, "_UID", {})
