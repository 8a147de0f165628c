"""The serving engine's nine ``MX_SERVE_*`` variables, read by the port's
``ServingEngine`` as the JAX engine reads them: with an argument left
None, each variable set for both engines on the CPU gives both the same
slots, page size, pool pages, stream interval, sampling flag,
speculation depth, prefix cache, its entries and the prefix ingest's
chunk; an argument given wins over its variable in both.  No numbers
are compared but these settings, so no tolerance applies.
"""
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.models.transformer import Transformer as JTransformer
from mxnet_tpu.serving import ServingEngine as JEngine
from mxnet_tpu.serving import TransformerAdapter as JAdapter
from mxnet_tpu_torch.models.transformer import Transformer
from mxnet_tpu_torch.serving import ServingEngine, TransformerAdapter
from torch_fresh_names import fresh_jax_names  # noqa: F401

CFG = dict(units=16, hidden_size=32, num_heads=2, num_layers=1,
           max_length=64, dropout=0.0)
VARS = ("MX_SERVE_SLOTS", "MX_SERVE_PAGE_SIZE", "MX_SERVE_POOL_PAGES",
        "MX_SERVE_STREAM_EVERY", "MX_SERVE_SAMPLING", "MX_SERVE_SPEC_K",
        "MX_SERVE_PREFIX_CACHE", "MX_SERVE_PREFIX_ENTRIES",
        "MX_SERVE_PREFIX_CHUNK")


@pytest.fixture(scope="module")
def adapters():
    jnet = JTransformer(40, prefix="envj_", **CFG)
    jnet.initialize(jmx.init.Xavier())
    tnet = Transformer(40, device="cpu", prefix="envt_", **CFG)
    return JAdapter(jnet, src_max_len=8), TransformerAdapter(tnet, 8)


def _settings(eng):
    prefix = eng._prefix
    return {"slots": eng._S, "page_size": eng._ps,
            "pool_pages": eng._cache.num_pages,
            "stream_every": eng._stream_every,
            "sampling": eng._sampling, "spec_k": eng._spec_k,
            "prefix_cache": prefix is not None,
            "prefix_entries": None if prefix is None else prefix.max_entries,
            "prefix_chunk": eng._prefix_chunk}


def _both(adapters, **kw):
    jad, tad = adapters
    return (_settings(ServingEngine(tad, max_len=32, device="cpu", **kw)),
            _settings(JEngine(jad, max_len=32, ctx=jmx.cpu(), **kw)))


@pytest.fixture
def clean_env(monkeypatch):
    for v in VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_defaults_agree(adapters, clean_env):
    port, ref = _both(adapters)
    assert port == ref
    assert port["slots"] == 8 and port["prefix_chunk"] == 8


@pytest.mark.parametrize("var,value,key,want", [
    ("MX_SERVE_SLOTS", "3", "slots", 3),
    ("MX_SERVE_PAGE_SIZE", "4", "page_size", 4),
    ("MX_SERVE_POOL_PAGES", "40", "pool_pages", 40),
    ("MX_SERVE_STREAM_EVERY", "2", "stream_every", 2),
    ("MX_SERVE_SAMPLING", "1", "sampling", True),
    ("MX_SERVE_SPEC_K", "3", "spec_k", 3),
    ("MX_SERVE_PREFIX_CACHE", "1", "prefix_cache", True),
    ("MX_SERVE_PREFIX_CHUNK", "2", "prefix_chunk", 2),
])
def test_each_variable_read_alike(adapters, clean_env, var, value, key,
                                  want):
    clean_env.setenv(var, value)
    port, ref = _both(adapters)
    assert port == ref
    assert port[key] == want


def test_prefix_entries_read_alike(adapters, clean_env):
    clean_env.setenv("MX_SERVE_PREFIX_CACHE", "1")
    clean_env.setenv("MX_SERVE_PREFIX_ENTRIES", "5")
    port, ref = _both(adapters)
    assert port == ref and port["prefix_entries"] == 5


def test_all_nine_at_once_and_arguments_win(adapters, clean_env):
    for var, value in zip(VARS, ("3", "4", "40", "2", "1", "2", "1", "7",
                                 "2")):
        clean_env.setenv(var, value)
    port, ref = _both(adapters)
    assert port == ref
    assert port == {"slots": 3, "page_size": 4, "pool_pages": 40,
                    "stream_every": 2, "sampling": True, "spec_k": 2,
                    "prefix_cache": True, "prefix_entries": 7,
                    "prefix_chunk": 2}
    kw = dict(slots=5, page_size=8, pool_pages=30, stream_every=3,
              sampling=False, spec_k=0, prefix_cache=False)
    port, ref = _both(adapters, **kw)
    assert port == ref
    assert (port["slots"], port["sampling"], port["prefix_cache"]) == \
        (5, False, False)
