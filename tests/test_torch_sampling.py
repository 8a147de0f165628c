"""The serving front door's host and sampling pieces, no model: the port's
``_filter_logits``, noise and sampler, ``NGramDraft``, ``prefix_key``,
``PrefixCache`` and ``Request`` against the JAX package's on the same
numpy inputs.

Tolerances: the filter's -inf mask must be equal exactly and its finite
values within rtol 1e-6 (both divide and sort in f32; the nucleus's
softmax and cumsum differ by rounding only).  The sampler's
total-variation distance to the filtered softmax must stay under
``sqrt(k / n)`` for n draws over a support of k tokens, about 2.5 times
the expected distance of an exact sampler's empirical histogram
(``0.5 * sqrt(2 k / (pi n))`` at most).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.serving import NGramDraft as JaxNGramDraft
from mxnet_tpu.serving import PrefixCache as JaxPrefixCache
from mxnet_tpu.serving import Request as JaxRequest
from mxnet_tpu.serving import prefix_key as jax_prefix_key
from mxnet_tpu.serving.engine import _filter_logits as jax_filter_logits
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (ContinuousBatchingScheduler, NGramDraft,
                                     PrefixCache, Request, prefix_key)
from mxnet_tpu_torch.serving import sampling


def _filter_both(logits, temp, topk, topp):
    want = np.asarray(jax_filter_logits(
        jnp.asarray(logits), jnp.asarray(temp, jnp.float32),
        jnp.asarray(topk, jnp.int32), jnp.asarray(topp, jnp.float32)))
    got = sampling._filter_logits(
        torch.from_numpy(logits), torch.tensor(temp, dtype=torch.float32),
        torch.tensor(topk, dtype=torch.int32),
        torch.tensor(topp, dtype=torch.float32)).numpy()
    return got, want


def _ties(rng):
    """Rows whose k-th value is shared by several tokens."""
    logits = (rng.randn(4, 40) * 0.1).astype(np.float32)
    logits[:, 5:12] = 1.5      # 7 tokens tied above the rest
    logits[0, :3] = 3.0
    logits[2, :] = 0.25        # a row of all ties
    return logits, [1.0, 0.7, 1.2, 0.5], [5, 8, 3, 9], [1.0, 0.9, 1.0, 0.5]


CASES = {
    "random": lambda rng: (rng.randn(6, 50).astype(np.float32) * 3,
                           [1.0, 0.8, 0.5, 2.0, 0.9, 1.3],
                           [0, 10, 5, 0, 50, 1], [0.9, 1.0, 0.5, 0.3, 0.95,
                                                  0.99]),
    "ties_at_kth": _ties,
    "top_k_off_top_p_off": lambda rng: (rng.randn(3, 64).astype(np.float32),
                                        [0.7, 1.0, 1.4], [0, 0, 0],
                                        [1.0, 1.0, 1.0]),
    "temperature_near_zero": lambda rng: (rng.randn(3, 30).astype(np.float32),
                                          [1e-7, 0.0, 1e-3], [0, 4, 0],
                                          [0.9, 1.0, 0.2]),
    "wide_vocab": lambda rng: (rng.randn(2, 2000).astype(np.float32) * 2,
                               [0.8, 1.1], [50, 0], [0.9, 0.8]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_logits_equals_jax(case):
    logits, temp, topk, topp = CASES[case](np.random.RandomState(7))
    got, want = _filter_both(logits, temp, topk, topp)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    assert keep.any(axis=1).all(), "every row keeps its head token"
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)


def test_filter_keeps_ties_at_the_kth_value():
    """top_k 5 on row 0 (3 tokens at 3.0, then 7 tied at 1.5) keeps all
    ten: the threshold masks only values strictly below the k-th."""
    logits, temp, topk, topp = _ties(np.random.RandomState(7))
    got, _ = _filter_both(logits, temp, topk, topp)
    assert (~np.isneginf(got[0])).sum() == 10
    assert (~np.isneginf(got[2])).sum() == 40, "all-tie row keeps all"


def _tv_draws(logits, temp, topk, topp, n, chunk):
    """Empirical distribution of ``n`` sampler draws per row (counters
    0, 2, 4, ...) against the filtered softmax; returns (tv, support)."""
    t = lambda a, dt: torch.tensor(a, dtype=dt)
    filt = sampling._filter_logits(torch.from_numpy(logits),
                                   t(temp, torch.float32),
                                   t(topk, torch.int32),
                                   t(topp, torch.float32))
    S, V = filt.shape
    key = torch.tensor([sampling.seed_key(100 + s) for s in range(S)])
    counts = torch.zeros((S, V), dtype=torch.float64)
    k = (~torch.isneginf(filt)).sum(dim=1)
    for c0 in range(0, n, chunk):
        ctr = 2 * torch.arange(c0, c0 + chunk)[None, :].expand(S, chunk)
        g = sampling._gumbel_rows(key[:, None].expand(S, chunk), ctr, V)
        tok = torch.argmax(filt[:, None, :] + g, dim=-1)
        counts.scatter_add_(1, tok, torch.ones_like(tok, dtype=torch.float64))
    p = torch.softmax(filt.double(), dim=-1)
    tv = 0.5 * (counts / n - p).abs().sum(dim=1)
    # never a draw outside the filtered support (its probability is 0)
    assert (counts[torch.isneginf(filt)] == 0).all()
    return tv, k


def test_sampler_distribution_within_tv_limit():
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 200).astype(np.float32) * 2
    n = 20000
    tv, k = _tv_draws(logits, [0.8, 1.0, 1.5], [50, 20, 0], [0.9, 1.0, 0.8],
                      n, chunk=2000)
    limit = torch.sqrt(k.double() / n)
    assert (tv < limit).all(), (tv, limit)


def test_noise_is_gumbel_and_a_function_of_key_and_counter():
    key = torch.full((50000,), sampling.seed_key(5))
    g = sampling._gumbel_rows(key, 2 * torch.arange(50000), 4)
    assert abs(float(g.mean()) - 0.5772157) < 0.01
    assert abs(float(g.std()) - math.pi / math.sqrt(6)) < 0.01
    assert torch.isfinite(g).all()
    # the same (key, counter) rows wherever they sit in a batch
    k = torch.tensor([sampling.seed_key(1), sampling.seed_key(2)])
    c = torch.tensor([6, 9])
    both = sampling._gumbel_rows(k, c, 16)
    assert torch.equal(both[1], sampling._gumbel_rows(k[1:], c[1:], 16)[0])
    assert not torch.equal(both[0], both[1])
    u = sampling._uniform_rows(k, c)
    assert ((u >= 0) & (u < 1)).all()


def test_uniform_zero_gives_finite_gumbel(monkeypatch):
    """A hash of 0 (a uniform of exactly 0) is clamped to the f32 tiny,
    never an infinite Gumbel draw."""
    monkeypatch.setattr(sampling, "_mix32",
                        lambda x: torch.zeros_like(x))
    g = sampling._gumbel_rows(torch.tensor([1]), torch.tensor([0]), 3)
    assert torch.isfinite(g).all()


def test_seed_key_is_32_bit_and_seed_dependent():
    keys = {sampling.seed_key(s) for s in (0, 1, 2, 2 ** 32, -1, 10 ** 12)}
    assert len(keys) == 6
    assert all(0 <= k < 2 ** 32 for k in keys)


def test_ngram_draft_equals_jax():
    rng = np.random.RandomState(11)
    for trial in range(60):
        n = 1 + trial % 3
        inc = bool(trial % 2)
        prompt = rng.randint(3, 9, rng.randint(0, 10))
        prefix = rng.randint(3, 9, rng.randint(0, 4))
        gen = list(rng.randint(3, 9, rng.randint(0, 16)))
        k = int(rng.randint(1, 6))
        jr = JaxRequest(prompt, 4, 1, 2, prefix=prefix)
        tr = Request(prompt, 4, 1, 2, prefix=prefix)
        want = JaxNGramDraft(n, inc).propose(jr, gen, k)
        assert NGramDraft(n, inc).propose(tr, gen, k) == want
    with pytest.raises(ValueError):
        NGramDraft(0)


def test_prefix_key_equals_jax():
    src = np.array([5, 6, 7, 0], np.int32)
    pre = np.arange(3, 9, dtype=np.int32)
    for parts in [("prefill", src[None]), (src, 1, pre), (src, 2, pre[:3]),
                  ("s", 3, np.zeros((0,), np.int32)), (7,)]:
        assert prefix_key(*parts) == jax_prefix_key(*parts)
    assert prefix_key(src, 1, pre) != prefix_key(src, 2, pre)


def _script(cache_cls):
    """One sequence of PrefixCache calls; returns what a caller sees."""
    c = cache_cls(max_entries=3)
    seen = []
    for i in range(5):
        dropped = c.put(f"k{i}", "pages" if i % 2 else "prefill", 0,
                        {"i": i})
        seen.append(("put", i, [d["key"] for d in dropped], len(c)))
    seen.append(("get", c.get("k3", 0) is not None, c.get("k0", 0) is None,
                 c.get("k4", 1) is None, c.hits, c.misses))
    e = c.pop_lru("pages")
    seen.append(("pop_lru", e["key"] if e else None, len(c)))
    e = c.pop_lru()
    seen.append(("pop_lru_any", e["key"] if e else None, len(c)))
    c.put("k9", "pages", 1, {})
    c.put("k8", "prefill", 2, {})
    seen.append(("stale", sorted(d["key"] for d in c.invalidate_stale(2)),
                 len(c)))
    while c.pop_lru() is not None:
        pass
    seen.append(("empty_pop", c.pop_lru("pages"), len(c)))
    return seen


def test_prefix_cache_behaves_as_jax():
    assert _script(PrefixCache) == _script(JaxPrefixCache)


def test_request_checks_and_fields_as_jax():
    for kw in ({"temperature": -0.1}, {"top_k": -1}, {"top_p": 0.0},
               {"top_p": 1.5}, {"max_new_tokens": 0}):
        args = dict(dict(tokens=[3], max_new_tokens=4, bos_id=1, eos_id=2),
                    **kw)
        with pytest.raises(JaxMXNetError):
            JaxRequest(**args)
        with pytest.raises(MXNetError):
            Request(**args)
    r = Request([3, 4], 4, 1, 2, temperature=0.5, top_k=3, top_p=0.8,
                seed=9, prefix=[5, 6], session="s", trace_id="t",
                parent_span_id=4, sampled=False)
    assert (r.temperature, r.top_k, r.top_p, r.seed) == (0.5, 3, 0.8, 9)
    assert r.prefix.dtype == np.int32 and list(r.prefix) == [5, 6]
    assert (r.session, r.trace_id, r.parent_span_id, r.sampled) == \
        ("s", "t", 4, False)
    assert (r.preemptions, r.prefix_hit, r.generation_at_admit) == \
        (0, None, None)
    assert r.ttft_ms == 0.0 and r.queue_wait_ms == 0.0


def test_scheduler_stamps_queue_legs():
    sched = ContinuousBatchingScheduler(bound=4)
    r = sched.submit(Request([3], 4, 1, 2))
    assert r.t_submit is not None and r.t_queue_start == r.t_submit
    (got,) = sched.pop_ready(1, 4, 16)
    assert got is r and r.t_admit >= r.t_submit
    first = r.queue_ms_acc
    assert first >= 0.0
    sched.requeue(r)
    assert r.t_queue_start >= r.t_admit
    sched.pop_ready(1, 4, 16)
    assert r.queue_wait_ms >= first
    r.t_first_token = r.t_submit + 0.25
    assert r.ttft_ms == pytest.approx(250.0)
