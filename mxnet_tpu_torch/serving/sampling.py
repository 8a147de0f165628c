"""Token selection under sampling: the temperature / top-k / top-p filter
and the per-request random stream.

Counterpart of the sampling math in ``mxnet_tpu/serving/engine.py``
(``_filter_logits``, ``_gumbel_rows``, ``_uniform_rows``).  Everything
here is tensor ops on the logits' device: the decode and verify steps
call it with no host readback.  The engine calls these functions through
this module, so a test can replace ``_gumbel_rows`` and
``_uniform_rows``.

The random stream is counter-based.  A request's seed becomes a 32-bit
key (:func:`seed_key`, on the host at admission); the noise that chooses
the token at decode position ``p`` is a hash of (key, ``2 p``, column),
and the accept coin of a speculative draft at ``p`` a hash of (key,
``2 p + 1``).  So a request's stream is a function of its seed and the
position alone: not of its slot, the batch, restarts or a recompute
preemption, and the engine keeps no generator state beyond the key.  The
JAX engine splits threefry keys instead; seeds do not carry across the
two packages (the tests replace both packages' ``_gumbel_rows`` and
``_uniform_rows`` with one numpy noise source to compare their tokens).

The hash is a 32-bit integer mixer (two xor-shift-multiply rounds,
constants below 2^31 so every product fits int64 on both devices); the
top 24 bits of its output give a uniform in [0, 1 - 2^-24], clamped below
at the f32 ``tiny`` so a Gumbel draw is never infinite.
"""
from __future__ import annotations

import torch

__all__ = ["seed_key"]

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9   # row counter stride (odd: distinct counters, keys)
_COL = 0x632BE5AB    # column stride (odd, < 2^31)
_TINY = torch.finfo(torch.float32).tiny


def _mix32(x):
    """The mixer over values in [0, 2^32): a Python int or an int64
    tensor."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def seed_key(seed: int) -> int:
    """A request seed (any Python int) -> its 32-bit stream key."""
    seed = int(seed)
    return _mix32(_mix32(seed & _M32) ^ ((seed >> 32) & _M32))


def _row_keys(key, ctr):
    """int64 (…) key and counter -> int64 (…) 32-bit row keys."""
    return _mix32((key + ctr * _GOLD) & _M32)


def _unit(u32):
    """32-bit hashes -> f32 uniforms in [0, 1 - 2^-24]."""
    return (u32 >> 8).to(torch.float32) * (2.0 ** -24)


def _gumbel_rows(key, ctr, V: int):
    """Gumbel noise: int64 ``key`` and ``ctr`` of one shape (…) ->
    (…, V) f32; argmax(logits + noise) samples softmax(logits)."""
    rk = _row_keys(key, ctr)
    col = (torch.arange(V, dtype=torch.int64, device=rk.device)
           * _COL) & _M32
    u = _unit(_mix32(rk[..., None] ^ col)).clamp_(min=_TINY)
    return -torch.log(-torch.log(u))


def _uniform_rows(key, ctr):
    """Accept coins: int64 ``key`` and ``ctr`` (…) -> (…) f32 U[0, 1)."""
    return _unit(_row_keys(key, ctr))


def _filter_logits(logits, temp, topk, topp):
    """Temperature / top-k / top-p filtered logits, per row: logits
    (N, V); temp and topp (N,) f32; topk (N,) int (0 = off).  Masked-out
    entries are -inf, so Gumbel-argmax over the result samples the
    truncated, temperature-scaled distribution.  Rows with temp == 0
    give garbage (the 1e-6 floor) that the caller discards.

    The JAX function step for step: its ``argsort`` is stable, so this
    sorts descending with ``stable=True`` (ties keep the lower index
    first); the top-k threshold masks only values strictly below the
    k-th, so ties at it survive; the nucleus keeps the head token
    always, and ``top_p >= 1`` turns it off outright."""
    V = logits.shape[-1]
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    sdesc, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    kk = torch.clamp(torch.where(topk > 0, topk, V), 1, V).long()
    kth = sdesc.gather(1, (kk - 1)[:, None])
    neg = float("-inf")
    filt = scaled.masked_fill(scaled < kth, neg)
    fdesc = sdesc.masked_fill(sdesc < kth, neg)
    pdesc = torch.softmax(fdesc, dim=-1)
    cum = torch.cumsum(pdesc, dim=-1)
    drop_desc = ((cum - pdesc) >= topp[:, None]) & (topp < 1.0)[:, None]
    drop = torch.empty_like(drop_desc).scatter_(1, order, drop_desc)
    return filt.masked_fill(drop, neg)
