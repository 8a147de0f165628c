"""Kernel K2's split-and-merge, emulated on the CPU.

K2 cuts the ``P * page_size`` keys of a table row into spans of ``span``
keys (``_plan``, from the shapes alone), one block each; a block walks its
span in tiles of ``tile`` keys with an online softmax, and the blocks of a
(slot, head) merge their states (m, l, acc) in span order.
``_split_merge`` does the same arithmetic in torch, in the kernel's order,
and must equal the unsplit plain version: at spans and tiles that divide
the page size, cross page boundaries or cover the whole row, with spans
that lie past a slot's length (empty: m = -1e30, l = 0, which must merge
to nothing), a slot of length 0 (exact zeros) and a length past the table
(the whole row).  Tolerance: atol = rtol = 1e-6, f32 on both sides with
sums in another order.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops.kernels import paged_decode_attention_ref
from mxnet_tpu_torch.ops.kernels import paged_attention as pa_mod

NEG = -1e30


def _span_state(qs, K, V, tile):
    """One block's (m, l, acc) over its live keys K, V (nk, H, hd), tile
    by tile: acc and l rescale by exp(m - m_new) at every tile."""
    H, hd = qs.shape
    m, l, acc = torch.full((H,), NEG), torch.zeros(H), torch.zeros(H, hd)
    for t0 in range(0, K.shape[0], tile):
        sc = torch.einsum("hd,khd->hk", qs, K[t0:t0 + tile])
        m_new = torch.maximum(m, sc.max(-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[:, None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + torch.einsum("hk,khd->hd", p,
                                                  V[t0:t0 + tile])
        m = m_new
    return m, l, acc


def _split_merge(q, k_pool, v_pool, table, lengths, span, tile,
                 sm_scale=None):
    """K2's algorithm: per slot, one (m, l, acc) per span (empty past the
    length), merged in span order; zeros where no key is live."""
    S, H, hd = q.shape
    ps, P = k_pool.shape[1], table.shape[1]
    scale = 1.0 / math.sqrt(hd) if sm_scale is None else sm_scale
    n_split = -(-(P * ps) // span)
    out = torch.zeros(S, H, hd)
    for s in range(S):
        L = min(max(int(lengths[s]), 0), P * ps)
        parts = []
        for c in range(n_split):
            keys = torch.arange(c * span, max(c * span,
                                              min((c + 1) * span, L)))
            pages = table[s, keys // ps].long()
            parts.append(_span_state(q[s].float() * scale,
                                     k_pool[pages, keys % ps].float(),
                                     v_pool[pages, keys % ps].float(), tile))
        M = torch.stack([m for m, _, _ in parts]).max(0).values
        w = [torch.exp(m - M) for m, _, _ in parts]
        Lsum = sum(wc * l for wc, (_, l, _) in zip(w, parts))
        acc = sum(wc[:, None] * a for wc, (_, _, a) in zip(w, parts))
        out[s] = torch.where(Lsum[:, None] > 0, acc / Lsum[:, None], 0.0)
    return out


def _case(seed, S, H, hd, ps, P):
    rng = np.random.RandomState(seed)
    N = 1 + S * P
    q = torch.from_numpy(rng.randn(S, H, hd).astype(np.float32))
    kp = torch.from_numpy(rng.randn(N, ps, H, hd).astype(np.float32))
    vp = torch.from_numpy(rng.randn(N, ps, H, hd).astype(np.float32))
    table = torch.from_numpy(
        (1 + rng.permutation(S * P)).reshape(S, P).astype(np.int32))
    return q, kp, vp, table


# ps 4, P 5: 20 keys a row; lengths: one key, a ragged middle, exactly one
# page, the whole row, past the row, and an inactive slot
LENGTHS = [1, 13, 4, 20, 37, 0]


@pytest.mark.parametrize("span,tile", [(1, 1), (3, 2), (4, 4), (7, 3),
                                       (8, 8), (20, 7), (20, 20), (64, 64)])
def test_split_merge_equals_unsplit(span, tile):
    q, kp, vp, table = _case(span + tile, len(LENGTHS), 2, 6, 4, 5)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    want = paged_decode_attention_ref(q, kp, vp, table, lens)
    got = _split_merge(q, kp, vp, table, lens, span, tile)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert (got[LENGTHS.index(0)] == 0).all()


def test_empty_spans_merge_to_nothing():
    """A slot split into spans where some lie past its length: the empty
    states (m = -1e30, l = 0, acc = 0) leave the merge unchanged."""
    q, kp, vp, table = _case(1, 1, 2, 8, 4, 6)
    lens = torch.tensor([9], dtype=torch.int32)
    with_empty = _split_merge(q, kp, vp, table, lens, 2, 2)  # 12 spans, 5 live
    live_only = _split_merge(q, kp, vp, table[:, :3], lens, 2, 2)  # 6, 5
    np.testing.assert_allclose(with_empty.numpy(), live_only.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,H,hd,ps,P,itemsize", [
    (8, 16, 64, 16, 9, 4),      # the serve path's decode step
    (8, 16, 64, 16, 64, 4),     # the long-context shape
    (8, 16, 64, 16, 64, 2),     # bf16 pools
    (3, 2, 80, 4, 3, 2),
    (1, 1, 64, 16, 1024, 4),    # a 16k-key row: spans of several tiles
    (1, 1, 4096, 16, 8, 4),     # a wide head: the rows bound the tile
])
def test_plan_covers_the_row_within_shared_memory(S, H, hd, ps, P, itemsize):
    """``_plan`` depends on the shapes only; at most ``MAX_SPLIT`` spans
    cover the row, and a tile's K and V rows (two tiles where a span takes
    several) fit the shared memory budget."""
    span, tile = pa_mod._plan(S, H, hd, ps, P, itemsize)
    keys = P * ps
    n = -(-keys // span)
    assert 1 <= tile <= span <= keys and n <= pa_mod.MAX_SPLIT
    ve = 16 // itemsize
    row = (-(-hd // ve) * ve + ve) * itemsize
    stages = 1 if tile == span else 2
    assert tile == 1 or 2 * stages * tile * row <= pa_mod.KV_SMEM


def test_plan_emulates_the_unsplit_version():
    """At the split ``_plan`` picks for a small shape (several spans, one
    of several tiles), the emulation still equals the plain version."""
    q, kp, vp, table = _case(5, 4, 2, 8, 4, 40)
    lens = torch.tensor([150, 0, 33, 160], dtype=torch.int32)
    span, tile = pa_mod._plan(4, 2, 8, 4, 40, 4)
    assert -(-160 // span) > 1  # the plan splits this row
    want = paged_decode_attention_ref(q, kp, vp, table, lens)
    got = _split_merge(q, kp, vp, table, lens, span, tile)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    got = _split_merge(q, kp, vp, table, lens, span, 3)  # several tiles
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
