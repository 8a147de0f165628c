"""Ragged paged decode attention: kernel K2 (``csrc/paged_attention.cu``)
and its plain version.

Counterpart of ``mxnet_tpu/ops/pallas/paged_attention.py``: ONE query
per sequence slot attends over that slot's page-table-addressed K/V
pages, masked to the slot's own length, softmax in f32, exact zeros for
a slot of length 0.

Shapes: q (S, H, hd); k_pool/v_pool (N, page_size, H, hd); page_table
(S, P) int32; lengths (S,) int32.  Returns (S, H, hd) in q's dtype.
q and the pools may each be float32, bfloat16 or float16 (the JAX
engine's bf16 serving hands f32 q and bf16 pools); compute is f32.
Scores are scaled by ``sm_scale``, 1/sqrt(hd) when None, as in the JAX
function.  Lengths beyond ``P * page_size`` attend the whole table row,
as the TPU kernel does; page ids must lie in [0, N).

K2 splits each table row's keys into at most 8 spans of :func:`_plan`'s
length, chosen from the shapes alone (the lengths stay on the card); the
blocks of a (slot, head) form one thread block cluster and merge their
partial softmax states through distributed shared memory in the same
launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...base import MXNetError
from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_ref"]

_NEG = -1e30
# the split: enough blocks to fill the card, at most MAX_SPLIT blocks (a
# cluster) and at least MIN_SPAN keys a block; a tile's K and V rows (two
# tiles in flight when a span takes several) within KV_SMEM bytes of
# shared memory
TARGET_BLOCKS = 1024
MAX_SPLIT = 8
MIN_SPAN = 32
KV_SMEM = 48 * 1024


def _scale(hd: int, sm_scale):
    return 1.0 / math.sqrt(hd) if sm_scale is None else float(sm_scale)


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, lengths,
                               sm_scale=None):
    """Plain PyTorch version: gather each slot's pages into a dense
    (S, P * page_size, H, hd) view, softmax with the length mask in f32,
    zeros where length == 0."""
    S, H, hd = q.shape
    ps = k_pool.shape[1]
    P = page_table.shape[1]
    idx = page_table.reshape(-1).long()
    K = k_pool.index_select(0, idx).reshape(S, P * ps, H, hd).float()
    V = v_pool.index_select(0, idx).reshape(S, P * ps, H, hd).float()
    scores = torch.einsum("shd,slhd->shl", q.float() * _scale(hd, sm_scale),
                          K)
    kpos = torch.arange(P * ps, device=q.device)
    valid = kpos[None, :] < lengths.long()[:, None]            # (S, L)
    scores = scores.masked_fill(~valid[:, None, :], _NEG)
    out = torch.einsum("shl,slhd->shd", torch.softmax(scores, dim=-1), V)
    out = torch.where((lengths > 0)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def _plan(S: int, H: int, hd: int, ps: int, P: int, itemsize: int):
    """(span, tile): K2's split of the ``P * ps`` keys of a table row into
    spans (one block each, at most ``MAX_SPLIT``) and the keys a block
    stages at a time, from the shapes alone."""
    keys = P * ps
    ve = 16 // itemsize
    row = (-(-hd // ve) * ve + ve) * itemsize  # a staged row, padded
    n_split = max(1, min(MAX_SPLIT, -(-TARGET_BLOCKS // max(1, S * H)),
                         -(-keys // MIN_SPAN)))
    span = -(-keys // n_split)
    if 2 * span * row <= KV_SMEM:  # the span in one tile
        return span, span
    cap = max(1, KV_SMEM // (4 * row))  # two tiles in flight
    n_tiles = -(-span // cap)
    return span, -(-span // n_tiles)


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.mx_paged_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check_args(q, k_pool, v_pool, page_table, lengths):
    what = "paged_decode_attention"
    if q.dim() != 3 or k_pool.dim() != 4 or page_table.dim() != 2:
        raise MXNetError(f"{what}: expected q (S, H, hd), pools (N, ps, H, "
                         "hd), page_table (S, P)")
    S, H, hd = q.shape
    N, ps = k_pool.shape[:2]
    want = {"q": (q, None, (S, H, hd)),
            "k_pool": (k_pool, None, (N, ps, H, hd)),
            "v_pool": (v_pool, k_pool.dtype, (N, ps, H, hd)),
            "page_table": (page_table, torch.int32,
                           (S, page_table.shape[1])),
            "lengths": (lengths, torch.int32, (S,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != q.device:
            raise MXNetError(f"{what}: {name} on {t.device}, q on "
                             f"{q.device}")
        if dtype is not None and t.dtype != dtype:
            raise MXNetError(f"{what}: the kernel takes {name} as {dtype}, "
                             f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise MXNetError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise MXNetError(f"{what}: {name} must be contiguous")
    if page_table.shape[1] == 0 or ps == 0:
        raise MXNetError(f"{what}: empty page table or pages")


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths,
                           sm_scale=None):
    """softmax(q K_pages^T * sm_scale) V_pages per slot, masked to each
    slot's own length.  CPU tensors take the plain version; CUDA tensors
    launch K2 on the current stream or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, page_table,
                                          lengths, sm_scale)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    _check_args(q, k_pool, v_pool, page_table, lengths)
    what = "paged_decode_attention"
    q_dt = _build.dtype_code(q, what, "q")
    kv_dt = _build.dtype_code(k_pool, what, "k_pool and v_pool")
    lib = _lib()
    S, H, hd = q.shape
    ps, P = k_pool.shape[1], page_table.shape[1]
    span, tile = _plan(S, H, hd, ps, P, k_pool.element_size())
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mx_paged_decode_attention(
            q.data_ptr(), q_dt, k_pool.data_ptr(), v_pool.data_ptr(), kv_dt,
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), S, H,
            hd, ps, P, span, tile, _scale(hd, sm_scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, what)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
