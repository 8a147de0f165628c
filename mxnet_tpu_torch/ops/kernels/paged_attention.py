"""Ragged paged decode attention: kernel K2 (``csrc/paged_attention.cu``)
and its plain version.

Counterpart of ``mxnet_tpu/ops/pallas/paged_attention.py``: ONE query
per sequence slot attends over that slot's page-table-addressed K/V
pages, masked to the slot's own length, softmax in f32, exact zeros for
a slot of length 0.

Shapes: q (S, H, hd); k_pool/v_pool (N, page_size, H, hd); page_table
(S, P) int32; lengths (S,) int32.  Returns (S, H, hd) in q's dtype.
Scores are scaled by 1/sqrt(hd), the JAX kernel's default.
Lengths beyond ``P * page_size`` attend the whole table row, as the TPU
kernel does; page ids must lie in [0, N).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...base import MXNetError
from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_ref"]

_NEG = -1e30


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, lengths):
    """Plain PyTorch version: gather each slot's pages into a dense
    (S, P * page_size, H, hd) view, softmax with the length mask in f32,
    zeros where length == 0."""
    S, H, hd = q.shape
    ps = k_pool.shape[1]
    P = page_table.shape[1]
    idx = page_table.reshape(-1).long()
    K = k_pool.index_select(0, idx).reshape(S, P * ps, H, hd).float()
    V = v_pool.index_select(0, idx).reshape(S, P * ps, H, hd).float()
    scores = torch.einsum("shd,slhd->shl", q.float() * (1.0 / math.sqrt(hd)),
                          K)
    kpos = torch.arange(P * ps, device=q.device)
    valid = kpos[None, :] < lengths.long()[:, None]            # (S, L)
    scores = scores.masked_fill(~valid[:, None, :], _NEG)
    out = torch.einsum("shl,slhd->shd", torch.softmax(scores, dim=-1), V)
    out = torch.where((lengths > 0)[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.mx_paged_decode_attention_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.mx_paged_attention_max_hd.restype = ctypes.c_int
    return lib


def _check_args(q, k_pool, v_pool, page_table, lengths, max_hd: int):
    if q.dim() != 3 or k_pool.dim() != 4 or page_table.dim() != 2:
        raise MXNetError("paged_decode_attention: expected q (S, H, hd), "
                         "pools (N, ps, H, hd), page_table (S, P)")
    S, H, hd = q.shape
    N, ps = k_pool.shape[:2]
    want = {"q": (q, torch.float32, (S, H, hd)),
            "k_pool": (k_pool, torch.float32, (N, ps, H, hd)),
            "v_pool": (v_pool, torch.float32, (N, ps, H, hd)),
            "page_table": (page_table, torch.int32,
                           (S, page_table.shape[1])),
            "lengths": (lengths, torch.int32, (S,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != q.device:
            raise MXNetError(f"paged_decode_attention: {name} on "
                             f"{t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise MXNetError(f"paged_decode_attention: the kernel takes "
                             f"{name} as {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise MXNetError(f"paged_decode_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise MXNetError(f"paged_decode_attention: {name} must be "
                             "contiguous and 16-byte aligned")
    if hd % 4 or hd > max_hd:
        raise MXNetError(f"paged_decode_attention: the kernel takes "
                         f"head_dim % 4 == 0 and <= {max_hd}, got {hd}")


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths):
    """softmax(q K_pages^T / sqrt(hd)) V_pages per slot, masked to each
    slot's own length.  CPU tensors take the plain version; CUDA tensors
    launch K2 on the current stream or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, page_table,
                                          lengths)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    lib = _lib()
    _check_args(q, k_pool, v_pool, page_table, lengths,
                lib.mx_paged_attention_max_hd())
    S, H, hd = q.shape
    ps, P = k_pool.shape[1], page_table.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mx_paged_decode_attention_f32(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            S, H, hd, ps, P, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
