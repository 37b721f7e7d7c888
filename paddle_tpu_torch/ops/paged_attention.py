"""Paged decode attention: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/paged_attention.py`` (``paged_attention``,
which launches the Pallas kernel ``_paged_attn_kernel``). One query per
sequence attends over K/V rows scattered across a page arena: logical row
``t`` of sequence ``s`` lives at page ``block_tables[s, t // page_size]``,
in-page row ``t % page_size``, and rows ``j <= positions[s]`` are visible.
The kernel is ``csrc/paged_attention.cu``; its source note says what
bounds it on the H100 and how its design answers that.

:func:`paged_attention` launches the kernel for CUDA tensors and runs the
plain version :func:`paged_attention_plain` for CPU tensors (the
counterpart of the JAX package's interpret mode). There is no fallback: a
CUDA input the kernel does not take raises. The arena arguments may be
strided layer views (``arena[:, li]`` of a ``[P+1, L, page, H, D]``
arena): the kernel reads them through their strides, so a view is never
copied. Not kept from the TPU: ``block_h`` and the tuner's winners.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

__all__ = ["paged_attention", "paged_attention_plain"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_HEAD_DIMS = (32, 64, 128)


def paged_attention_plain(q, k_arena, v_arena, block_tables, positions,
                          scale: Optional[float] = None):
    """The kernel's plain version: gather each sequence's rows through
    its block table, mask ``j > positions[s]`` and take an f32 softmax.
    Returns ``[S, H, D]`` in q's type."""
    s_n, h, d = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    bt = block_tables.long()
    kg = k_arena[bt].float()                  # [S, PP, page, H, D]
    vg = v_arena[bt].float()
    pp, page = kg.shape[1], kg.shape[2]
    kg = kg.reshape(s_n, pp * page, h, d)
    vg = vg.reshape(s_n, pp * page, h, d)
    scores = torch.einsum("shd,sjhd->shj", q.float() * sc, kg)
    j = torch.arange(pp * page, device=q.device)
    valid = (j[None, :] <= positions.long()[:, None])[:, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("shj,sjhd->shd", p / l, vg)
    return out.to(q.dtype)


def _lib():
    from .kernel_build import load
    lib = load("paged_attention")
    fn = lib.pt_paged_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
    return lib


def paged_attention(q, k_arena, v_arena, block_tables, positions,
                    scale: Optional[float] = None):
    """Single-token decode attention through a paged KV arena.

    ``q``: ``[S, H, D]``; ``k_arena``/``v_arena``: ``[P+1, page, H, D]``
    single-layer views (dense); ``block_tables``: ``[S, pages_per_seq]``
    int32; ``positions``: ``[S]`` int32. Returns ``[S, H, D]`` in q's
    type. CPU tensors take the plain version; CUDA tensors launch the
    kernel (float32 or bfloat16 matching q, D in (32, 64, 128), last dim
    contiguous) or raise."""
    if q.dim() != 3 or k_arena.dim() != 4 or v_arena.dim() != 4:
        raise ValueError("paged_attention takes q [S, H, D] and arenas "
                         "[P+1, page, H, D]")
    s_n, h, d = q.shape
    if k_arena.shape != v_arena.shape or k_arena.shape[2:] != (h, d):
        raise ValueError(
            f"paged_attention: arenas {tuple(k_arena.shape)} / "
            f"{tuple(v_arena.shape)} do not match q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != s_n \
            or positions.shape != (s_n,):
        raise ValueError("paged_attention: block_tables must be [S, PP] and "
                         "positions [S]")
    tensors = (q, k_arena, v_arena, block_tables, positions)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention: all inputs must share a device")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_arena, v_arena, block_tables,
                                     positions, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k_arena.dtype != q.dtype \
            or v_arena.dtype != q.dtype:
        raise TypeError("paged_attention kernel: q and the arenas must all "
                        "be float32 or all bfloat16")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged_attention kernel: block_tables and positions "
                        "must be int32")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if (q.stride(-1) != 1 or k_arena.stride(-1) != 1
            or v_arena.stride(-1) != 1 or block_tables.stride(-1) != 1
            or positions.stride(0) != 1):
        raise ValueError("paged_attention kernel: the last dim of every "
                         "input must be contiguous")
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((s_n, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 8)(
        *q.stride()[:2], *k_arena.stride()[:3], *v_arena.stride()[:3])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.pt_paged_attention(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            out.data_ptr(), block_tables.data_ptr(), positions.data_ptr(),
            s_n, h, d, k_arena.shape[1], block_tables.shape[1],
            k_arena.shape[0], strides, block_tables.stride(0), float(sc),
            _DTYPES[q.dtype], stream)
    paged_attention.launches += 1
    from .kernel_build import check
    check(lib, "pt_paged_attention_error_string", code,
          "paged attention kernel")
    return out


#: kernel launches since the count was last set to 0
paged_attention.launches = 0
