"""Paged decode attention: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/paged_attention.py`` (``paged_attention``,
which launches the Pallas kernel ``_paged_attn_kernel``). One query per
sequence attends over K/V rows scattered across a page arena: logical row
``t`` of sequence ``s`` lives at page ``block_tables[s, t // page_size]``,
in-page row ``t % page_size``, and rows ``j <= positions[s]`` are visible.
The kernel is ``csrc/paged_attention.cu``; its source note says what
bounds it on the H100 and how its design answers that. It cuts each
sequence's visible rows into chunks of :func:`chunk_pages_for` pages,
spreads the chunks over blocks and merges them inside the same launch;
the wrapper hands it a workspace for the chunks' partial softmax states
and a per-(sequence, head) ticket array that every launch leaves zero,
both made once per device, stream and size. Since every launch leaves
the tickets zero, a CUDA graph replays the launch as often as it likes.
Under a capture (``core.graphs``) both belong to the graph's state
rather than to the stream: they are made in the warm-up run that
precedes the capture, outside the graph's memory pool, and a capture
that finds none raises.

:func:`paged_attention` launches the kernel for CUDA tensors and runs the
plain version :func:`paged_attention_plain` for CPU tensors (the
counterpart of the JAX package's interpret mode). There is no fallback: a
CUDA input the kernel does not take raises. The kernel takes float32,
bfloat16 and float16 at any head dim up to :data:`MAX_HEAD_DIM`, as the
TPU kernel takes any type and head dim; rows of whole 16-byte vectors at
16-byte aligned addresses load 16 bytes a lane, other rows (D = 100 in
bfloat16, a view shifted off 16 bytes) one element a lane. The arena
arguments may be strided layer views (``arena[:, li]`` of a
``[P+1, L, page, H, D]`` arena): the kernel reads them through their
strides, so a view is never copied.

The tuner's ``paged_attn`` family (:mod:`paddle_tpu_torch.tuner`) tunes
the split's target of blocks per SM in place of the TPU's ``block_h``:
before the launch the wrapper looks the shape's winner up in the port's
committed table (a dict hit keyed by a tuple after its first call; never
the disk cache a search writes), and with none the rule's
:data:`BLOCKS_PER_SM` stands, so the launch is what it was before the
tuner. A winner changes only how many pages a chunk holds, never the
arithmetic inside a chunk. The TPU's own winners are not kept.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from ..core import graphs
from ..observability import stepmeter as _sm
from ..tuner import paged_blocks_per_sm

__all__ = ["paged_attention", "paged_attention_plain", "chunk_pages_for",
           "takes"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the widest head the kernel takes
MAX_HEAD_DIM = 1024

#: blocks per SM the chunking aims at when every sequence is full
BLOCKS_PER_SM = 8
#: the most pages of one chunk (the kernel keeps them in shared memory)
MAX_CHUNK_PAGES = 1024


def chunk_pages_for(pages_per_seq: int, seq_heads: int, n_sms: int,
                    blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Pages per chunk of B4's split: enough chunks that ``seq_heads``
    (sequences x heads) full sequences fill ``n_sms`` SMs with about
    ``blocks_per_sm`` (the rule's :data:`BLOCKS_PER_SM`, or the tuner's
    winner) blocks each, never more chunks than pages, then the chunks as
    even as whole pages allow. A fixed rule of the shapes and the card:
    it reads no data and no environment."""
    chunks = -(-blocks_per_sm * n_sms // max(1, seq_heads))
    chunks = max(1, min(pages_per_seq, chunks))
    return min(-(-pages_per_seq // chunks), MAX_CHUNK_PAGES)


def takes(head_dim: int, dtype) -> bool:
    """Whether the kernel takes heads of ``head_dim`` in ``dtype``:
    float32, bfloat16 or float16, from 1 to :data:`MAX_HEAD_DIM`. The one
    rule of the kernel's shapes: the wrapper refuses by it and the paged
    decoder checks its lane by it."""
    return dtype in _DTYPES and 0 < head_dim <= MAX_HEAD_DIM


def _vec_bytes(tensors, d: int, es: int) -> int:
    """The bytes a lane loads at once: 16 where a row is whole 16-byte
    vectors and every base pointer and stride of ``tensors`` is 16-byte
    aligned, else one element."""
    if d * es % 16:
        return es
    for t in tensors:
        if t.data_ptr() % 16 or any(st * es % 16 for st, n in zip(
                t.stride()[:-1], t.shape[:-1]) if n > 1):
            return es
    return 16


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SCRATCH: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_SCRATCH_LOCK = threading.Lock()


def _scratch(device, stream: int, n_tickets: int, n_ws: int):
    """(tickets, workspace) for launches on ``stream``, made once per
    device, stream and sizes: ``n_tickets`` int32 zeros that each launch
    leaves zero again, and ``n_ws`` f32 that each launch writes before it
    reads them. Launches on one stream run in order, so they share both,
    and none needs a fill or an allocation. During a graph's warm-up and
    capture the key is the graph's state (:func:`graphs.scratch_owner`)
    instead of the stream: that state's graphs run one at a time, and
    another state's graphs replayed beside them never share its scratch.
    A capture that finds no scratch raises: made inside the capture it
    would live in the graph's private pool."""
    owner = graphs.scratch_owner()
    key = (device.index, ("stream", stream) if owner is None
           else ("graph", owner), n_tickets, n_ws)
    with _SCRATCH_LOCK:
        got = _SCRATCH.get(key)
        if got is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "paged_attention: no scratch for this launch under "
                    "capture; the warm-up run before the capture makes it")
            got = _SCRATCH[key] = (
                torch.zeros(n_tickets, dtype=torch.int32, device=device),
                torch.empty(n_ws, dtype=torch.float32, device=device))
        return got


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


def _note(q, k_arena, block_tables, positions):
    """While a FLOP count runs (``observability.stepmeter``), add the
    kernel's work on this data: ``4*rows*H*D``, ``rows`` the KV rows the
    sequences attend (``positions + 1``, at most their pages' rows), as
    PERF.md's bound counts it. Reads the positions on the host, so never
    inside a capture."""
    if not _sm.counting() or (q.is_cuda
                              and torch.cuda.is_current_stream_capturing()):
        return False
    cap = block_tables.shape[1] * k_arena.shape[1]
    rows = int((positions.long() + 1).clamp(max=cap).sum().item())
    _sm.note_kernel_flops("paged_attention",
                          4.0 * rows * q.shape[1] * q.shape[2])
    return True


def _lib():
    from .kernel_build import load
    lib = load("paged_attention")
    fn = lib.pt_paged_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return lib


def paged_attention(q, k_arena, v_arena, block_tables, positions,
                    scale: Optional[float] = None,
                    blocks_per_sm: Optional[int] = None):
    """Single-token decode attention through a paged KV arena.

    ``q``: ``[S, H, D]``; ``k_arena``/``v_arena``: ``[P+1, page, H, D]``
    single-layer views (dense); ``block_tables``: ``[S, pages_per_seq]``
    int32; ``positions``: ``[S]`` int32. Returns ``[S, H, D]`` in q's
    type. CPU tensors take the plain version; CUDA tensors launch the
    kernel (float32, bfloat16 or float16 matching q, a head dim
    :func:`takes` accepts, last dim contiguous) or raise. Int8 arenas
    (the ``{"q", "s"}`` pages of an int8 KV cache, or int8 tensors) raise
    on every device, as the JAX package's wrapper refuses them: their
    decode dequantizes on the gather lane. ``blocks_per_sm`` forces the
    split's target (the tuner's search passes it); by default it is the
    committed table's winner for the shape, else :data:`BLOCKS_PER_SM`. The CPU's
    plain version has no split and ignores it."""
    if any(isinstance(a, dict) or a.dtype == torch.int8
           for a in (k_arena, v_arena)):
        raise ValueError("paged_attention reads dense arenas (float32, "
                         "bfloat16 or float16); int8 pages take the gather "
                         "lane, which dequantizes them")
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
        if not _note(q, k_arena, block_tables, positions):
            return paged_attention_plain(q, k_arena, v_arena, block_tables,
                                         positions, scale)
        with _sm.uncounted():
            return paged_attention_plain(q, k_arena, v_arena, block_tables,
                                         positions, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k_arena.dtype != q.dtype \
            or v_arena.dtype != q.dtype:
        raise TypeError("paged_attention kernel: q and the arenas must all "
                        "be float32, all bfloat16 or all float16")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged_attention kernel: block_tables and positions "
                        "must be int32")
    if not takes(d, q.dtype):
        raise ValueError(
            f"paged_attention kernel: head_dim {d} in {q.dtype} is not "
            f"taken (float32, bfloat16 or float16, at most {MAX_HEAD_DIM})")
    if (q.stride(-1) != 1 or k_arena.stride(-1) != 1
            or v_arena.stride(-1) != 1 or block_tables.stride(-1) != 1
            or positions.stride(0) != 1):
        raise ValueError("paged_attention kernel: the last dim of every "
                         "input must be contiguous")
    vec = _vec_bytes((q, k_arena, v_arena), d, q.element_size())
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    pps = block_tables.shape[1]
    out = torch.empty((s_n, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 8)(
        *q.stride()[:2], *k_arena.stride()[:3], *v_arena.stride()[:3])
    lib = _lib()
    if blocks_per_sm is None:
        blocks_per_sm = paged_blocks_per_sm(
            h, d, k_arena.shape[1], q.dtype, q.device) or BLOCKS_PER_SM
    elif int(blocks_per_sm) < 1:
        raise ValueError(f"paged_attention: blocks_per_sm must be >= 1, got "
                         f"{blocks_per_sm}")
    with torch.cuda.device(q.device):
        chunk = chunk_pages_for(pps, s_n * h, _sm_count(q.device.index),
                                int(blocks_per_sm))
        n_chunks = -(-pps // chunk)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tickets, ws = _scratch(q.device, stream, s_n * h,
                               s_n * h * n_chunks * (d + 2))
        code = lib.pt_paged_attention(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            out.data_ptr(), block_tables.data_ptr(), positions.data_ptr(),
            ws.data_ptr(), tickets.data_ptr(), s_n, h, d, k_arena.shape[1],
            pps, k_arena.shape[0], chunk, strides, block_tables.stride(0),
            float(sc), _DTYPES[q.dtype], vec, stream)
    graphs.note_launch(paged_attention)
    _note(q, k_arena, block_tables, positions)
    from .kernel_build import check
    check(lib, "pt_paged_attention_error_string", code,
          "paged attention kernel")
    return out


#: kernel launches since the count was last set to 0 (a graph's replay
#: adds the launches it captured)
paged_attention.launches = 0
