"""paddle_tpu_torch.tuner: the kernel autotuner (counterpart of
``paddle_tpu/tuner``).

The ``get_*`` lookups resolve a ``(shape, dtype, platform)`` key
through these tiers:

1. **in-process memo** — after the first resolution a key costs one dict
   lookup,
2. **on-disk winner cache** — ``PADDLE_TPU_TUNE_CACHE`` (default
   ``~/.cache/paddle_tpu/tuning/``), versioned JSON written by
   :func:`record_winner` (and :func:`autotune_paged_attn` when asked to
   record), shared by every process that mounts it,
3. **committed defaults** — the port's own ``default_winners.json``:
   only winners measured on the H100, each with a note,
4. **the kernel's rule** — with no winner, the launch is exactly what it
   was before the tuner existed.

B4's launch path (:func:`paged_blocks_per_sm`) reads the committed
table alone, through a memo keyed by a tuple, so a launch formats no
string and never opens the disk cache. The search times full sequences
while a decode batch's lengths are mixed, and the key does not carry the
mix: a searched winner can be slower on the main path (the blocks-per-SM
target 1 at 1,024 rows beat the rule alone and lost to it at a decode
batch's positions on the H100). So a winner reaches the main path only
by being committed to the table after it beats the rule at the main
path's positions; a search or a disk entry cannot change it.

Families: ``paged_attn`` (B4) is the one real family. Its config is
``{"blocks_per_sm": n}``, the target of B4's split
(:func:`~paddle_tpu_torch.ops.paged_attention.chunk_pages_for`), keyed
``paged_attn|<platform>|<dtype>|h<heads>|d<head_dim>|p<page>`` as in the
JAX package; a cached entry that is not such a config (the JAX package's
``{"block_h": ...}``, a malformed one) is ignored with a warning and
the rule applies. ``flash_*``, ``nms`` and ``compress`` keep their keys
and lookups so the API matches, but no kernel of the port reads them:
B1–B3's tiles and B5's are compile-time constants
(:func:`autotune_flash` raises saying so); the compressed all-reduce
(``distributed/collective.py``) reads a cached block, and its search is
ROADMAP.md queue A10's second slice.

The platform part of a key is ``cuda-sm<major><minor>`` for a card (the
H100 is ``cuda-sm90``) and ``cpu`` for the CPU: never the JAX package's
``gpu`` or ``tpu``, so a shared cache directory keeps the packages'
winners in separate files. Active search happens only in
:func:`autotune_paged_attn`, called by a person or a script; a launch
never searches (the reference's ``PADDLE_TPU_AUTOTUNE`` tune-on-miss
switch, which none of its kernels reads, is not carried), so no search
ever runs inside a CUDA-graph capture.
"""
from __future__ import annotations

import functools
import threading
import warnings
from typing import Any, Dict, Optional, Tuple

from ..core.device import DeviceLike, resolve_device
from . import runner, space, store
from .space import paged_attn_candidates
from .store import CACHE_VERSION, WinnerStore, cache_dir, store_for

__all__ = [
    "CACHE_VERSION", "WinnerStore", "cache_dir", "store_for",
    "platform_tag", "flash_key", "nms_key", "compress_key", "paged_key",
    "get_flash_blocks", "get_spec_verify_blocks", "get_nms_config",
    "get_compress_block", "get_paged_attn_config", "paged_blocks_per_sm",
    "record_winner", "autotune_flash", "autotune_compress",
    "autotune_paged_attn",
    "paged_attn_candidates", "clear_memo",
]

#: resolved configs, keyed by canonical key string
_MEMO: Dict[str, Optional[Dict[str, Any]]] = {}
#: B4's resolved targets, keyed by (device type, index, heads, head dim,
#: page, torch dtype): the launch path's tier
_PAGED: Dict[Tuple, Optional[int]] = {}
_MEMO_LOCK = threading.Lock()


def clear_memo() -> None:
    """Forget every resolution (both memos and the loaded stores): the
    next lookup reads the disk and the defaults again."""
    with _MEMO_LOCK:
        _MEMO.clear()
        _PAGED.clear()
    store._reset_for_tests()


@functools.lru_cache(maxsize=None)
def _cuda_tag(index: int) -> str:
    import torch
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda-sm{major}{minor}"


def platform_tag(device: DeviceLike = None) -> str:
    """The platform part of a key: ``cpu``, or ``cuda-sm<major><minor>``
    of the card (the port's device rule picks it when none is given)."""
    dev = resolve_device(device)
    return "cpu" if dev.type == "cpu" else _cuda_tag(dev.index)


def _dtype_name(dtype) -> str:
    """``float32``/``bfloat16``/... for a torch dtype, a NumPy dtype or a
    name (the JAX package's spelling)."""
    s = str(dtype)
    if s.startswith("torch."):
        return s[len("torch."):]
    try:
        import numpy as _np
        return _np.dtype(dtype).name
    except TypeError:
        return s


def _ceil16(n: int) -> int:
    return max(16, -(-int(n) // 16) * 16)


# -- canonical keys -----------------------------------------------------------

def flash_key(q_len: int, kv_len: int, head_dim: int, dtype: str,
              causal: bool, platform: Optional[str] = None,
              ring: bool = False, bwd: bool = False, *,
              device: DeviceLike = None) -> str:
    """Key for the flash-attention family (the JAX package's grammar:
    lengths canonicalized to 16-row multiples, ``ring`` and ``bwd``
    selecting the ring-flash and backward variants)."""
    p = platform or platform_tag(device)
    if bwd:
        fam = "ring_flash_bwd" if ring else "flash_bwd"
    else:
        fam = "ring_flash" if ring else "flash_fwd"
    return (f"{fam}|{p}|{_dtype_name(dtype)}|d{int(head_dim)}"
            f"|q{_ceil16(q_len)}|k{_ceil16(kv_len)}|c{int(bool(causal))}")


def paged_key(num_heads: int, head_dim: int, page_size: int, dtype: str,
              platform: Optional[str] = None, *,
              device: DeviceLike = None) -> str:
    """Key for the paged decode-attention family (B4). The query is one
    token per sequence, so the shape family is (heads, head_dim,
    page_size); the sequences and their pages scale the chunk count."""
    p = platform or platform_tag(device)
    return (f"paged_attn|{p}|{_dtype_name(dtype)}|h{int(num_heads)}"
            f"|d{int(head_dim)}|p{int(page_size)}")


def nms_key(k: int, platform: Optional[str] = None, *,
            device: DeviceLike = None) -> str:
    return f"nms|{platform or platform_tag(device)}|k{int(k)}"


def compress_key(nelems: int, wire_dtype: str = "int8",
                 platform: Optional[str] = None, *,
                 device: DeviceLike = None) -> str:
    """Key for the compressed-allreduce quantize-block family: sizes
    bucketed to the next power of two with a 64-element floor."""
    n = max(64, int(nelems))
    bucket = 1 << (n - 1).bit_length()
    return (f"compress|{platform or platform_tag(device)}|{wire_dtype}"
            f"|n{bucket}")


# -- lookup -------------------------------------------------------------------

def _resolve(key: str) -> Optional[Dict[str, Any]]:
    with _MEMO_LOCK:
        if key in _MEMO:
            return _MEMO[key]
    cfg = store_for(key.split("|", 2)[1]).lookup(key)
    with _MEMO_LOCK:
        _MEMO[key] = cfg
    return cfg


def get_flash_blocks(q_len: int, kv_len: int, head_dim: int, dtype: str,
                     causal: bool, ring: bool = False, bwd: bool = False,
                     *, device: DeviceLike = None
                     ) -> Optional[Tuple[int, int]]:
    """The cached (block_q, block_k) for a flash-attention shape, or None.
    No kernel of the port reads it: B1–B3's tiles are compile-time
    constants (``csrc/flash_attention_fwd.cu``)."""
    cfg = _resolve(flash_key(q_len, kv_len, head_dim, dtype, causal,
                             ring=ring, bwd=bwd, device=device))
    if not cfg:
        return None
    try:
        return int(cfg["block_q"]), int(cfg["block_k"])
    except (KeyError, TypeError, ValueError):
        return None


def get_spec_verify_blocks(k: int, kv_len: int, head_dim: int,
                           dtype: str = "float32", *,
                           device: DeviceLike = None
                           ) -> Optional[Tuple[int, int]]:
    """The speculative verify's flash family (q = k+1, causal)."""
    return get_flash_blocks(k + 1, kv_len, head_dim, dtype, causal=True,
                            device=device)


def _paged_config(key: str, cfg) -> Optional[Dict[str, int]]:
    """A cached ``paged_attn`` entry as a B4 config, or None (with a
    warning when an entry is there but is not one)."""
    if cfg is None:
        return None
    bps = cfg.get("blocks_per_sm") if isinstance(cfg, dict) else None
    if isinstance(bps, int) and not isinstance(bps, bool) and bps > 0:
        return {"blocks_per_sm": bps}
    warnings.warn(
        f"paddle_tpu_torch.tuner: ignoring {key}: {cfg!r} is not a B4 "
        f"config (a positive int 'blocks_per_sm'); B4 keeps its chunk "
        f"rule")
    return None


def get_paged_attn_config(num_heads: int, head_dim: int, page_size: int,
                          dtype: str, *, device: DeviceLike = None
                          ) -> Optional[Dict[str, int]]:
    """The tuned ``{"blocks_per_sm": n}`` for a B4 shape, or None when no
    winner is known (the kernel's rule applies)."""
    key = paged_key(num_heads, head_dim, page_size, dtype, device=device)
    return _paged_config(key, _resolve(key))


def paged_blocks_per_sm(num_heads: int, head_dim: int, page_size: int,
                        dtype, device) -> Optional[int]:
    """B4's launch-path lookup: the committed table's blocks-per-SM target
    for this shape on ``device`` (a ``torch.device``), or None for the
    rule; the disk cache is not read (module docstring). A tuple-keyed
    dict hit after the first call of each shape."""
    key = (device.type, device.index, num_heads, head_dim, page_size, dtype)
    try:
        return _PAGED[key]
    except KeyError:
        pass
    skey = paged_key(num_heads, head_dim, page_size, dtype, device=device)
    cfg = _paged_config(skey, store.committed(skey))
    bps = None if cfg is None else cfg["blocks_per_sm"]
    with _MEMO_LOCK:
        _PAGED[key] = bps
    return bps


def get_nms_config(k: int, *, device: DeviceLike = None
                   ) -> Optional[Dict[str, Any]]:
    """The cached NMS config, or None. B5's tile (``T = 64``,
    ``csrc/greedy_nms.cu``) is a compile-time constant: nothing reads
    it."""
    return _resolve(nms_key(k, device=device))


def get_compress_block(nelems: int, wire_dtype: str = "int8", *,
                       device: DeviceLike = None) -> Optional[int]:
    """The cached quantize block for a gradient-size family, or None (the
    compressed all-reduce then takes 256)."""
    cfg = _resolve(compress_key(nelems, wire_dtype, device=device))
    if not cfg:
        return None
    try:
        return int(cfg["block"])
    except (KeyError, TypeError, ValueError):
        return None


def record_winner(key: str, config: Dict[str, Any],
                  us: Optional[float] = None) -> None:
    """Write a winner to the disk cache and refresh the memo (not B4's
    launch path, which reads the committed table alone)."""
    store_for(key.split("|", 2)[1]).record(key, config, us=us)
    with _MEMO_LOCK:
        _MEMO[key] = dict(config)


# -- active search ------------------------------------------------------------

def autotune_flash(*args, **kwargs):
    """B1–B3 expose no tile at run time: ``BQ = BK = 64`` and
    ``STAGES = 3`` are compile-time constants of
    ``csrc/flash_attention_fwd.cu`` (and of the backward kernels through
    ``csrc/flash_mma.cuh``), so there is nothing to search."""
    raise NotImplementedError(
        "autotune_flash: the port's flash kernels (B1-B3) take no tile at "
        "run time - BQ = BK = 64 and STAGES = 3 are compile-time constants "
        "of csrc/flash_attention_fwd.cu; exposing a tile choice is kernel "
        "work (ROADMAP.md queue B1)")


def autotune_compress(*args, **kwargs):
    """Searching the compressed all-reduce's block is not ported (the
    all-reduce itself is, ``distributed/collective.py``)."""
    raise NotImplementedError(
        "autotune_compress: the compressed all-reduce "
        "(distributed/collective.py) is ported; searching its block is "
        "the second slice of the port's distributed work (ROADMAP.md "
        "queue A10)")


def autotune_paged_attn(num_seqs: int, num_heads: int, head_dim: int,
                        page_size: int, pages_per_seq: int = 8,
                        dtype: str = "float32", trials: int = 5,
                        record: bool = False, *, iters: int = 20,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """Search B4's blocks-per-SM target for one shape by timing the
    kernel on the device's clock over a synthetic full arena (every
    sequence owns ``pages_per_seq`` disjoint pages, positions at the last
    row: the longest page walk). With ``record`` the winner is written to
    the disk cache under :func:`paged_key`, where the ``get_*`` lookups
    read it; B4's launches do not (module docstring).

    Candidates come from :func:`~paddle_tpu_torch.tuner.space.
    paged_attn_candidates` (pruned to the kernel's limits before any
    launch). A launch that fails raises. Returns ``{"blocks_per_sm",
    "us", "chunk_pages", "results", "rounds", "rule", "launches"}``:
    ``results`` maps each candidate to its median seconds, ``rounds`` to
    every timed trial's seconds, ``rule`` is the chunk rule's own target
    with its median µs, ``launches`` the wrapper calls the search made
    (each one kernel launch). On the CPU B4 is its plain version, which
    has no tile: raises.
    """
    import torch
    from ..ops import paged_attention as pa
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(
            f"autotune_paged_attn: B4 on {dev} is its plain version, which "
            f"has no tile to choose; tune on a CUDA device")
    tdt = getattr(torch, _dtype_name(dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    num_pages = num_seqs * pages_per_seq

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(tdt)
    q = randn(num_seqs, num_heads, head_dim)
    k_arena = randn(num_pages + 1, page_size, num_heads, head_dim)
    v_arena = randn(num_pages + 1, page_size, num_heads, head_dim)
    bt = torch.arange(num_pages, dtype=torch.int32, device=dev).reshape(
        num_seqs, pages_per_seq)
    positions = torch.full((num_seqs,), pages_per_seq * page_size - 1,
                           dtype=torch.int32, device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rule = {"blocks_per_sm": pa.BLOCKS_PER_SM}
    # the rule first: the first candidate is never pruned early
    cands = sorted(paged_attn_candidates(num_seqs, num_heads, pages_per_seq,
                                         n_sms), key=lambda c: c != rule)
    calls = [0]

    def make_runner(cand):
        b = cand["blocks_per_sm"]

        def run():
            calls[0] += 1
            return pa.paged_attention(q, k_arena, v_arena, bt, positions,
                                      blocks_per_sm=b)
        return run

    rounds: Dict[str, list] = {}
    best, best_t, results = runner.search(cands, make_runner, trials=trials,
                                          iters=iters, rounds=rounds)
    torch.cuda.synchronize(dev)
    cfg = {"blocks_per_sm": int(best["blocks_per_sm"])}
    us = best_t * 1e6
    if record:
        record_winner(paged_key(num_heads, head_dim, page_size, dtype,
                                device=dev), cfg, us=us)
    seq_heads = num_seqs * num_heads
    return dict(cfg, us=us, results=results, rounds=rounds,
                chunk_pages={repr(c): pa.chunk_pages_for(
                    pages_per_seq, seq_heads, n_sms, c["blocks_per_sm"])
                    for c in cands},
                rule=dict(rule, us=results.get(repr(rule), float("nan"))
                          * 1e6),
                launches=calls[0])
