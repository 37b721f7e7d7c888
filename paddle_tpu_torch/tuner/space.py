"""Candidate spaces for the kernel autotuner (counterpart of
``paddle_tpu/tuner/space.py``).

A family exists only where a CUDA kernel of the port takes a tile
choice at run time. Today that is B4 alone (``csrc/paged_attention.cu``):
its split takes ``chunk_pages`` at launch, and the wrapper derives it
from a target of blocks per SM (:func:`~paddle_tpu_torch.ops.
paged_attention.chunk_pages_for`). The tuned quantity is that target,
so a winner stays a property of (heads, head dim, page, dtype) while the
chunk count still scales with the sequences and their pages. B1–B3's
tiles and B5's are compile-time constants, so they have no space here;
the reference's VMEM budgets describe a TPU core and are not carried.
"""
from __future__ import annotations

from typing import Dict, List

#: the blocks-per-SM targets the B4 family tries; the chunk rule's own
#: (``ops/paged_attention.py::BLOCKS_PER_SM``) is among them
PAGED_BLOCKS_PER_SM = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
#: the most chunks of one sequence the kernel's grid takes
#: (``csrc/paged_attention.cu``: its third grid dimension)
MAX_CHUNKS = 65535


def paged_attn_candidates(num_seqs: int, num_heads: int,
                          pages_per_seq: int, n_sms: int
                          ) -> List[Dict[str, int]]:
    """``{"blocks_per_sm": b}`` candidates for one B4 launch shape: each
    target's chunking (:func:`chunk_pages_for`) within the kernel's
    limits (at most ``MAX_CHUNK_PAGES`` pages a chunk and
    :data:`MAX_CHUNKS` chunks), one candidate per distinct chunking (the
    rule's target where it is one of them), sorted by target."""
    from ..ops.paged_attention import (BLOCKS_PER_SM, MAX_CHUNK_PAGES,
                                       chunk_pages_for)
    seq_heads = num_seqs * num_heads
    by_chunk: Dict[int, int] = {}
    for b in (BLOCKS_PER_SM,) + PAGED_BLOCKS_PER_SM:
        cp = chunk_pages_for(pages_per_seq, seq_heads, n_sms, b)
        if not 1 <= cp <= MAX_CHUNK_PAGES \
                or -(-pages_per_seq // cp) > MAX_CHUNKS:
            continue
        by_chunk.setdefault(cp, b)
    return [{"blocks_per_sm": b} for b in sorted(by_chunk.values())]
