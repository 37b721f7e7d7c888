"""Shape buckets (counterpart of ``paddle_tpu/serving/buckets.py``).

Prompts are right-padded to the next bucket, which keeps the set of
prefill shapes small; the dynamic-batching :class:`~.engine.Engine`
rounds every batch up to the next member of a :class:`BucketSpec`. The
LLM engine captures one prefill graph per bucket; the detection engine
runs its callable eagerly but keeps the closed set of batch shapes: a
row-parallel model gives the same rows with or without the zero padding
rows, and the engine's counters stay those of the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def pow2_buckets(max_value: int, start: int = 1) -> Tuple[int, ...]:
    """(start, 2*start, ... , max_value) — max_value is always included."""
    out = []
    b = start
    while b < max_value:
        out.append(b)
        b *= 2
    out.append(max_value)
    return tuple(out)


class BucketSpec:
    """The batch (and optionally sequence) buckets the engine may run.

    ``batch_buckets`` bounds rows per dispatched batch (powers of two up
    to ``max_batch`` when empty); ``seq_buckets`` (optional) pads axis 1
    of rank>=2 inputs up to a bucket, which is only valid for models
    that mask padding, so it is opt-in."""

    def __init__(self, batch_buckets: Sequence[int] = (),
                 seq_buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 64):
        bb = tuple(sorted(set(int(b) for b in batch_buckets))) \
            or pow2_buckets(int(max_batch))
        if bb[0] < 1:
            raise ValueError(f"batch buckets must be >= 1, got {bb}")
        self.batch_buckets = bb
        self.seq_buckets = tuple(sorted(set(int(s) for s in seq_buckets))) \
            if seq_buckets else None

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def batch_bucket_for(self, rows: int) -> Optional[int]:
        """Smallest bucket >= rows, or None when rows exceed every
        bucket."""
        for b in self.batch_buckets:
            if rows <= b:
                return b
        return None

    def seq_bucket_for(self, seq: Optional[int]) -> Optional[int]:
        """Smallest sequence bucket >= seq; unbucketed lengths (or no
        sequence bucketing configured) pass through unchanged."""
        if seq is None or self.seq_buckets is None:
            return seq
        for s in self.seq_buckets:
            if seq <= s:
                return s
        return seq

    def __repr__(self):
        return (f"BucketSpec(batch={list(self.batch_buckets)}, "
                f"seq={list(self.seq_buckets) if self.seq_buckets else None})")


def pad_rows(arrays: Sequence[np.ndarray],
             bucket_rows: int) -> List[np.ndarray]:
    """Zero-pad the leading axis of every array up to ``bucket_rows``."""
    out = []
    for a in arrays:
        rows = a.shape[0]
        if rows == bucket_rows:
            out.append(a)
            continue
        if rows > bucket_rows:
            raise ValueError(f"{rows} rows do not fit bucket {bucket_rows}")
        pad = np.zeros((bucket_rows - rows,) + a.shape[1:], dtype=a.dtype)
        out.append(np.concatenate([a, pad], axis=0))
    return out


def pad_seq(arrays: Sequence[np.ndarray],
            seq_bucket: Optional[int]) -> List[np.ndarray]:
    """Zero-pad axis 1 of rank>=2 arrays up to ``seq_bucket`` (no-op when
    seq bucketing is off or the array is already that long)."""
    if seq_bucket is None:
        return list(arrays)
    out = []
    for a in arrays:
        if a.ndim < 2 or a.shape[1] >= seq_bucket:
            out.append(a)
            continue
        width = [(0, 0)] * a.ndim
        width[1] = (0, seq_bucket - a.shape[1])
        out.append(np.pad(a, width))
    return out


def unpad_rows(arrays: Sequence[np.ndarray], rows: int) -> List[np.ndarray]:
    """Slice each output back to the real row count."""
    return [a[:rows] if getattr(a, "ndim", 0) > 0 else a for a in arrays]
