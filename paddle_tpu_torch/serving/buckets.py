"""Shape buckets (counterpart of ``pow2_buckets`` in
``paddle_tpu/serving/buckets.py``). Prompts are right-padded to the next
bucket, which keeps the set of prefill shapes small."""
from __future__ import annotations

from typing import Tuple


def pow2_buckets(max_value: int, start: int = 1) -> Tuple[int, ...]:
    """(start, 2*start, ... , max_value) — max_value is always included."""
    out = []
    b = start
    while b < max_value:
        out.append(b)
        b *= 2
    out.append(max_value)
    return tuple(out)
