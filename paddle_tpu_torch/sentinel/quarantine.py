"""Quarantine directory: offline repro artifacts for poisoned batches
(counterpart of ``paddle_tpu/sentinel/quarantine.py``; the JAX package's
file layout, so each package reads the other's dumps).

When the policy ladder reaches ``quarantine_batch`` (or ``halt``), the
offending inputs and the step metadata are dumped here so the batch can
be replayed offline. Layout::

    <quarantine_dir>/
      step_<n>/
        inputs.npz   # x0, x1, ..., y0, y1, ...  (host copies)
        meta.json    # step, reasons, loss, z, shapes/dtypes, wall time

Writes go through a ``.tmp_`` dir and a rename, and the directory is
capped (``max_entries``). A cold path: only an anomalous step copies its
batch to the host.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import monitor as _monitor


def _to_host(val) -> np.ndarray:
    """A batch element (an array, a tensor or a Tensor) as a host array;
    bfloat16 widens to float32 (NumPy has no bfloat16)."""
    data = getattr(val, "_data", val)
    if isinstance(data, torch.Tensor):
        data = data.detach()
        if data.dtype == torch.bfloat16:
            data = data.float()
        return data.cpu().numpy()
    return np.asarray(data)


def _entry_count(root: str) -> int:
    if not os.path.isdir(root):
        return 0
    return sum(1 for n in os.listdir(root) if n.startswith("step_"))


def quarantine_batch(root: Optional[str], step: int,
                     batch: Optional[Tuple[Sequence, Sequence]],
                     reasons: List[str], loss: Optional[float] = None,
                     z: Optional[float] = None,
                     max_entries: int = 8) -> Optional[str]:
    """Dump ``batch`` (an ``(inputs, labels)`` pair of array/Tensor lists,
    or None for a metadata-only record) under ``root``. Returns the entry
    directory, or None when ``root`` is unset or the cap is reached."""
    if not root:
        return None
    if _entry_count(root) >= max(1, int(max_entries)):
        _monitor.stat_add("sentinel.quarantine_dropped", 1)
        return None
    final = os.path.join(root, f"step_{step}")
    tmp = os.path.join(root, f".tmp_step_{step}")
    if os.path.isdir(final):  # same step re-quarantined (e.g. after rollback)
        return final
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    blobs: Dict[str, np.ndarray] = {}
    spec: Dict[str, Dict] = {}
    if batch is not None:
        xs, ys = batch
        for prefix, vals in (("x", xs or []), ("y", ys or [])):
            for i, v in enumerate(vals):
                arr = _to_host(v)
                blobs[f"{prefix}{i}"] = arr
                spec[f"{prefix}{i}"] = {"shape": list(arr.shape),
                                        "dtype": str(arr.dtype)}
    if blobs:
        np.savez(os.path.join(tmp, "inputs.npz"), **blobs)
    meta = {"step": int(step), "reasons": list(reasons),
            "loss": None if loss is None else float(loss),
            "z": None if z is None else float(z),
            "inputs": spec, "time": time.time()}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, final)
    _monitor.stat_add("sentinel.quarantined", 1)
    return final


def read_quarantine(entry_dir: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Load one quarantine entry back: ``(meta, {name: array})`` — the
    offline-repro half of the contract."""
    with open(os.path.join(entry_dir, "meta.json")) as f:
        meta = json.load(f)
    arrays: Dict[str, np.ndarray] = {}
    npz = os.path.join(entry_dir, "inputs.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
    return meta, arrays
