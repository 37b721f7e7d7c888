"""Device resolution for the port (counterpart of ``paddle_tpu/core/device.py``).

Every entry point of the port takes a ``device`` argument and passes it
through :func:`resolve_device`. With no device given the port runs on
CUDA; where CUDA is absent it raises instead of falling back to the CPU,
so a run that was meant for the card never measures the host by accident.
The CPU is used only when the caller asks for it (``device="cpu"``), as
the tests do.

Resolving a CUDA device also turns TF32 off for matrix products and
cuDNN (``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``): the port's float32 path is
held against the JAX reference in full float32, and TF32 keeps only
about three decimal digits. It turns off the reduced-precision reductions
of bfloat16 and float16 products too
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
and ``allow_fp16_reduced_precision_reduction`` = False): XLA sums
low-precision products in float32, and PyTorch's defaults let cuBLAS add
split-K partial sums in the low type.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` (the current CUDA device) when ``device`` is None; raises
    if CUDA is asked for, explicitly or by default, and is not there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        matmul = torch.backends.cuda.matmul
        matmul.allow_bf16_reduced_precision_reduction = False
        matmul.allow_fp16_reduced_precision_reduction = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev

