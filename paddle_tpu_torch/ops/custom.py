"""Custom ops and the greedy-NMS kernel (counterpart of
``paddle_tpu/ops/custom.py``).

Registration: :func:`register_op` binds ``fn(*tensors, **attrs)`` as
``paddle_tpu_torch.ops.<name>``; torch autograd gives it gradients, as
the JAX package's dispatch funnel does. :func:`register_kernel_op` is
the counterpart of ``register_pallas_op``: it binds a wrapper that
routes by the device of its tensors (kernel on CUDA, plain version on
the CPU), so no interpret flag is passed. ``register_cpp_op`` is not
ported yet (ROADMAP.md queue A11).

:func:`greedy_nms` is the counterpart of ``pallas_greedy_nms`` (which
launches the Pallas kernel ``_nms_kernel``), batched over independent
problems as ``vmap(pallas_greedy_nms)`` is, so one launch covers every
(image, class) problem of a ``multiclass_nms`` call. For each problem,
over score-sorted candidates::

    kept[i] = valid[i] && !any_{j<i}(kept[j] && iou[j, i] > thr)

and, with ``eta < 1`` (``_greedy_nms_mask``'s adaptive threshold, in
``paddle_tpu/ops/detection.py``), ``thr *= eta`` after each kept box
while ``thr > 0.5``. The kernel is ``csrc/greedy_nms.cu``, a
tile-blocked scan (one warp decides 64 candidates at a time from their
overlaps in shared memory while the other warps fold the previous
tile's kept rows into the later candidates' running maxima); its source
note says what bounds it on the H100 and how its design answers that.
CPU tensors take the plain version :func:`greedy_nms_plain`; CUDA
tensors launch the kernel or raise. Not kept from the TPU: the tuner's
``unroll`` factor.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Callable

import torch

from ..core import graphs

__all__ = ["register_op", "register_kernel_op", "greedy_nms",
           "greedy_nms_plain", "MAX_NMS_K"]

#: the largest candidate count the kernel takes (its running maxima, 4
#: bytes per candidate, and valid bits sit in shared memory beside two
#: tiles of 64 x 65 overlaps: 165 KiB at this k, of the 227 KiB a
#: block may have)
MAX_NMS_K = 32768


def register_op(name: str, fn: Callable, module=None):
    """Bind ``fn(*tensors, **attrs)`` as op ``name`` on the ops namespace
    (``paddle_tpu_torch.ops.<name>``); raises if the name is taken."""
    mod = module or sys.modules["paddle_tpu_torch.ops"]
    if hasattr(mod, name):
        raise ValueError(f"op {name!r} already registered")

    def api(*args, **attrs):
        return fn(*args, **attrs)
    api.__name__ = name
    api.__doc__ = fn.__doc__
    setattr(mod, name, api)
    return api


def register_kernel_op(name: str, kernel_call: Callable, module=None):
    """Register an op whose implementation is a kernel wrapper that
    routes by device (kernel on CUDA tensors, plain version on CPU
    tensors). The op checks that its tensor arguments share one device,
    the choice ``register_pallas_op`` made with its interpret flag."""
    def fn(*args, **attrs):
        devices = {a.device for a in args if isinstance(a, torch.Tensor)}
        if len(devices) > 1:
            raise ValueError(f"op {name!r}: tensor arguments on several "
                             f"devices {sorted(map(str, devices))}")
        return kernel_call(*args, **attrs)
    fn.__doc__ = kernel_call.__doc__
    return register_op(name, fn, module=module)


def greedy_nms_plain(iou, valid, thr, eta: float = 1.0):
    """The kernel's plain version: the scan of ``_greedy_nms_mask``, one
    step per candidate, vectorised over the ``P`` problems. It reads
    column ``i`` of each IoU matrix at step ``i``, as the TPU kernel
    does. Returns kept ``[P, k]`` int32."""
    p_n, k = valid.shape
    iou = iou.float()
    ok = valid != 0
    thr = thr.float().clone()
    eta32 = torch.tensor(eta, dtype=torch.float32, device=thr.device)
    kept = torch.zeros((p_n, k), dtype=torch.bool, device=valid.device)
    for i in range(k):
        sup = (kept[:, :i] & (iou[:, :i, i] > thr[:, None])).any(dim=1)
        keep_i = ok[:, i] & ~sup
        if eta < 1.0:
            thr = torch.where(keep_i & (thr > 0.5), thr * eta32, thr)
        kept[:, i] = keep_i
    return kept.to(torch.int32)


def _lib():
    from .kernel_build import load
    lib = load("greedy_nms")
    fn = lib.pt_greedy_nms
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def greedy_nms(iou, valid, thr, eta: float = 1.0):
    """Greedy NMS over score-sorted candidates, for ``P`` independent
    problems at once.

    ``iou``: ``[P, k, k]`` float32 (row ``j``, column ``i`` is the
    overlap of candidate ``j`` with candidate ``i``; need not be
    symmetric); ``valid``: ``[P, k]`` int32 (0 rows are never kept);
    ``thr``: ``[P]`` float32. Returns kept ``[P, k]`` int32 (0 or 1).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous float32/int32, ``k <= MAX_NMS_K``) or raise."""
    if iou.dim() != 3 or valid.dim() != 2 or thr.dim() != 1:
        raise ValueError("greedy_nms takes iou [P, k, k], valid [P, k] and "
                         "thr [P]")
    p_n, k = valid.shape
    if tuple(iou.shape) != (p_n, k, k) or thr.shape[0] != p_n:
        raise ValueError(f"greedy_nms: iou {tuple(iou.shape)}, valid "
                         f"{tuple(valid.shape)} and thr {tuple(thr.shape)} "
                         f"do not agree")
    if len({iou.device, valid.device, thr.device}) != 1:
        raise ValueError("greedy_nms: all inputs must share a device")
    if iou.device.type == "cpu":
        return greedy_nms_plain(iou, valid, thr, eta)
    if iou.device.type != "cuda":
        raise ValueError(f"greedy_nms: unsupported device {iou.device}")
    if iou.dtype != torch.float32 or thr.dtype != torch.float32 \
            or valid.dtype != torch.int32:
        raise TypeError("greedy_nms kernel: iou and thr must be float32 "
                        "and valid int32")
    if not (iou.is_contiguous() and valid.is_contiguous()
            and thr.is_contiguous()):
        raise ValueError("greedy_nms kernel: inputs must be contiguous")
    if k > MAX_NMS_K:
        raise ValueError(f"greedy_nms kernel: k={k} exceeds {MAX_NMS_K}")
    kept = torch.empty((p_n, k), dtype=torch.int32, device=iou.device)
    if p_n == 0 or k == 0:
        return kept
    lib = _lib()
    with torch.cuda.device(iou.device):
        stream = torch.cuda.current_stream(iou.device).cuda_stream
        code = lib.pt_greedy_nms(iou.data_ptr(), valid.data_ptr(),
                                 thr.data_ptr(), kept.data_ptr(), p_n, k,
                                 float(eta), stream)
    greedy_nms.launches += 1
    from .kernel_build import check
    check(lib, "pt_greedy_nms_error_string", code, "greedy NMS kernel")
    return kept


#: kernel launches since the count was last set to 0
greedy_nms.launches = 0
graphs.counted(greedy_nms)
