"""Flash attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas_attention.py`` (``flash_attention``
and ``_fa_fwd_with_lse``, which launch the Pallas kernel ``_fa_kernel``).
The kernel is ``csrc/flash_attention_fwd.cu``; its source note says what
bounds it on the H100 and how its design answers that. The wrapper
:func:`flash_attention_fwd` runs the kernel for CUDA tensors and the plain
version :func:`flash_attention_fwd_plain` for CPU tensors (the counterpart
of the JAX package's interpret mode). There is no fallback: a CUDA input
the kernel does not take raises.

Semantics kept from the JAX kernel: inputs ``[B, S, H, D]``; scores
scaled by ``1/sqrt(D)`` unless ``scale`` is given; keys past ``Skv`` never
count; the causal mask is ``q_idx >= k_idx`` aligned top-left, also when
``Sq != Skv``; masked scores are -1e30 and masked probabilities 0, so a
row that sees no key gives 0; the LSE is ``m + log(max(l, 1e-30))`` in
f32. Not kept: the TPU's 16-row block rounding, the padding copies and
the tuner's block sizes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "SUPPORTED_HEAD_DIMS"]

_NEG_INF = -1e30

#: head dims the CUDA kernel is instantiated for
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd_plain(q, k, v, causal: bool = False,
                              scale: Optional[float] = None):
    """The kernel's plain version: the same function written as dense
    tensor operations in f32. Returns ``(out [B, Sq, H, D] in q's type,
    lse [B, H, Sq] f32)``."""
    d = q.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3) * sc                # [B, H, Sq, D]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2))             # [B, H, Sq, Skv]
    sq, skv = s.shape[-2], s.shape[-1]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        mask = qi >= ki
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, vf) / l
    lse = (m + torch.log(l))[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
            f"v {tuple(v.shape)} disagree in B, H or D")
    if not (q.device == k.device == v.device):
        raise ValueError("flash attention: q, k and v must share a device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash attention: q, k and v must share a dtype")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("flash attention: empty sequence")


def _lib():
    from .kernel_build import load
    lib = load("flash_attention_fwd")
    fn = lib.pt_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
    return lib


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention over ``[B, S, H, D]`` inputs; returns ``(out
    [B, Sq, H, D], lse [B, H, Sq] f32)``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32 or bfloat16, D in
    :data:`SUPPORTED_HEAD_DIMS`, last dim contiguous) or raise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernel: dtype {q.dtype} is not "
                        "float32 or bfloat16")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash attention kernel: the last dim must be "
                         "contiguous")
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.pt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, skv, d, strides, float(sc),
            int(bool(causal)), _DTYPES[q.dtype], stream)
    flash_attention_fwd.launches += 1
    from .kernel_build import check
    check(lib, "pt_flash_attention_error_string", code,
          "flash attention kernel")
    return out, lse


#: kernel launches since the count was last set to 0
flash_attention_fwd.launches = 0


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, *, scale=None, name=None):
    """paddle's ``flash_attention`` API: ``(q, k, v, dropout, causal,
    return_softmax)`` over ``[batch, seq, num_heads, head_dim]``, returning
    ``(out, None)``. The probability matrix is never materialised, so
    ``return_softmax=True`` raises, as does ``dropout > 0``."""
    if dropout:
        raise ValueError("flash_attention: dropout inside the fused kernel "
                         "is unsupported (use the dense path for "
                         "attention-prob dropout)")
    if return_softmax:
        raise ValueError("flash_attention: the probability matrix is never "
                         "materialized; return_softmax is unsupported")
    out, _ = flash_attention_fwd(query, key, value, causal=causal,
                                 scale=scale)
    return out, None
