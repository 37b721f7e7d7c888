"""Flash attention, forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions and the differentiable ``flash_attention``.

Counterpart of ``paddle_tpu/ops/pallas_attention.py``: ``flash_attention``,
``_fa_fwd_with_lse`` (which launches the Pallas kernel ``_fa_kernel``),
``_fa_bwd_with_lse`` (which launches ``_fa_bwd_dq_kernel`` and
``_fa_bwd_dkv_kernel``) and the ``_fa_core`` custom VJP that joins them.
The kernels are ``csrc/flash_attention_fwd.cu`` (B1),
``csrc/flash_attention_bwd_dq.cu`` (B2) and
``csrc/flash_attention_bwd_dkv.cu`` (B3), all three on the tensor cores
through ``csrc/flash_mma.cuh`` (fp32 as 3xTF32, bf16 and fp16 native);
each source note says what bounds it on the H100 and how its design
answers that. Each wrapper
(:func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq`,
:func:`flash_attention_bwd_dkv`) runs its kernel for CUDA tensors and its
plain version for CPU tensors (the counterpart of the JAX package's
interpret mode), and counts its launches. There is no fallback: a CUDA
input a kernel does not take raises.

:func:`flash_attention` goes through :class:`FlashAttentionFunction` on
every device: its forward is :func:`flash_attention_fwd`, it saves q, k, v,
O and the LSE, and its backward is :func:`flash_attention_bwd` (B2, then
B3), so the CPU tests run the same backward formulas the kernels
implement. :func:`flash_attention_fwd` stays the raw, non-differentiable
forward.

Semantics kept from the JAX kernels: inputs ``[B, S, H, D]``; scores
scaled by ``1/sqrt(D)`` unless ``scale`` is given; keys past ``Skv`` never
count; the causal mask is ``q_idx >= k_idx`` aligned top-left, also when
``Sq != Skv``; masked scores are -1e30 and masked probabilities 0, so a
row that sees no key gives 0; the LSE is ``m + log(max(l, 1e-30))`` in
f32; the backward recomputes ``P = exp(S*scale - lse)`` and takes
``delta = rowsum(dO*O)`` in f32 from the stored (rounded) O unless it is
given; ``grad_dtypes`` sets the gradients' types (default: the inputs').
Not kept: the TPU's 16-row block rounding, the padding copies and the
tuner's block sizes. Under AMP :func:`flash_attention` is op
``flash_attention``, on no list: O2 casts its inputs to the low type, O1
leaves them as they come (low from the low projections).

float16 gradients overflow as the hardware rounds them: a dS past
float16's range becomes inf as an MMA operand and reaches the gradient,
never clamped, so a loss scaler sees it and skips the step.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import amp
from ..core import graphs

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dkv_plain", "attention_delta",
           "FlashAttentionFunction", "SUPPORTED_HEAD_DIMS"]

_NEG_INF = -1e30

#: head dims the CUDA kernels are instantiated for
SUPPORTED_HEAD_DIMS = (32, 64, 128)
#: the C entry points' type codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _acc(x) -> torch.dtype:
    """The plain versions' accumulation type: f32, as the kernels, or f64
    for f64 inputs (``torch.autograd.gradcheck``)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _causal_mask(sq, skv, device):
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(skv, device=device)[None, :]
    return qi >= ki


def flash_attention_fwd_plain(q, k, v, causal: bool = False,
                              scale: Optional[float] = None):
    """B1's plain version: the same function written as dense tensor
    operations in f32. Returns ``(out [B, Sq, H, D] in q's type,
    lse [B, H, Sq] f32)``."""
    sc, acc = _scale(q, scale), _acc(q)
    qf = q.to(acc).permute(0, 2, 1, 3) * sc                # [B, H, Sq, D]
    kf = k.to(acc).permute(0, 2, 1, 3)
    vf = v.to(acc).permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2))             # [B, H, Sq, Skv]
    sq, skv = s.shape[-2], s.shape[-1]
    if causal:
        mask = _causal_mask(sq, skv, q.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, vf) / l
    lse = (m + torch.log(l))[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def attention_delta(out, dout):
    """``delta = rowsum(dO * O)`` in f32, ``[B, H, Sq]`` (the softmax
    Jacobian's correction term, from the stored O as the JAX package
    computes it outside any kernel)."""
    acc = _acc(out)
    return (dout.to(acc) * out.to(acc)).sum(-1).transpose(1, 2).contiguous()


def _bwd_terms(q, k, v, dout, lse, delta, causal, scale):
    """The dense backward from the saved LSE, in f32 and ``[B, H, S, D]``:
    ``(scale*Q, K, dO, P, dS)`` with P = exp(S*scale - lse) masked to
    exactly 0 and dS = P * (dO V^T - delta)."""
    sc, acc = _scale(q, scale), _acc(q)
    qs = q.to(acc).permute(0, 2, 1, 3) * sc
    kf = k.to(acc).permute(0, 2, 1, 3)
    vf = v.to(acc).permute(0, 2, 1, 3)
    dof = dout.to(acc).permute(0, 2, 1, 3)
    s = torch.matmul(qs, kf.transpose(-1, -2))
    p = torch.exp(s - lse.to(acc)[..., None])
    if causal:
        mask = _causal_mask(s.shape[-2], s.shape[-1], q.device)
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.to(acc)[..., None])
    return qs, kf, dof, p, ds


def _bhsd_to_bshd(x, dtype):
    return x.permute(0, 2, 1, 3).to(dtype)


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                 causal: bool = False,
                                 scale: Optional[float] = None, dtype=None):
    """B2's plain version: ``dQ = scale * dS K``, ``[B, Sq, H, D]`` in
    ``dtype`` (default q's)."""
    _, kf, _, _, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.matmul(ds, kf) * _scale(q, scale)
    return _bhsd_to_bshd(dq, dtype or q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                  causal: bool = False,
                                  scale: Optional[float] = None,
                                  dk_dtype=None, dv_dtype=None):
    """B3's plain version: ``dK = dS^T (scale Q)`` and ``dV = P^T dO``,
    each ``[B, Skv, H, D]`` (default types k's and v's)."""
    qs, _, dof, p, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, scale)
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return (_bhsd_to_bshd(dk, dk_dtype or k.dtype),
            _bhsd_to_bshd(dv, dv_dtype or v.dtype))


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = False,
                              scale: Optional[float] = None, delta=None,
                              grad_dtypes: Optional[Sequence] = None):
    """The whole backward's plain version, B2's and B3's in turn:
    ``(dq, dk, dv)`` in ``[B, S, H, D]``."""
    if delta is None:
        delta = attention_delta(out, dout)
    dq_dt, dk_dt, dv_dt = grad_dtypes or (q.dtype, k.dtype, v.dtype)
    args = (q, k, v, dout, lse, delta, causal, scale)
    return (flash_attention_bwd_dq_plain(*args, dq_dt),
            *flash_attention_bwd_dkv_plain(*args, dk_dt, dv_dt))


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


def _check_bwd(q, k, v, dout, lse, delta):
    _check(q, k, v)
    b, sq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError(
            f"flash attention backward: dout {tuple(dout.shape)} "
            f"{dout.dtype} must match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, sq) or t.dtype != _acc(q) \
                or t.device != q.device:
            raise ValueError(
                f"flash attention backward: {name} must be [B, H, Sq] = "
                f"{(b, h, sq)} {_acc(q)} on {q.device}, got "
                f"{tuple(t.shape)} {t.dtype}")


def _on_kernel(what, q, *tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA
    tensors the kernel takes; raises for anything else."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel: dtype {q.dtype} is not float32, "
                        "bfloat16 or float16")
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{what} kernel: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    for t in (q, *tensors):
        if t.dim() == 4 and t.stride(-1) != 1:
            raise ValueError(f"{what} kernel: the last dim must be "
                             "contiguous")
        if t.dim() == 3 and not t.is_contiguous():
            raise ValueError(f"{what} kernel: lse and delta must be "
                             "contiguous")
    return True


def _check_aligned(what, *tensors):
    """The kernels copy rows of D elements into shared memory 16 bytes at
    a time: every base pointer, and every (b, s, h) stride of
    a dimension longer than 1, must be a multiple of 16 bytes. Raise
    otherwise; there is no scalar path to fall back on."""
    for t in tensors:
        es = t.element_size()
        strides = [st * es for st, n in zip(t.stride()[:3], t.shape[:3])
                   if n > 1]
        if t.data_ptr() % 16 or any(st % 16 for st in strides):
            raise ValueError(
                f"{what} kernel: every base pointer and (b, s, h) stride "
                f"must be 16-byte aligned, got pointer offset "
                f"{t.data_ptr() % 16} and strides {tuple(t.stride()[:3])} "
                f"of {es}-byte elements")


def _out_code(dtype, what):
    if dtype not in _DTYPES:
        raise TypeError(f"{what} kernel: gradient dtype {dtype} is not "
                        "float32, bfloat16 or float16")
    return _DTYPES[dtype]


def _entry(lib_name: str, fn_name: str, n_ptr: int, n_tail_int: int):
    """The C entry ``fn_name`` of ``csrc/<lib_name>.cu`` with its argtypes
    set: ``n_ptr`` pointers, B, H, Sq, Skv, D, the strides array, scale,
    causal and ``n_tail_int`` dtype codes, then the stream."""
    from .kernel_build import load
    lib = load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_int] * n_tail_int + [ctypes.c_void_p])
    return lib, fn


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _run(lib, err_fn, what, q, call):
    """Launch on q's device and current stream; raise if the launch was
    refused (a refused launch never runs, and a later synchronize would
    not report it)."""
    from .kernel_build import check
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = call(stream)
    check(lib, err_fn, code, what)


def _count(wrapper, dtype):
    """One launch of ``wrapper``'s kernel on inputs of ``dtype``."""
    wrapper.launches += 1
    name = str(dtype).replace("torch.", "")
    wrapper.launches_by_dtype[name] = \
        wrapper.launches_by_dtype.get(name, 0) + 1


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: exact attention over ``[B, S, H, D]`` inputs; returns ``(out
    [B, Sq, H, D], lse [B, H, Sq] f32)``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32 as 3xTF32, bfloat16 or
    float16 on the tensor cores; D in :data:`SUPPORTED_HEAD_DIMS`; last
    dim contiguous; base pointers and strides 16-byte aligned) or raise.
    Not differentiable on either device: :func:`flash_attention` is."""
    _check(q, k, v)
    if not _on_kernel("flash attention", q, k, v):
        with torch.no_grad():
            return flash_attention_fwd_plain(q, k, v, causal, scale)
    _check_aligned("flash attention", q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, out)
    lib, fn = _entry("flash_attention_fwd", "pt_flash_attention_fwd", 5, 1)
    _count(flash_attention_fwd, q.dtype)
    _run(lib, "pt_flash_attention_error_string", "flash attention kernel", q,
         lambda stream: fn(
             q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, h, sq, skv, d, strides, float(_scale(q, scale)),
             int(bool(causal)), _DTYPES[q.dtype], stream))
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = False,
                           scale: Optional[float] = None, dtype=None
                           ) -> torch.Tensor:
    """B2: ``dQ [B, Sq, H, D]`` (in ``dtype``, default q's) from the
    forward's inputs, the output gradient ``dout``, the saved ``lse`` and
    ``delta`` (both ``[B, H, Sq]`` f32). CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32 as 3xTF32, bfloat16 or
    float16 on the tensor cores; D in :data:`SUPPORTED_HEAD_DIMS`; last dim
    contiguous; base pointers and strides 16-byte aligned) or raise."""
    _check_bwd(q, k, v, dout, lse, delta)
    dt = dtype or q.dtype
    if not _on_kernel("flash attention dq", q, k, v, dout, lse, delta):
        with torch.no_grad():
            return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta,
                                                causal, scale, dt)
    _check_aligned("flash attention dq", q, k, v, dout)
    b, sq, h, d = q.shape
    dq = torch.empty((b, sq, h, d), dtype=dt, device=q.device)
    code = _out_code(dt, "flash attention dq")
    strides = _strides(q, k, v, dout, dq)
    lib, fn = _entry("flash_attention_bwd_dq", "pt_flash_attention_bwd_dq",
                     7, 2)
    _count(flash_attention_bwd_dq, q.dtype)
    _run(lib, "pt_flash_attention_bwd_dq_error_string",
         "flash attention dq kernel", q,
         lambda stream: fn(
             q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq,
             k.shape[1], d, strides, float(_scale(q, scale)),
             int(bool(causal)), _DTYPES[q.dtype], code, stream))
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = False,
                            scale: Optional[float] = None, dk_dtype=None,
                            dv_dtype=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: ``(dK, dV)``, each ``[B, Skv, H, D]`` (default types k's and
    v's), from the same inputs as :func:`flash_attention_bwd_dq`. CPU
    tensors take the plain version; CUDA tensors launch the kernel (on
    the same terms as :func:`flash_attention_bwd_dq`) or raise."""
    _check_bwd(q, k, v, dout, lse, delta)
    dk_dt, dv_dt = dk_dtype or k.dtype, dv_dtype or v.dtype
    if not _on_kernel("flash attention dkv", q, k, v, dout, lse, delta):
        with torch.no_grad():
            return flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                                 causal, scale, dk_dt, dv_dt)
    _check_aligned("flash attention dkv", q, k, v, dout)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dk = torch.empty((b, skv, h, d), dtype=dk_dt, device=q.device)
    dv = torch.empty((b, skv, h, d), dtype=dv_dt, device=q.device)
    codes = (_out_code(dk_dt, "flash attention dkv"),
             _out_code(dv_dt, "flash attention dkv"))
    strides = _strides(q, k, v, dout, dk, dv)
    lib, fn = _entry("flash_attention_bwd_dkv", "pt_flash_attention_bwd_dkv",
                     8, 3)
    _count(flash_attention_bwd_dkv, q.dtype)
    _run(lib, "pt_flash_attention_bwd_dkv_error_string",
         "flash attention dkv kernel", q,
         lambda stream: fn(
             q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, h, sq, skv, d, strides, float(_scale(q, scale)),
             int(bool(causal)), _DTYPES[q.dtype], *codes, stream))
    return dk, dv


#: kernel launches since each count was last set to 0, in all and by the
#: inputs' type ("float32", "bfloat16", "float16")
for _w in (flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv):
    _w.launches = 0
    _w.launches_by_dtype = {}
    graphs.counted(_w)
del _w


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = False,
                        scale: Optional[float] = None, delta=None,
                        grad_dtypes: Optional[Sequence] = None, *,
                        needs_input_grad=(True, True, True)):
    """The backward of flash attention: ``(dq, dk, dv)`` from the saved
    ``out`` and ``lse`` of :func:`flash_attention_fwd` and the output
    gradient ``dout``. ``delta`` (``[B, H, Sq]`` f32) is computed from
    ``out`` unless given; ``grad_dtypes`` is ``(dq, dk, dv)`` types
    (default the inputs'). On CUDA tensors it launches B2 for dq, then B3
    for dk and dv, skipping a kernel whose gradients
    ``needs_input_grad`` does not ask for (those come back None); CPU
    tensors take the plain version."""
    if delta is None:
        delta = attention_delta(out, dout)
    dq_dt, dk_dt, dv_dt = grad_dtypes or (q.dtype, k.dtype, v.dtype)
    need_q, need_k, need_v = needs_input_grad
    if q.device.type == "cpu":
        _check_bwd(q, k, v, dout, lse, delta)
        dq, dk, dv = flash_attention_bwd_plain(
            q, k, v, out, lse, dout, causal, scale, delta,
            (dq_dt, dk_dt, dv_dt))
    else:
        dq = dk = dv = None
        if need_q:
            dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal,
                                        scale, dq_dt)
        if need_k or need_v:
            dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                             causal, scale, dk_dt, dv_dt)
    return (dq if need_q else None, dk if need_k else None,
            dv if need_v else None)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (the counterpart of the JAX
    package's ``_fa_core`` custom VJP): forward B1, backward B2 then B3.
    ``apply(q, k, v, causal, scale)`` returns ``out``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:       # e.g. an expanded gradient
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, ctx.causal, ctx.scale,
            needs_input_grad=tuple(ctx.needs_input_grad[:3]))
        return dq, dk, dv, None, None


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, *, scale=None, name=None):
    """paddle's ``flash_attention`` API: ``(q, k, v, dropout, causal,
    return_softmax)`` over ``[batch, seq, num_heads, head_dim]``, returning
    ``(out, None)``; differentiable (:class:`FlashAttentionFunction`). The
    probability matrix is never materialised, so ``return_softmax=True``
    raises, as does ``dropout > 0``."""
    if dropout:
        raise ValueError("flash_attention: dropout inside the fused kernel "
                         "is unsupported (use the dense path for "
                         "attention-prob dropout)")
    if return_softmax:
        raise ValueError("flash_attention: the probability matrix is never "
                         "materialized; return_softmax is unsupported")
    query, key, value = amp.cast_inputs("flash_attention", query, key, value)
    return FlashAttentionFunction.apply(query, key, value, causal, scale), None
