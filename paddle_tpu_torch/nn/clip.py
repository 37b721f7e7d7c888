"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` clip
a list of gradients (``_clip_raw``, which the optimizers call first in
``step``) or ``[(param, grad)]`` pairs (``__call__``). Norms are taken in
float32 whatever the gradient's type; a parameter with ``need_clip =
False`` keeps its gradient and, for the global norm, does not count.
``clip_grad_norm_`` clips the ``.grad`` of parameters in place.
"""
from __future__ import annotations

import torch


def _clips(p) -> bool:
    return getattr(p, "need_clip", True)


def _sq_norm(g):
    return g.float().pow(2).sum()


class ClipGradBase:
    def __call__(self, params_grads):
        """Functional form over ``[(param, grad)]`` pairs."""
        params = [p for p, _ in params_grads]
        grads = [g for _, g in params_grads]
        return list(zip(params, self._clip_raw(params, grads)))

    def _clip_raw(self, params, grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every entry into ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_raw(self, params, grads):
        return [g.clamp(self.min, self.max) if _clips(p) else g
                for p, g in zip(params, grads)]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient whose own L2 norm exceeds ``clip_norm`` down to
    it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_raw(self, params, grads):
        out = []
        for p, g in zip(params, grads):
            if not _clips(p):
                out.append(g)
                continue
            n = _sq_norm(g).sqrt()
            scale = torch.where(n > self.clip_norm, self.clip_norm / n,
                                torch.ones_like(n))
            out.append(g * scale.to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """One L2 norm over all clipped gradients; all of them scale by
    ``clip_norm / max(global_norm, clip_norm)``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip_raw(self, params, grads):
        sq = [_sq_norm(g) for p, g in zip(params, grads) if _clips(p)]
        if not sq:
            return grads
        global_norm = torch.stack(sq).sum().sqrt()
        scale = self.clip_norm / global_norm.clamp_min(self.clip_norm)
        return [g * scale.to(g.dtype) if _clips(p) else g
                for p, g in zip(params, grads)]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place so their joint
    ``norm_type`` norm is at most ``max_norm`` (factor
    ``min(max_norm / (total + 1e-6), 1)``); returns the norm before
    clipping. ``error_if_nonfinite`` raises on a NaN or infinite norm."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.tensor(0.0)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum().pow(1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"clip_grad_norm_: the total norm {total.item()} "
                           "is not finite")
    scale = (max_norm / (total + 1e-6)).clamp_max(1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return total


class GradientClipByValue(ClipGradByValue):
    pass


class GradientClipByNorm(ClipGradByNorm):
    pass


class GradientClipByGlobalNorm(ClipGradByGlobalNorm):
    pass
