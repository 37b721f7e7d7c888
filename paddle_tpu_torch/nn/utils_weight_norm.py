"""Weight and spectral normalisation (counterpart of
``paddle_tpu/nn/utils_weight_norm.py``): ``weight_norm``,
``remove_weight_norm``, ``spectral_norm_fn`` (``nn.utils.spectral_norm``)
and the functional ``spectral_norm``.

``weight_norm(layer, name, dim)`` replaces the parameter ``name`` by
``name_g`` (its norm over every axis but ``dim``; over all of it for
``dim`` None or -1) and ``name_v`` (its value), and registers a forward
pre-hook (``Layer.register_forward_pre_hook``) that sets
``layer.<name> = v * g / max(||v||, 1e-12)`` before each forward, op
``weight_norm``: device work, captured by a CUDA graph like any other op
(the hook's Python runs at capture only). ``remove_weight_norm`` takes
the hook out and makes ``name`` a parameter again, holding
``v * g / ||v||`` (the JAX package's holds ``v`` alone, which equals it
only while ``g`` is still ``||v||``). ``spectral_norm_fn`` moves the
parameter to ``name_orig`` and sets ``layer.<name>`` to a
``SpectralNorm`` sublayer's (``_spectral_norm``) output before each
forward.

The functional ``spectral_norm(weight, dim, power_iters, eps)`` has no
state: it divides by ``sigma`` from ``max(power_iters, 20)`` power
iterations started at a fixed vector, a Gaussian draw of a
``torch.Generator`` seeded 0 (the JAX package starts at
``jax.random.normal(PRNGKey(0))``; the start's bits differ, and both
land on the top singular value when the iterations converge); op
``spectral_norm``.
"""
from __future__ import annotations

import torch

from ..core.tensor import Parameter
from ..ops.dispatch import apply
from .layers_common import SpectralNorm

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm_fn",
           "spectral_norm"]


def _norm_except_dim(w, dim):
    if dim is None or dim == -1:
        return torch.sqrt(torch.sum(w * w))
    axes = [i for i in range(w.dim()) if i != dim]
    return torch.sqrt(torch.sum(w * w, dim=axes))


def _weight_norm(g, v, dim):
    if dim is None or dim == -1:
        return v * (g / torch.clamp(torch.sqrt(torch.sum(v * v)),
                                    min=1e-12))
    axes = [i for i in range(v.dim()) if i != dim]
    n = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    shape = [1] * v.dim()
    shape[dim] = -1
    return v * (g.reshape(shape) / torch.clamp(n, min=1e-12))


def weight_norm(layer, name="weight", dim=0):
    """Reparametrise ``layer.<name>`` as ``g * v / ||v||`` (module
    docstring); returns ``layer``."""
    w = getattr(layer, name)
    with torch.no_grad():
        g = Parameter(_norm_except_dim(w.detach(), dim))
        v = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, apply(
            "weight_norm", _weight_norm, lyr._parameters[name + "_g"],
            lyr._parameters[name + "_v"], dim=dim))

    hook(layer, ())
    layer._weight_norm_handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_dim = dim
    return layer


def remove_weight_norm(layer, name="weight"):
    """Undo :func:`weight_norm`: ``name`` becomes a parameter holding
    ``g * v / ||v||``; returns ``layer``."""
    handle = getattr(layer, "_weight_norm_handle", None)
    if handle is not None:
        handle.remove()
    g = layer._parameters.pop(name + "_g")
    v = layer._parameters.pop(name + "_v")
    with torch.no_grad():
        w = _weight_norm(g, v, getattr(layer, "_weight_norm_dim", 0))
    layer.add_parameter(name, Parameter(w))
    return layer


def spectral_norm_fn(layer, name="weight", n_power_iterations=1, eps=1e-12,
                     dim=None):
    """``nn.utils.spectral_norm``: ``layer.<name>`` divided by its top
    singular value from a ``SpectralNorm`` sublayer before each forward;
    returns ``layer``."""
    w = getattr(layer, name)
    sn = SpectralNorm(list(w.shape), dim=dim or 0,
                      power_iters=n_power_iterations, eps=eps,
                      device=w.device, dtype=w.dtype)
    layer.add_sublayer("_spectral_norm", sn)
    orig = layer._parameters.pop(name)
    layer.add_parameter(name + "_orig", orig)

    def hook(lyr, inputs):
        object.__setattr__(lyr, name, sn(lyr._parameters[name + "_orig"]))

    layer.register_forward_pre_hook(hook)
    return layer


def _power_sigma(w, dim, iters, eps):
    mat = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    gen = torch.Generator(device=w.device)
    gen.manual_seed(0)
    u = torch.randn(mat.shape[0], generator=gen, device=w.device,
                    dtype=torch.float32).to(w.dtype)
    for _ in range(iters):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return w / (u @ (mat @ v))


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight / sigma_max`` with no state (module docstring)."""
    return apply("spectral_norm", _power_sigma, weight, dim=dim,
                 iters=max(int(power_iters), 20), eps=eps)
