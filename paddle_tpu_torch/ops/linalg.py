"""Linear algebra (counterpart of ``paddle_tpu/ops/linalg.py``, the
``paddle.linalg`` ops), on ``torch.linalg``.

Each op runs through the funnel under the reference's op name
(``inverse``, ``determinant``, ``slogdeterminant``, ``cond_linalg``, ...)
and returns what the JAX package returns: ``slogdet`` stacks
``[sign, logdet]``; ``lu`` gives LAPACK's packed factor and 0-based int32
pivots (``torch.linalg.lu_factor``'s are 1-based); ``lstsq`` is computed
from the SVD as ``jnp.linalg.lstsq`` does, so it gives the solution,
the residuals (empty unless the system is overdetermined and of full
rank), the rank and the singular values on every device (torch's CUDA
driver gives no rank or singular values). Factorisations whose signs or
phases are a convention (``svd``, ``qr``, ``eig``, ``eigh``) follow the
device's LAPACK or cuSOLVER.
"""
from __future__ import annotations

import torch

from .dispatch import apply

__all__ = ["cholesky", "inv", "inverse", "matrix_power", "matrix_rank",
           "det", "slogdet", "svd", "qr", "eig", "eigh", "eigvals",
           "eigvalsh", "solve", "triangular_solve", "cholesky_solve",
           "lstsq", "pinv", "lu", "cond", "multi_dot", "matrix_exp",
           "householder_product"]


def _cholesky(a, upper):
    lo = torch.linalg.cholesky(a)
    return lo.mT.conj() if upper else lo


def cholesky(x, upper=False, name=None):
    return apply("cholesky", _cholesky, x, upper=upper)


def inv(x, name=None):
    return apply("inverse", torch.linalg.inv, x)


inverse = inv


def matrix_power(x, n, name=None):
    return apply("matrix_power", torch.linalg.matrix_power, x, n=n)


def _matrix_rank(a, tol, hermitian):
    if tol is None:
        return torch.linalg.matrix_rank(a, hermitian=hermitian)
    return torch.linalg.matrix_rank(a, atol=tol, rtol=0.0,
                                    hermitian=hermitian)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply("matrix_rank", _matrix_rank, x, tol=tol,
                 hermitian=hermitian)


def det(x, name=None):
    return apply("determinant", torch.linalg.det, x)


def _slogdet(a):
    sign, logdet = torch.linalg.slogdet(a)
    return torch.stack([sign, logdet])


def slogdet(x, name=None):
    return apply("slogdeterminant", _slogdet, x)


def _svd(a, full_matrices):
    return tuple(torch.linalg.svd(a, full_matrices=full_matrices))


def svd(x, full_matrices=False, name=None):
    return apply("svd", _svd, x, full_matrices=full_matrices)


def _qr(a, mode):
    return tuple(torch.linalg.qr(a, mode=mode))


def qr(x, mode="reduced", name=None):
    return apply("qr", _qr, x, mode=mode)


def _eig(a):
    return tuple(torch.linalg.eig(a))


def eig(x, name=None):
    return apply("eig", _eig, x)


def _eigh(a, UPLO):
    return tuple(torch.linalg.eigh(a, UPLO=UPLO))


def eigh(x, UPLO="L", name=None):
    return apply("eigh", _eigh, x, UPLO=UPLO)


def eigvals(x, name=None):
    return apply("eigvals", torch.linalg.eigvals, x)


def eigvalsh(x, UPLO="L", name=None):
    return apply("eigvalsh", torch.linalg.eigvalsh, x, UPLO=UPLO)


def solve(x, y, name=None):
    return apply("solve", torch.linalg.solve, x, y)


def _triangular_solve(a, b, upper, transpose, unitriangular):
    if transpose:
        a, upper = a.mT, not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """The solution ``out`` of ``x @ out = y`` (``x.T @ out = y`` with
    ``transpose``) for a triangular ``x``."""
    return apply("triangular_solve", _triangular_solve, x, y, upper=upper,
                 transpose=transpose, unitriangular=unitriangular)


def _cholesky_solve(b, factor, upper):
    return torch.cholesky_solve(b, factor, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """The solution of ``A @ out = x`` from ``A``'s Cholesky factor
    ``y``."""
    return apply("cholesky_solve", _cholesky_solve, x, y, upper=upper)


def _lstsq(a, b, rcond):
    m, n = a.shape[-2], a.shape[-1]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    mask = s >= rcond * s[..., :1]
    rank = mask.sum(-1)
    vec = b.dim() == a.dim() - 1
    bb = b.unsqueeze(-1) if vec else b
    inv_s = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    sol = vh.mT.conj() @ ((u.mT.conj() @ bb) * inv_s.unsqueeze(-1))
    if m > n and bool((rank == n).all()):
        resid = torch.sum(torch.abs(bb - a @ sol) ** 2, dim=-2)
        if vec:
            resid = resid.squeeze(-1)
    else:
        resid = torch.empty((0,), dtype=s.dtype, device=a.device)
    return (sol.squeeze(-1) if vec else sol, resid, rank, s)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)`` of the least-squares
    problem ``x @ out ≈ y``, from the SVD (module docstring)."""
    return apply("lstsq", _lstsq, x, y, rcond=rcond)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply("pinv", torch.linalg.pinv, x, rtol=rcond,
                 hermitian=hermitian)


def _lu(a):
    factor, piv = torch.linalg.lu_factor(a)
    return factor, (piv - 1).to(torch.int32)


def lu(x, pivot=True, get_infos=False, name=None):
    return apply("lu", _lu, x)


def _cond(a, p):
    if p in (None, 2, -2):
        return torch.linalg.cond(a, p=p)
    # norm(a) * norm(inv(a)), as jnp.linalg.cond (torch's backward
    # through its own inverse fails here)
    return torch.linalg.matrix_norm(a, p) * torch.linalg.matrix_norm(
        torch.linalg.inv(a), p)


def cond(x, p=None, name=None):
    return apply("cond_linalg", _cond, x, p=p)


def multi_dot(x, name=None):
    return apply("multi_dot", torch.linalg.multi_dot, list(x))


def matrix_exp(x, name=None):
    return apply("matrix_exp", torch.linalg.matrix_exp, x)


def householder_product(x, tau, name=None):
    return apply("householder_product", torch.linalg.householder_product,
                 x, tau)
