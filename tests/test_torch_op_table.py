"""The op table of the port's op surface, and the op-built GPT.

Every ported op of ``ops/{creation,manipulation,math,linalg}.py``,
``nn/functional/{activation,common,norm,loss}.py`` and, of the
structured half, ``ops/{segment,sequence,beam,crf,extras}.py`` and
``nn/functional/sampled.py`` (all but the random ops, which
``test_torch_ops_extras.py`` and ``test_torch_functional_sampled.py``
hold by their draws) is a case
(:class:`OpCase`) in ``OP_CASES``. A case's op takes the package (``m``,
the JAX package or the port) and its input Tensors, made from seeded
NumPy arrays, so the same case runs through either. The CPU tests
(``tests/test_torch_ops_*.py``, ``test_torch_functional_*.py``) hold
each case's port result against the JAX package's; ``test_torch_cuda.py``
and ``chip_smoke.py``'s phase 22 hold the cases of ``CUDA_CASES`` on the
card against the CPU (:func:`cuda_case_holds`). Tie cases stay on the
CPU: CUDA's order for equal keys in sort and topk is not defined.

:func:`random_ops_hold` holds the random ops by seed and moments, and
:func:`op_built_gpt` is a GPT written as a paddle user writes one, from
the op surface alone (``test_torch_op_program.py`` and phase 22).

This module imports neither jax nor the JAX package: ``chip_smoke.py``
imports it on a machine without them.
"""
import contextlib
import zlib

import numpy as np



def _F(*shape, lo=None, hi=None):
    """Seeded float32 inputs: standard normal, or uniform in [lo, hi)."""
    def make(rng):
        if lo is None:
            return rng.standard_normal(shape).astype(np.float32)
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return make


def _I(lo, hi, *shape):
    def make(rng):
        return rng.integers(lo, hi, shape).astype(np.int64)
    return make


def _B(*shape):
    def make(rng):
        return rng.random(shape) < 0.5
    return make


def _A(value, dtype=np.float32):
    def make(rng):
        return np.asarray(value, dtype)
    return make


def _perm(n, *lead):
    """Rows of distinct indices in [0, n)."""
    def make(rng):
        k = lead[-1] if lead else n
        rows = int(np.prod(lead[:-1])) if len(lead) > 1 else 1
        out = np.stack([rng.permutation(n)[:k] for _ in range(rows)])
        return out.reshape(lead if lead else (n,)).astype(np.int64)
    return make


def _spd(n):
    def make(rng):
        a = rng.standard_normal((n, n))
        return (a @ a.T + n * np.eye(n)).astype(np.float32)
    return make


def _tri(n, upper):
    def make(rng):
        a = rng.standard_normal((n, n)) + 3 * np.eye(n)
        return (np.triu(a) if upper else np.tril(a)).astype(np.float32)
    return make


class OpCase:
    """One op call: ``op(m, *tensors)`` on the inputs ``makers`` give from
    a generator seeded by the case's name. ``grad`` (default: any float
    input) checks the gradient of a seeded cotangent; ``tol`` is the
    forward's (integer and index outputs are held bitwise), ``gtol`` the
    gradient's; ``tie`` keeps the case off the card (CUDA's order for
    equal keys is not defined); ``cuda=False`` keeps it off the card for
    the reason in ``why``; ``ref=False`` keeps it off the JAX comparison
    for the reason in ``why``; ``host=True`` marks an op that reads its
    input on the host, which the card runs eagerly only
    (``HOST_CASES``), never inside a capture."""

    def __init__(self, name, op, makers, module, grad=None, tol=1e-5,
                 gtol=1e-4, tie=False, cuda=True, ref=True, why="",
                 cuda_tol=None, host=False):
        self.name, self.op, self.makers, self.module = name, op, makers, \
            module
        self.tol, self.gtol, self.tie, self.host = tol, gtol, tie, host
        self.cuda = cuda and not tie and not host
        self.ref, self.why = ref, why
        self.cuda_tol = cuda_tol if cuda_tol is not None else max(tol, 1e-5)
        self.grad = grad

    def arrays(self):
        rng = np.random.default_rng(zlib.crc32(self.name.encode()))
        return [mk(rng) for mk in self.makers]

    def __repr__(self):
        return self.name


def run_case(m, case, place=None, around_op=contextlib.nullcontext):
    """``(outputs, grads)`` of ``case`` through package ``m`` as NumPy
    arrays (outputs in order; ``grads`` per float input, None where no
    gradient reached it, or None when the case takes no gradient). The
    op's call runs inside ``around_op()``."""
    arrays = case.arrays()
    floats = [a.dtype.kind == "f" for a in arrays]
    grad = any(floats) if case.grad is None else case.grad
    kw = {} if place is None else {"place": place}
    ts = [m.to_tensor(a, stop_gradient=not (grad and f), **kw)
          for a, f in zip(arrays, floats)]
    with around_op():
        out = case.op(m, *ts)
    leaves = _leaves(out)
    outs = [_np_of(v) for v in leaves]
    if not grad:
        return outs, None
    rng = np.random.default_rng(zlib.crc32(("cot" + case.name).encode()))
    loss = None
    for v in leaves:
        if hasattr(v, "stop_gradient") and not v.stop_gradient and \
                np.dtype(_np_of(v).dtype).kind == "f":
            cot = m.to_tensor(rng.standard_normal(v.shape).astype(
                np.float32), **kw)
            term = (v * cot).sum()
            loss = term if loss is None else loss + term
    if loss is None:
        return outs, [None] * sum(floats)
    loss.backward()
    grads = [None if t.grad is None else _np_of(t.grad)
             for t, f in zip(ts, floats) if f]
    return outs, grads


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _np_of(v):
    """NumPy of a Tensor, a Parameter or a torch tensor on any device."""
    if v is None:
        return None
    import torch
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def assert_case_close(case, got, ref, what, tol=None, gtol=None):
    """``got`` (the port) against ``ref``: shapes equal, float outputs
    within ``tol`` of the largest entry, the rest bitwise; gradients
    within ``gtol`` (a missing one counts as zeros)."""
    tol = case.tol if tol is None else tol
    gtol = case.gtol if gtol is None else gtol
    (outs, grads), (routs, rgrads) = got, ref
    assert len(outs) == len(routs), (case, what, len(outs), len(routs))
    for i, (a, b) in enumerate(zip(outs, routs)):
        assert a.shape == b.shape, (case, what, i, a.shape, b.shape)
        if a.dtype.kind in "fc" or b.dtype.kind in "fc":
            np.testing.assert_allclose(
                a.astype(np.complex128 if a.dtype.kind == "c"
                         else np.float64),
                b.astype(np.complex128 if b.dtype.kind == "c"
                         else np.float64),
                rtol=tol, atol=tol * max(1.0, float(np.nanmax(np.abs(b)))
                                         if b.size else 1.0),
                equal_nan=True, err_msg=f"{case} {what} output {i}")
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype),
                                          err_msg=f"{case} {what} {i}")
    if grads is None or rgrads is None:
        assert grads is None and rgrads is None, (case, what)
        return
    for i, (a, b) in enumerate(zip(grads, rgrads)):
        if a is None and b is None:
            continue
        a = np.zeros_like(b) if a is None else a
        b = np.zeros_like(a) if b is None else b
        np.testing.assert_allclose(
            a, b, rtol=gtol, atol=gtol * max(1.0, float(np.abs(b).max())
                                             if b.size else 1.0),
            err_msg=f"{case} {what} gradient {i}")


def _f(m):
    return m.nn.functional


def _math_cases():
    C, F, I, B = OpCase, _F, _I, _B
    mod = "math"
    pos, unit = dict(lo=0.2, hi=3.0), dict(lo=-0.9, hi=0.9)
    cases = []
    unary = {"abs": F(3, 4), "exp": F(3, 4), "expm1": F(3, 4),
             "log": F(3, 4, **pos), "log2": F(3, 4, **pos),
             "log10": F(3, 4, **pos), "log1p": F(3, 4, **pos),
             "sqrt": F(3, 4, **pos), "rsqrt": F(3, 4, **pos),
             "square": F(3, 4), "sin": F(3, 4), "cos": F(3, 4),
             "tan": F(3, 4, lo=-1.2, hi=1.2), "asin": F(3, 4, **unit),
             "acos": F(3, 4, **unit), "atan": F(3, 4), "sinh": F(3, 4),
             "cosh": F(3, 4), "tanh": F(3, 4), "asinh": F(3, 4),
             "acosh": F(3, 4, lo=1.2, hi=4.0), "atanh": F(3, 4, **unit),
             "floor": F(3, 4), "ceil": F(3, 4), "round": F(3, 4),
             "trunc": F(3, 4), "sign": F(3, 4),
             "reciprocal": F(3, 4, **pos), "erf": F(3, 4),
             "erfinv": F(3, 4, **unit), "lgamma": F(3, 4, **pos),
             "digamma": F(3, 4, lo=0.5, hi=3.0), "sigmoid": F(3, 4),
             "logsigmoid": F(3, 4), "neg": F(3, 4), "conj": F(3, 4),
             "angle": F(3, 4), "real": F(3, 4), "imag": F(3, 4),
             "isnan": _A([1.0, np.nan, np.inf]),
             "isinf": _A([1.0, np.nan, -np.inf]),
             "isfinite": _A([1.0, np.nan, np.inf]),
             "logical_not": B(3, 4), "bitwise_not": I(-5, 5, 3, 4),
             "frac": F(3, 4)}
    for n, mk in unary.items():
        cases.append(C(n, lambda m, x, n=n: getattr(m, n)(x), [mk], mod,
                       grad=None if n not in ("isnan", "isinf", "isfinite")
                       else False, tol=1e-5 if n != "erfinv" else 2e-5))
    binary = {"add": (F(3, 4), F(4)), "subtract": (F(3, 4), F(3, 1)),
              "multiply": (F(3, 4), F(3, 4)),
              "divide": (F(3, 4), F(3, 4, **pos)),
              "floor_divide": (F(3, 4), F(3, 4, **pos)),
              "mod": (F(3, 4), F(3, 4, **pos)),
              "remainder": (F(3, 4), F(3, 4, **pos)),
              "floor_mod": (F(3, 4), F(3, 4, **pos)),
              "pow_t": (F(3, 4, **pos), F(3, 4)),
              "maximum": (F(3, 4), F(3, 4)), "minimum": (F(3, 4), F(3, 4)),
              "fmax": (F(3, 4), F(3, 4)), "fmin": (F(3, 4), F(3, 4)),
              "atan2": (F(3, 4), F(3, 4)), "hypot": (F(3, 4), F(3, 4)),
              "logical_and": (B(3, 4), B(3, 4)),
              "logical_or": (B(3, 4), B(3, 4)),
              "logical_xor": (B(3, 4), B(3, 4)),
              "bitwise_and": (I(0, 16, 3, 4), I(0, 16, 3, 4)),
              "bitwise_or": (I(0, 16, 3, 4), I(0, 16, 3, 4)),
              "bitwise_xor": (I(0, 16, 3, 4), I(0, 16, 3, 4)),
              "equal": (I(0, 3, 3, 4), I(0, 3, 3, 4)),
              "not_equal": (I(0, 3, 3, 4), I(0, 3, 3, 4)),
              "greater_than": (F(3, 4), F(3, 4)),
              "greater_equal": (I(0, 3, 3, 4), I(0, 3, 3, 4)),
              "less_than": (F(3, 4), F(3, 4)),
              "less_equal": (I(0, 3, 3, 4), I(0, 3, 3, 4)),
              "nextafter": (F(3, 4), F(3, 4)),
              "copysign": (F(3, 4), F(3, 4)),
              "heaviside": (_A([-1.0, 0.0, 2.0, 0.0]), F(4)),
              "gcd": (I(1, 40, 3, 4), I(1, 40, 3, 4)),
              "lcm": (I(1, 12, 3, 4), I(1, 12, 3, 4)),
              "logaddexp": (F(3, 4), F(3, 4))}
    for n, mks in binary.items():
        cases.append(C(n, lambda m, x, y, n=n: getattr(m, n)(x, y),
                       list(mks), mod,
                       grad=False if n == "nextafter" else None))
    cases += [
        C("maximum_ties", lambda m, x, y: m.maximum(x, y),
          [_A([1.0, 2.0, 3.0]), _A([1.0, 5.0, 3.0])], mod, tie=True),
        C("minimum_ties", lambda m, x, y: m.minimum(x, y),
          [_A([1.0, 2.0, 3.0]), _A([1.0, 5.0, 3.0])], mod, tie=True),
        C("add_scalar_rhs", lambda m, x: m.add(x, 2), [F(3)], mod),
        C("subtract_scalar_lhs", lambda m, x: 2.5 - x, [F(3)], mod),
        C("pow", lambda m, x: m.pow(x, 3.0), [F(3, 4)], mod),
        C("pow_tensor", lambda m, x, y: m.pow(x, y),
          [F(3, **pos), F(3)], mod),
        C("rpow", lambda m, x: 2.0 ** x, [F(3)], mod),
        C("scale", lambda m, x: m.scale(x, 2.0, 0.5, False), [F(3, 4)],
          mod),
        C("scale_act", lambda m, x: m.scale(x, 1.5, act="tanh"),
          [F(3, 4)], mod),
        C("clip", lambda m, x: m.clip(x, -0.5, 0.5), [F(3, 4)], mod),
        C("clip_tensor_bounds", lambda m, x, lo, hi: m.clip(x, lo, hi),
          [F(3, 4), _A(-0.3), _A(0.4)], mod),
        C("lerp", lambda m, x, y: m.lerp(x, y, 0.3), [F(3, 4), F(3, 4)],
          mod),
        C("lerp_tensor_weight", lambda m, x, y, w: m.lerp(x, y, w),
          [F(3, 4), F(3, 4), F(3, 4, lo=0.0, hi=1.0)], mod),
        C("stanh", lambda m, x: m.stanh(x, 0.5, 2.0), [F(3, 4)], mod),
        C("matmul", lambda m, x, y: m.matmul(x, y), [F(3, 4), F(4, 5)],
          mod),
        C("matmul_transposes", lambda m, x, y: m.matmul(
            x, y, transpose_x=True, transpose_y=True),
          [F(2, 4, 3), F(2, 5, 4)], mod),
        C("matmul_vector", lambda m, x, y: m.matmul(x, y), [F(3, 4), F(4)],
          mod),
        C("mm", lambda m, x, y: m.mm(x, y), [F(3, 4), F(4, 2)], mod),
        C("bmm", lambda m, x, y: m.bmm(x, y), [F(2, 3, 4), F(2, 4, 2)],
          mod),
        C("mv", lambda m, x, y: m.mv(x, y), [F(3, 4), F(4)], mod),
        C("dot", lambda m, x, y: m.dot(x, y), [F(3, 4), F(3, 4)], mod),
        C("addmm", lambda m, i, x, y: m.addmm(i, x, y, 0.5, 2.0),
          [F(3, 2), F(3, 4), F(4, 2)], mod),
        C("outer", lambda m, x, y: m.outer(x, y), [F(3), F(4)], mod),
        C("inner", lambda m, x, y: m.inner(x, y), [F(2, 4), F(3, 4)], mod),
        C("kron", lambda m, x, y: m.kron(x, y), [F(2, 2), F(2, 3)], mod),
        C("cross_default_axis", lambda m, x, y: m.cross(x, y),
          [F(4, 3), F(4, 3)], mod),
        C("cross_axis0", lambda m, x, y: m.cross(x, y, axis=0),
          [F(3, 5), F(3, 5)], mod),
        C("multiplex", lambda m, a, b, i: m.multiplex([a, b], i),
          [F(4, 3), F(4, 3), I(0, 2, 4, 1)], mod),
    ]
    # reductions
    for n in ("sum", "mean", "prod", "max", "min", "amax", "amin",
              "logsumexp", "nansum", "nanmean"):
        for tag, kw in (("all", {}), ("axis1", {"axis": 1}),
                        ("axes_keep", {"axis": [0, 2], "keepdim": True})):
            cases.append(C(f"{n}_{tag}", lambda m, x, n=n, kw=kw: getattr(
                m, n)(x, **kw), [F(2, 3, 4)], mod))
    cases += [
        C("sum_int_dtype", lambda m, x: m.sum(x, dtype="int32"),
          [I(0, 5, 3, 4)], mod),
        C("prod_dtype", lambda m, x: m.prod(x, 1, dtype="float64"),
          [F(3, 4)], mod),
        C("max_ties", lambda m, x: m.max(x, axis=1),
          [_A([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0]])], mod, tie=True),
        C("amin_ties_all", lambda m, x: m.amin(x),
          [_A([[1.0, 3.0, 1.0], [2.0, 1.0, 4.0]])], mod, tie=True),
        C("all", lambda m, x: m.all(x, axis=1), [B(3, 4)], mod),
        C("any", lambda m, x: m.any(x), [B(3, 4)], mod),
        C("any_keep", lambda m, x: m.any(x, axis=[0, 1], keepdim=True),
          [B(2, 3, 2)], mod),
        C("std", lambda m, x: m.std(x, axis=1), [F(3, 5)], mod),
        C("std_biased_all", lambda m, x: m.std(x, unbiased=False),
          [F(3, 5)], mod),
        C("var", lambda m, x: m.var(x, axis=[0, 1], keepdim=True),
          [F(3, 4, 2)], mod),
        C("median_even", lambda m, x: m.median(x, axis=1), [F(3, 6)], mod),
        C("median_odd_all", lambda m, x: m.median(x), [F(3, 5)], mod),
        C("median_keep", lambda m, x: m.median(x, axis=0, keepdim=True),
          [F(4, 3)], mod),
        C("median_ties", lambda m, x: m.median(x, axis=1),
          [_A([[1.0, 2.0, 2.0, 5.0], [3.0, 3.0, 3.0, 1.0]])], mod,
          tie=True),
        C("nanmedian", lambda m, x: m.nanmedian(x, axis=1),
          [_A([[1.0, np.nan, 2.0, 5.0], [3.0, 0.5, np.nan, np.nan]])],
          mod, grad=False),
        C("nansum_nan", lambda m, x: m.nansum(x, axis=1),
          [_A([[1.0, np.nan, 2.0], [np.nan, 0.5, 3.0]])], mod, grad=False),
        C("nanmean_nan", lambda m, x: m.nanmean(x),
          [_A([[1.0, np.nan, 2.0], [np.nan, 0.5, 3.0]])], mod, grad=False),
        C("quantile", lambda m, x: m.quantile(x, 0.3, axis=1), [F(3, 7)],
          mod),
        C("quantile_list", lambda m, x: m.quantile(x, [0.1, 0.5, 0.9]),
          [F(4, 5)], mod),
        C("cumsum", lambda m, x: m.cumsum(x, axis=1), [F(3, 4)], mod),
        C("cumsum_flat", lambda m, x: m.cumsum(x), [F(3, 4)], mod),
        C("cumprod", lambda m, x: m.cumprod(x, dim=1),
          [F(3, 4, lo=0.5, hi=1.5)], mod),
        C("cummax", lambda m, x: m.cummax(x, axis=1), [F(3, 6)], mod),
        C("cummax_ties_forward", lambda m, x: m.cummax(x),
          [_A([1.0, 3.0, 3.0, 2.0, 4.0])], mod, grad=False, tie=True),
        C("count_nonzero", lambda m, x: m.count_nonzero(x, axis=1),
          [I(0, 3, 3, 5)], mod),
        C("count_nonzero_keep", lambda m, x: m.count_nonzero(
            x, axis=[0], keepdim=True), [I(0, 2, 3, 5)], mod),
    ]
    # search and sort, indexing, the norms and the tail: module "search"
    mod = "search"
    ties = _A([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0], [0.0, 0.0, 5.0, 5.0, 1.0,
                                                   0.0]])
    cases += [
        C("argmax", lambda m, x: m.argmax(x), [F(3, 4)], mod),
        C("argmax_axis_keep", lambda m, x: m.argmax(x, 1, keepdim=True),
          [F(3, 4)], mod),
        C("argmin_axis", lambda m, x: m.argmin(x, axis=0), [F(3, 4)], mod),
        C("argmax_ties", lambda m, x: m.argmax(x, axis=1), [ties], mod,
          tie=True),
        C("argsort", lambda m, x: m.argsort(x), [F(3, 5)], mod),
        C("argsort_desc_axis0", lambda m, x: m.argsort(x, 0, True),
          [F(4, 3)], mod),
        C("argsort_ties", lambda m, x: m.argsort(x), [ties], mod, tie=True),
        C("argsort_desc_ties", lambda m, x: m.argsort(x, descending=True),
          [ties], mod, tie=True),
        C("sort", lambda m, x: m.sort(x, axis=0), [F(4, 3)], mod),
        C("sort_desc", lambda m, x: m.sort(x, descending=True), [F(3, 5)],
          mod),
        C("sort_desc_ties", lambda m, x: m.sort(x, descending=True), [ties],
          mod, tie=True),
        C("topk", lambda m, x: m.topk(x, 2), [F(3, 5)], mod),
        C("topk_smallest_axis0", lambda m, x: m.topk(x, 2, axis=0,
                                                      largest=False),
          [F(4, 3)], mod),
        C("topk_ties", lambda m, x: m.topk(x, 3), [ties], mod, tie=True),
        C("topk_smallest_ties", lambda m, x: m.topk(x, 3, largest=False),
          [ties], mod, tie=True),
        C("kthvalue", lambda m, x: m.kthvalue(x, 2), [F(3, 5)], mod),
        C("kthvalue_keep_axis0", lambda m, x: m.kthvalue(x, 3, 0, True),
          [F(4, 3)], mod),
        C("kthvalue_ties", lambda m, x: m.kthvalue(x, 2), [ties], mod,
          tie=True),
        C("mode", lambda m, x: m.mode(x), [I(0, 3, 4, 7)], mod),
        C("mode_ties_float", lambda m, x: m.mode(x), [ties], mod,
          tie=True),
        C("mode_axis0_keep", lambda m, x: m.mode(x, 0, True),
          [I(0, 4, 7, 3)], mod),
        C("where", lambda m, c, x, y: m.where(c, x, y),
          [B(3, 4), F(3, 4), F(3, 4)], mod),
        C("where_scalar", lambda m, c, x: m.where(c, x, 0.0),
          [B(3, 4), F(3, 4)], mod),
        C("where_cond_only", lambda m, c: m.where(c), [B(3, 4)], mod),
        C("nonzero", lambda m, x: m.nonzero(x), [I(0, 2, 3, 4)], mod),
        C("nonzero_tuple", lambda m, x: m.nonzero(x, as_tuple=True),
          [I(0, 2, 3, 4)], mod),
        C("where_index", lambda m, x: m.where_index(x), [B(2, 3)], mod),
        C("masked_select", lambda m, x, k: m.masked_select(x, k),
          [F(3, 4), B(3, 4)], mod, grad=False,
          why="the JAX package selects on the host, outside autograd"),
        C("masked_fill", lambda m, x, k: m.masked_fill(x, k, -1.5),
          [F(3, 4), B(3, 4)], mod),
        C("masked_fill_tensor", lambda m, x, k, v: m.masked_fill(x, k, v),
          [F(3, 4), B(4), _A(2.0)], mod),
        C("index_select", lambda m, x, i: m.index_select(x, i, axis=1),
          [F(3, 5), I(0, 5, 4)], mod),
        C("index_sample", lambda m, x, i: m.index_sample(x, i),
          [F(3, 5), I(0, 5, 3, 2)], mod),
        C("take_along_axis", lambda m, x, i: m.take_along_axis(x, i, 1),
          [F(3, 5), I(0, 5, 3, 4)], mod),
        C("take_along_axis_bcast", lambda m, x, i: m.take_along_axis(
            x, i, 0), [F(4, 3), I(0, 4, 2, 1)], mod),
        C("put_along_axis", lambda m, x, i, v: m.put_along_axis(x, i, v, 1),
          [F(3, 5), _perm(5, 3, 2), F(3, 2)], mod),
        C("put_along_axis_scalar", lambda m, x, i: m.put_along_axis(
            x, i, 9.0, 1), [F(3, 5), _perm(5, 3, 2)], mod),
        C("put_along_axis_add", lambda m, x, i, v: m.put_along_axis(
            x, i, v, 1, reduce="add"),
          [F(3, 5), _A([[0, 0], [1, 4], [2, 2]], np.int64), F(3, 2)], mod),
        C("put_along_axis_mul", lambda m, x, i, v: m.put_along_axis(
            x, i, v, 0, reduce="mul"),
          [F(3, 4), _A([[0, 1, 2, 0], [2, 0, 1, 1]], np.int64), F(2, 4)],
          mod, grad=False),
        C("gather", lambda m, x, i: m.gather(x, i), [F(5, 3), I(0, 5, 4)],
          mod),
        C("gather_2d_index_axis1", lambda m, x, i: m.gather(x, i, axis=1),
          [F(3, 5), I(0, 5, 2, 2)], mod),
        C("gather_nd", lambda m, x, i: m.gather_nd(x, i),
          [F(3, 4, 2), I(0, 3, 5, 2)], mod),
        C("scatter", lambda m, x, i, u: m.scatter(x, i, u),
          [F(5, 3), _perm(5, 3), F(3, 3)], mod),
        C("scatter_accumulate_dups", lambda m, x, i, u: m.scatter(
            x, i, u, overwrite=False),
          [F(5, 3), _A([1, 3, 1, 0], np.int64), F(4, 3)], mod),
        C("scatter_nd_add", lambda m, x, i, u: m.scatter_nd_add(x, i, u),
          [F(4, 3), _A([[1], [2], [1]], np.int64), F(3, 3)], mod),
        C("scatter_nd", lambda m, i, u: m.scatter_nd(i, u, [4, 3]),
          [_A([[0, 1], [2, 2], [0, 1]], np.int64), F(3)], mod),
        C("bincount", lambda m, x: m.bincount(x, minlength=7),
          [I(0, 5, 20)], mod),
        C("bincount_weights", lambda m, x, w: m.bincount(x, w),
          [I(0, 5, 20), F(20)], mod, grad=False),
        C("histogram", lambda m, x: m.histogram(x, 6, -2, 2), [F(40)],
          mod),
        C("histogram_data_range", lambda m, x: m.histogram(x, 5), [F(30)],
          mod),
        C("unique", lambda m, x: m.unique(x), [I(0, 6, 12)], mod),
        C("unique_all", lambda m, x: m.unique(
            x, return_index=True, return_inverse=True, return_counts=True),
          [I(0, 6, 3, 5)], mod),
        C("unique_axis0", lambda m, x: m.unique(
            x, return_inverse=True, return_counts=True, axis=0),
          [_A([[1, 2], [0, 1], [1, 2], [0, 0]], np.int64)], mod),
        C("unique_consecutive", lambda m, x: m.unique_consecutive(
            x, return_inverse=True, return_counts=True),
          [_A([1, 1, 2, 2, 2, 3, 1, 1], np.int64)], mod),
        C("unique_consecutive_axis0", lambda m, x: m.unique_consecutive(
            x, return_counts=True, axis=0),
          [_A([[1, 2], [1, 2], [0, 1], [1, 2]], np.int64)], mod),
        C("allclose", lambda m, x, y: m.allclose(x, y + 1e-7),
          [F(3, 4), F(3, 4)], mod, grad=False),
        C("isclose", lambda m, x, y: m.isclose(x, y, rtol=0.5),
          [F(3, 4), F(3, 4)], mod, grad=False),
        C("equal_all", lambda m, x, y: m.equal_all(x, y),
          [I(0, 2, 3), I(0, 2, 3)], mod),
        C("equal_all_shapes", lambda m, x, y: m.equal_all(x, y),
          [I(0, 2, 3), I(0, 2, 4)], mod),
        C("is_empty", lambda m, x: m.is_empty(x), [F(0, 3)], mod),
        C("searchsorted", lambda m, s, v: m.searchsorted(s, v),
          [_A([-1.0, 0.0, 0.5, 2.0]), F(7)], mod, grad=False),
        C("searchsorted_right_int32", lambda m, s, v: m.searchsorted(
            s, v, out_int32=True, right=True),
          [_A([1, 2, 2, 4], np.int64), I(0, 6, 6)], mod),
        C("bucketize", lambda m, x, s: m.bucketize(x, s, right=True),
          [I(0, 6, 6), _A([1, 2, 2, 4], np.int64)], mod),
        C("digitize", lambda m, x, s: m.digitize(x, s),
          [F(6), _A([-1.0, 0.0, 1.0])], mod, grad=False),
    ]
    # norms and the tail
    for tag, kw in (("fro", {}), ("fro_axis", {"axis": 1}),
                    ("p1", {"p": 1, "axis": 0}),
                    ("inf", {"p": np.inf, "axis": 1}),
                    ("neg_inf", {"p": -np.inf, "axis": 1}),
                    ("p0", {"p": 0, "axis": 1}),
                    ("p3_keep", {"p": 3, "axis": [0, 1], "keepdim": True})):
        cases.append(C(f"norm_{tag}", lambda m, x, kw=kw: m.norm(x, **kw),
                       [F(3, 4)], mod))
    for p in (2, 1, 0, np.inf, -np.inf, 3):
        cases.append(C(f"dist_p{p}", lambda m, x, y, p=p: m.dist(x, y, p),
                       [F(3, 4), F(3, 4)], mod))
    cases += [
        C("clip_by_norm", lambda m, x: m.clip_by_norm(x, 1.0), [F(3, 4)],
          mod),
        C("squared_l2_norm", lambda m, x: m.squared_l2_norm(x), [F(3, 4)],
          mod),
        C("trace", lambda m, x: m.trace(x, 1), [F(4, 5)], mod),
        C("trace_axes", lambda m, x: m.trace(x, 0, 1, 2), [F(2, 3, 3)],
          mod),
        C("nan_to_num", lambda m, x: m.nan_to_num(x, 0.5, 9.0, -9.0),
          [_A([1.0, np.nan, np.inf, -np.inf])], mod),
        C("nan_to_num_default", lambda m, x: m.nan_to_num(x),
          [_A([1.0, np.nan, 2.0])], mod),
        C("increment", lambda m, x: m.increment(x * 1.0, 2.0), [F(3)],
          mod),
        C("logit", lambda m, x: m.logit(x), [F(3, 4, lo=0.1, hi=0.9)], mod),
        C("logit_eps", lambda m, x: m.logit(x, 0.2), [F(3, 4, lo=0, hi=1)],
          mod),
        C("rad2deg", lambda m, x: m.rad2deg(x), [F(3)], mod),
        C("deg2rad", lambda m, x: m.deg2rad(x), [F(3)], mod),
        C("ldexp", lambda m, x, y: m.ldexp(x, y), [F(3), I(-3, 4, 3)],
          mod),
        C("diff", lambda m, x: m.diff(x), [F(3, 5)], mod),
        C("diff_n2_axis0", lambda m, x: m.diff(x, 2, axis=0), [F(5, 3)],
          mod),
        C("diff_prepend_append", lambda m, x, a, b: m.diff(
            x, prepend=a, append=b), [F(2, 4), F(2, 1), F(2, 2)], mod),
        C("cummin", lambda m, x: m.cummin(x, axis=1), [F(3, 6)], mod),
        C("cummin_flat", lambda m, x: m.cummin(x), [F(2, 3)], mod),
        C("cummin_ties", lambda m, x: m.cummin(x),
          [_A([3.0, 1.0, 1.0, 2.0, 1.0, 0.5])], mod, tie=True),
        C("logcumsumexp", lambda m, x: m.logcumsumexp(x, axis=1),
          [F(3, 5)], mod),
        C("logcumsumexp_flat", lambda m, x: m.logcumsumexp(x), [F(2, 3)],
          mod),
        C("vander", lambda m, x: m.vander(x), [F(4)], mod),
        C("vander_increasing_n", lambda m, x: m.vander(x, 3, True), [F(4)],
          mod),
        C("cov", lambda m, x: m.cov(x), [F(3, 6)], mod),
        C("cov_cols_biased", lambda m, x: m.cov(x, rowvar=False,
                                                 ddof=False), [F(6, 3)],
          mod),
        C("cov_weights", lambda m, x, f, a: m.cov(x, fweights=f,
                                                   aweights=a),
          [F(3, 5), I(1, 4, 5), F(5, lo=0.5, hi=2.0)], mod),
        C("corrcoef", lambda m, x: m.corrcoef(x), [F(3, 6)], mod),
        C("corrcoef_cols", lambda m, x: m.corrcoef(x, rowvar=False),
          [F(6, 3)], mod),
        C("take", lambda m, x, i: m.take(x, i), [F(3, 4), I(-12, 12, 5)],
          mod),
        C("take_wrap", lambda m, x, i: m.take(x, i, mode="wrap"),
          [F(3, 4), I(-30, 30, 2, 3)], mod),
        C("take_clip", lambda m, x, i: m.take(x, i, mode="clip"),
          [F(3, 4), I(-30, 30, 6)], mod),
        C("index_add", lambda m, x, i, v: m.index_add(x, i, 1, v),
          [F(3, 5), _A([0, 2, 2], np.int64), F(3, 3)], mod),
        C("index_put", lambda m, x, i, j, v: m.index_put(x, (i, j), v),
          [F(3, 4), _A([0, 2], np.int64), _A([1, 3], np.int64), F(2)],
          mod),
        C("index_put_accumulate", lambda m, x, i, v: m.index_put(
            x, (i,), v, accumulate=True),
          [F(4, 3), _A([1, 1, 3], np.int64), F(3, 3)], mod),
        C("index_fill", lambda m, x, i: m.index_fill(x, i, 1, -2.0),
          [F(3, 4), _A([0, 3], np.int64)], mod),
        C("renorm", lambda m, x: m.renorm(x, 2, 0, 1.0), [F(3, 4)], mod),
        C("cos_sim", lambda m, x, y: m.cos_sim(x, y), [F(3, 4), F(3, 4)],
          mod),
        C("cos_sim_broadcast", lambda m, x, y: m.cos_sim(x, y),
          [F(3, 2, 2), F(1, 4)], mod),
        C("l1_norm", lambda m, x: m.l1_norm(x), [F(3, 4)], mod),
        C("frobenius_norm", lambda m, x: m.frobenius_norm(x, [0, 1]),
          [F(3, 4, 2)], mod),
        C("frobenius_norm_keep", lambda m, x: m.frobenius_norm(
            x, keepdim=True), [F(3, 4)], mod),
        C("unflatten", lambda m, x: m.unflatten(x, 1, [2, 3]), [F(4, 6)],
          mod),
        C("soft_relu", lambda m, x: m.ops.soft_relu(x, 2.0), [F(3, 4)],
          mod),
    ]
    return cases


def _manipulation_cases():
    C, F, I = OpCase, _F, _I
    mod = "manipulation"
    return [
        C("reshape", lambda m, x: m.reshape(x, [4, -1]), [F(2, 3, 4)], mod),
        C("reshape_tensor_shape", lambda m, x, s: m.reshape(x, s),
          [F(2, 6), _A([3, 4], np.int64)], mod),
        C("reshape_", lambda m, x: m.reshape_(x * 1.0, [6]), [F(2, 3)],
          mod),
        C("transpose", lambda m, x: m.transpose(x, [2, 0, 1]),
          [F(2, 3, 4)], mod),
        C("t", lambda m, x: m.t(x), [F(3, 4)], mod),
        C("t_vector", lambda m, x: m.t(x), [F(3)], mod),
        C("moveaxis", lambda m, x: m.moveaxis(x, 0, 2), [F(2, 3, 4)], mod),
        C("swapaxes", lambda m, x: m.swapaxes(x, 0, 2), [F(2, 3, 4)], mod),
        C("concat", lambda m, x, y: m.concat([x, y], axis=1),
          [F(2, 3), F(2, 2)], mod),
        C("concat_neg_axis", lambda m, x, y: m.concat([x, y], axis=-2),
          [F(2, 3), F(1, 3)], mod),
        C("stack", lambda m, x, y: m.stack([x, y], axis=1),
          [F(2, 3), F(2, 3)], mod),
        C("hstack", lambda m, x, y: m.hstack([x, y]), [F(2, 3), F(2, 1)],
          mod),
        C("vstack", lambda m, x, y: m.vstack([x, y]), [F(3), F(2, 3)],
          mod),
        C("split", lambda m, x: m.split(x, 3, axis=1), [F(2, 6)], mod),
        C("split_sections_minus1", lambda m, x: m.split(x, [2, -1, 1]),
          [F(6, 2)], mod),
        C("split_tensor_sections", lambda m, x, s: m.split(x, [s, 4],
                                                            axis=1),
          [F(2, 6), _A(2, np.int64)], mod),
        C("chunk", lambda m, x: m.chunk(x, 2, axis=0), [F(4, 3)], mod),
        C("unstack", lambda m, x: m.unstack(x, axis=1), [F(2, 3)], mod),
        C("unbind", lambda m, x: m.unbind(x), [F(3, 2)], mod),
        C("squeeze", lambda m, x: m.squeeze(x), [F(1, 3, 1, 2)], mod),
        C("squeeze_axis", lambda m, x: m.squeeze(x, [0, 1]),
          [F(1, 3, 1, 2)], mod),
        C("squeeze_", lambda m, x: m.squeeze_(x * 1.0, -2),
          [F(1, 3, 1, 2)], mod),
        C("unsqueeze", lambda m, x: m.unsqueeze(x, [0, 2]), [F(3, 2)], mod),
        C("unsqueeze_neg", lambda m, x: m.unsqueeze(x, -1), [F(3, 2)], mod),
        C("unsqueeze_", lambda m, x: m.unsqueeze_(x * 1.0, 1), [F(3, 2)],
          mod),
        C("flatten", lambda m, x: m.flatten(x, 1, 2), [F(2, 3, 4, 2)], mod),
        C("tile", lambda m, x: m.tile(x, [2, 1, 3]), [F(2, 3)], mod),
        C("expand", lambda m, x: m.expand(x, [2, -1, 3]), [F(4, 1)], mod),
        C("expand_as", lambda m, x, y: m.expand_as(x, y),
          [F(1, 3), F(4, 3)], mod),
        C("broadcast_to", lambda m, x: m.broadcast_to(x, [2, 3, 4]),
          [F(3, 1)], mod),
        C("broadcast_tensors", lambda m, x, y: m.broadcast_tensors([x, y]),
          [F(3, 1), F(1, 4)], mod),
        C("flip", lambda m, x: m.flip(x, [0, 2]), [F(2, 3, 4)], mod),
        C("flip_int_axis", lambda m, x: m.flip(x, 1), [F(2, 3)], mod),
        C("rot90", lambda m, x: m.rot90(x), [F(3, 4)], mod),
        C("rot90_k3_axes", lambda m, x: m.rot90(x, 3, (1, 2)),
          [F(2, 3, 4)], mod),
        C("roll", lambda m, x: m.roll(x, 2), [F(3, 4)], mod),
        C("roll_axes", lambda m, x: m.roll(x, [1, -1], [0, 1]), [F(3, 4)],
          mod),
        C("slice", lambda m, x: m.slice(x, [0, 1], [1, -3], [3, 4]),
          [F(4, 5)], mod),
        C("strided_slice", lambda m, x: m.strided_slice(
            x, [1], [0], [5], [2]), [F(3, 6)], mod),
        C("strided_slice_negative", lambda m, x: m.strided_slice(
            x, [0, 1], [3, 5], [0, -7], [-2, -2]), [F(4, 6)], mod),
        C("crop", lambda m, x: m.crop(x, [2, -1], [1, 1]), [F(4, 5)], mod),
        C("pad_constant_nchw", lambda m, x: m.pad(x, [1, 2, 0, 1],
                                                  value=0.5),
          [F(1, 2, 3, 4)], mod),
        C("pad_reflect", lambda m, x: m.pad(x, [2, 1, 1, 2],
                                            mode="reflect"),
          [F(1, 2, 4, 5)], mod),
        C("pad_replicate_nhwc", lambda m, x: m.pad(
            x, [1, 2, 2, 0], mode="replicate", data_format="NHWC"),
          [F(1, 3, 4, 2)], mod),
        C("pad_circular", lambda m, x: m.pad(x, [1, 2], mode="circular"),
          [F(1, 2, 4)], mod),
        C("pad_all_dims", lambda m, x: m.pad(x, [1, 0, 0, 2]), [F(2, 3)],
          mod),
        C("repeat_interleave", lambda m, x: m.repeat_interleave(x, 2, 1),
          [F(2, 3)], mod),
        C("repeat_interleave_flat", lambda m, x: m.repeat_interleave(x, 3),
          [F(2, 2)], mod),
        C("repeat_interleave_tensor", lambda m, x, r: m.repeat_interleave(
            x, r, 0), [F(3, 2), _A([1, 0, 2], np.int64)], mod, ref=False,
          why="the JAX package's Tensor-repeats lane reads the repeats "
              "inside its jit and raises; held against np.repeat"),
        C("pixel_shuffle", lambda m, x: m.pixel_shuffle(x, 2),
          [F(1, 8, 2, 3)], mod),
        C("pixel_shuffle_nhwc", lambda m, x: m.pixel_shuffle(x, 2, "NHWC"),
          [F(1, 2, 3, 8)], mod),
        C("pixel_unshuffle", lambda m, x: m.pixel_unshuffle(x, 2),
          [F(1, 2, 4, 6)], mod),
        C("shuffle_channel", lambda m, x: m.shuffle_channel(x, 2),
          [F(1, 6, 2, 2)], mod),
        C("space_to_depth", lambda m, x: m.space_to_depth(x, 2),
          [F(1, 2, 4, 6)], mod),
        C("unfold", lambda m, x: m.unfold(x, 2), [F(1, 2, 4, 5)], mod),
        C("unfold_strided_padded", lambda m, x: m.unfold(
            x, [3, 2], strides=2, paddings=1, dilations=[1, 2]),
          [F(2, 2, 5, 6)], mod),
        C("shard_index", lambda m, i: m.shard_index(i, 20, 3, 1),
          [I(0, 20, 8)], mod),
        C("cast", lambda m, x: m.cast(x, "float64"), [F(3, 4)], mod),
        C("cast_int", lambda m, x: m.cast(x, "int32"), [F(3, 4)], mod),
        C("as_complex", lambda m, x: m.as_complex(x), [F(3, 2)], mod,
          grad=False),
        C("as_real", lambda m, x: m.as_real(m.as_complex(x)), [F(3, 2)],
          mod, grad=False),
        C("tensordot", lambda m, x, y: m.tensordot(x, y, 1),
          [F(2, 3), F(3, 4)], mod),
        C("tensordot_axes", lambda m, x, y: m.tensordot(
            x, y, [[0, 2], [1, 0]]), [F(2, 3, 4), F(4, 2, 5)], mod),
        C("einsum", lambda m, x, y: m.einsum("bij,bjk->bik", x, y),
          [F(2, 3, 4), F(2, 4, 2)], mod),
        C("einsum_trace", lambda m, x: m.einsum("ii", x), [F(3, 3)], mod),
        C("getitem_setitem", lambda m, x: (x[1:, ::2], x.T), [F(3, 4)],
          mod),
    ]


def _creation_cases():
    C, F, I = OpCase, _F, _I
    mod = "creation"
    return [
        C("linspace", lambda m: m.linspace(-1.0, 2.0, 7), [], mod),
        C("linspace_dtype", lambda m: m.linspace(0, 1, 5, "float64"), [],
          mod),
        C("eye", lambda m: m.eye(3, 4), [], mod),
        C("eye_int", lambda m: m.eye(3, dtype="int32"), [], mod),
        C("diag_vector", lambda m, x: m.diag(x, 1), [F(3)], mod),
        C("diag_padding", lambda m, x: m.diag(x, -1, 2.0), [F(3)], mod),
        C("diag_matrix", lambda m, x: m.diag(x, 1), [F(3, 4)], mod),
        C("diagflat", lambda m, x: m.diagflat(x, -1), [F(2, 2)], mod),
        C("diag_embed", lambda m, x: m.diag_embed(x), [F(2, 3)], mod),
        C("diag_embed_dims", lambda m, x: m.diag_embed(x, 1, 0, 2),
          [F(2, 3)], mod),
        C("meshgrid", lambda m, x, y: m.meshgrid(x, y), [F(3), F(4)], mod),
        C("meshgrid_list", lambda m, x, y: m.meshgrid([x, y]),
          [F(2), F(3)], mod),
        C("tril", lambda m, x: m.tril(x, -1), [F(4, 4)], mod),
        C("triu", lambda m, x: m.triu(x, 1), [F(3, 4)], mod),
        C("assign", lambda m, x: m.assign(x), [F(3, 4)], mod),
        C("assign_host", lambda m: m.assign(np.arange(6).reshape(2, 3)),
          [], mod),
        C("clone", lambda m, x: m.clone(x), [F(3)], mod),
        C("numel", lambda m, x: m.numel(x), [F(3, 4)], mod),
        C("one_hot", lambda m, i: m.one_hot(i, 5), [I(-1, 6, 4, 2)], mod),
        C("full_like_zeros_like", lambda m, x: (
            m.full_like(x, 2.5), m.zeros_like(x), m.ones_like(x, "int32")),
          [F(2, 3)], mod),
        C("full_zeros_ones_arange", lambda m: (
            m.full([2, 3], 1.5), m.zeros([2], "int32"), m.ones([3]),
            m.arange(1, 7, 2), m.arange(0.0, 1.0, 0.25)), [], mod),
    ]


def _linalg_cases():
    C, F = OpCase, _F
    mod = "linalg"
    return [
        C("cholesky", lambda m, x: m.linalg.cholesky(x), [_spd(4)], mod),
        C("cholesky_upper", lambda m, x: m.linalg.cholesky(x, upper=True),
          [_spd(3)], mod),
        C("inv", lambda m, x: m.linalg.inv(x), [_spd(4)], mod),
        C("inverse_top_level", lambda m, x: m.inverse(x), [_spd(3)], mod),
        C("matrix_power", lambda m, x: m.linalg.matrix_power(x, 3),
          [F(3, 3)], mod),
        C("matrix_power_neg", lambda m, x: m.matrix_power(x, -2),
          [_spd(3)], mod),
        C("matrix_rank", lambda m, x: m.linalg.matrix_rank(x),
          [_A([[1.0, 2.0], [2.0, 4.0]])], mod),
        C("det", lambda m, x: m.linalg.det(x), [F(3, 3)], mod),
        C("det_batched", lambda m, x: m.linalg.det(x), [F(2, 3, 3)], mod),
        C("slogdet", lambda m, x: m.linalg.slogdet(x), [F(3, 3)], mod),
        C("svd_values", lambda m, x: m.linalg.svd(x)[1], [F(4, 3)], mod),
        C("svd_reconstruction", lambda m, x: _svd_rebuilt(m, x),
          [F(3, 5)], mod),
        C("qr", lambda m, x: m.linalg.qr(x), [F(4, 3)], mod, tol=1e-4,
          gtol=1e-3, cuda=False,
          why="the signs of Q's columns are the solver's convention; "
              "qr_reconstruction holds qr on the card"),
        C("qr_reconstruction", lambda m, x: m.matmul(*m.linalg.qr(x)),
          [F(4, 4)], mod),
        C("eig_values", lambda m, x: _sorted_eigvals(m, m.linalg.eig(x)[0]),
          [_spd(3)], mod, grad=False),
        C("eigvals", lambda m, x: _sorted_eigvals(m, m.linalg.eigvals(x)),
          [_spd(4)], mod, grad=False),
        C("eigh", lambda m, x: (m.linalg.eigh(x)[0],
                                m.abs(m.linalg.eigh(x)[1])), [_spd(3)],
          mod, tol=1e-4, grad=False),
        C("eigh_values_grad", lambda m, x: m.linalg.eigh(x)[0], [_spd(3)],
          mod, gtol=1e-3),
        C("eigvalsh_upper", lambda m, x: m.linalg.eigvalsh(x, "U"),
          [_spd(4)], mod),
        C("solve", lambda m, a, b: m.linalg.solve(a, b),
          [_spd(3), F(3, 2)], mod),
        C("triangular_solve", lambda m, a, b: m.linalg.triangular_solve(
            a, b), [_tri(3, True), F(3, 2)], mod),
        C("triangular_solve_lower_t_unit", lambda m, a, b:
          m.linalg.triangular_solve(a, b, upper=False, transpose=True,
                                    unitriangular=True),
          [_tri(3, False), F(3, 2)], mod),
        C("cholesky_solve", lambda m, b, a: m.linalg.cholesky_solve(
            b, m.linalg.cholesky(a)), [F(3, 2), _spd(3)], mod),
        C("lstsq_over", lambda m, a, b: m.linalg.lstsq(a, b),
          [F(5, 3), F(5, 2)], mod, tol=1e-4, gtol=1e-3),
        C("lstsq_under", lambda m, a, b: m.linalg.lstsq(a, b)[0],
          [F(2, 4), F(2, 1)], mod, tol=1e-4, gtol=1e-3),
        C("pinv", lambda m, x: m.linalg.pinv(x), [F(4, 3)], mod, tol=1e-4,
          gtol=1e-3),
        C("lu", lambda m, x: m.linalg.lu(x), [F(4, 4)], mod, tol=1e-4,
          grad=False),
        C("cond", lambda m, x: m.linalg.cond(x), [_spd(3)], mod, tol=1e-4,
          grad=False),
        C("cond_fro", lambda m, x: m.linalg.cond(x, "fro"), [_spd(3)], mod,
          tol=1e-4, gtol=1e-3),
        C("multi_dot", lambda m, x, y, z: m.linalg.multi_dot([x, y, z]),
          [F(2, 3), F(3, 4), F(4, 2)], mod),
        C("matrix_exp", lambda m, x: m.linalg.matrix_exp(x * 0.3),
          [F(3, 3)], mod, tol=1e-4, gtol=1e-3),
        C("householder_product", lambda m, x, t:
          m.linalg.householder_product(x, t),
          [F(4, 3), F(3, lo=0.5, hi=1.5)], mod, tol=1e-4, gtol=1e-3),
    ]


def _svd_rebuilt(m, x):
    u, s, vh = m.linalg.svd(x)
    return m.matmul(u * s.unsqueeze(0), vh)


def _sorted_eigvals(m, w):
    return m.sort(m.real(w))


def _activation_cases():
    C, F = OpCase, _F
    mod = "activation"
    plain = ["relu", "relu6", "gelu", "sigmoid", "tanh", "softmax",
             "log_softmax", "leaky_relu", "elu", "selu", "celu", "silu",
             "swish", "mish", "hardswish", "hardsigmoid", "hardtanh",
             "hardshrink", "softshrink", "tanhshrink", "softplus",
             "softsign", "thresholded_relu", "log_sigmoid", "glu"]
    cases = [C(f"F.{n}", lambda m, x, n=n: getattr(_f(m), n)(x * 3.0),
               [F(3, 4)], mod) for n in plain]
    cases += [
        C("F.relu_", lambda m, x: _f(m).relu_(x * 1.0), [F(3, 4)], mod),
        C("F.gelu_tanh", lambda m, x: _f(m).gelu(x, approximate=True),
          [F(3, 4)], mod),
        C("F.softmax_axis0_dtype", lambda m, x: _f(m).softmax(
            x, 0, "float64"), [F(3, 4)], mod),
        C("F.log_softmax_axis0", lambda m, x: _f(m).log_softmax(x, 0),
          [F(3, 4)], mod),
        C("F.leaky_relu_slope", lambda m, x: _f(m).leaky_relu(x, 0.2),
          [F(3, 4)], mod),
        C("F.elu_alpha", lambda m, x: _f(m).elu(x, 0.5), [F(3, 4)], mod),
        C("F.celu_alpha", lambda m, x: _f(m).celu(x, 0.5), [F(3, 4)], mod),
        C("F.hardtanh_bounds", lambda m, x: _f(m).hardtanh(x, -0.5, 2.0),
          [F(3, 4)], mod),
        C("F.softplus_beta", lambda m, x: _f(m).softplus(x * 5.0, 2.0,
                                                          3.0),
          [F(3, 4)], mod),
        C("F.prelu_scalar", lambda m, x, w: _f(m).prelu(x, w),
          [F(2, 3, 4), _A([0.25])], mod),
        C("F.prelu_channels", lambda m, x, w: _f(m).prelu(x, w),
          [F(2, 3, 4), F(3)], mod),
        C("F.prelu_nhwc", lambda m, x, w: _f(m).prelu(x, w, "NHWC"),
          [F(2, 4, 3), F(3)], mod),
        C("F.rrelu_eval", lambda m, x: _f(m).rrelu(x), [F(3, 4)], mod),
        C("F.maxout", lambda m, x: _f(m).maxout(x, 2), [F(2, 6, 3)], mod),
        C("F.maxout_last", lambda m, x: _f(m).maxout(x, 3, axis=-1),
          [F(2, 6)], mod, ref=False,
          why="the JAX package's maxout reshapes at axis + 1, which a "
              "negative axis misplaces; the port takes the axis as given"),
        C("F.glu_axis0", lambda m, x: _f(m).glu(x, 0), [F(4, 3)], mod),
        C("F.thresholded_relu_0.5", lambda m, x: _f(m).thresholded_relu(
            x, 0.5),
          [F(3, 4)], mod),
        C("F.tanh_", lambda m, x: _f(m).tanh_(x * 1.0), [F(3)], mod),
        C("F.elu_", lambda m, x: _f(m).elu_(x * 1.0, 0.7), [F(3)], mod),
        C("F.softmax_", lambda m, x: _f(m).softmax_(x * 1.0), [F(2, 3)],
          mod),
    ]
    return cases


def _common_cases():
    C, F, I = OpCase, _F, _I
    mod = "common"
    return [
        C("F.linear", lambda m, x, w, b: _f(m).linear(x, w, b),
          [F(2, 3), F(3, 4), F(4)], mod),
        C("F.dropout_eval", lambda m, x: _f(m).dropout(x, 0.3,
                                                       training=False),
          [F(3, 4)], mod),
        C("F.dropout_downscale_eval", lambda m, x: _f(m).dropout(
            x, 0.3, training=False, mode="downscale_in_infer"), [F(3, 4)],
          mod),
        C("F.dropout2d_eval", lambda m, x: _f(m).dropout2d(x, 0.5, False),
          [F(1, 2, 3, 3)], mod),
        C("F.dropout3d_eval", lambda m, x: _f(m).dropout3d(x, 0.5, False),
          [F(1, 2, 2, 2, 2)], mod),
        C("F.alpha_dropout_eval", lambda m, x: _f(m).alpha_dropout(
            x, 0.5, False), [F(3, 4)], mod),
        C("F.embedding", lambda m, i, w: _f(m).embedding(i, w, 1),
          [I(0, 5, 2, 3), F(5, 4)], mod),
        C("F.one_hot", lambda m, i: _f(m).one_hot(i, 4), [I(0, 4, 5)],
          mod),
        C("F.interpolate_nearest", lambda m, x: _f(m).interpolate(
            x, scale_factor=2), [F(1, 2, 3, 3)], mod),
        C("F.upsample_size_nhwc", lambda m, x: _f(m).upsample(
            x, size=[5, 4], data_format="NHWC"), [F(1, 3, 2, 2)], mod),
        C("F.grid_sample", lambda m, x, g: _f(m).grid_sample(x, g),
          [F(2, 3, 4, 5), F(2, 3, 2, 2, lo=-1.1, hi=1.1)], mod),
        C("F.grid_sample_border_unaligned", lambda m, x, g:
          _f(m).grid_sample(x, g, padding_mode="border",
                            align_corners=False),
          [F(1, 2, 4, 4), F(1, 3, 3, 2, lo=-1.2, hi=1.2)], mod),
        C("F.grid_sample_nearest", lambda m, x, g: _f(m).grid_sample(
            x, g, mode="nearest"), [F(1, 2, 4, 4),
                                    F(1, 2, 3, 2, lo=-0.9, hi=0.9)], mod),
        C("F.affine_grid", lambda m, t: _f(m).affine_grid(t, [2, 1, 3, 4]),
          [F(2, 2, 3)], mod),
        C("F.affine_grid_unaligned", lambda m, t: _f(m).affine_grid(
            t, [1, 1, 2, 3], align_corners=False), [F(1, 2, 3)], mod),
        C("F.bilinear", lambda m, a, b, w, bias: _f(m).bilinear(a, b, w,
                                                                 bias),
          [F(2, 3), F(2, 4), F(5, 3, 4), F(5)], mod),
        C("F.pad", lambda m, x: _f(m).pad(x, [1, 1, 2, 0]),
          [F(1, 1, 2, 3)], mod),
        C("F.temporal_shift", lambda m, x: _f(m).temporal_shift(x, 2, 0.25),
          [F(4, 4, 2, 2)], mod),
        C("F.npair_loss", lambda m, a, p, y: _f(m).npair_loss(a, p, y),
          [F(4, 3), F(4, 3), _A([0, 1, 0, 2], np.int64)], mod),
        C("F.sequence_mask", lambda m, x: _f(m).sequence_mask(x, 5),
          [I(0, 6, 3)], mod),
        C("F.sequence_mask_maxlen", lambda m, x: _f(m).sequence_mask(
            x, dtype="float32"), [_A([1, 4, 2], np.int64)], mod),
        C("F.diag_embed", lambda m, x: _f(m).diag_embed(x, -1), [F(2, 3)],
          mod),
        C("F.unfold", lambda m, x: _f(m).unfold(x, [2, 2], 1, 1),
          [F(1, 2, 3, 3)], mod),
        C("F.pixel_shuffle", lambda m, x: _f(m).pixel_shuffle(x, 2),
          [F(1, 4, 2, 2)], mod),
        C("F.pixel_unshuffle", lambda m, x: _f(m).pixel_unshuffle(x, 2),
          [F(1, 1, 4, 4)], mod),
    ]


def _norm_cases():
    C, F = OpCase, _F
    mod = "norm"
    return [
        C("F.layer_norm", lambda m, x, w, b: _f(m).layer_norm(x, 4, w, b),
          [F(2, 3, 4), F(4), F(4)], mod),
        C("F.instance_norm", lambda m, x, w, b: _f(m).instance_norm(
            x, weight=w, bias=b), [F(2, 3, 4, 4), F(3), F(3)], mod),
        C("F.instance_norm_plain", lambda m, x: _f(m).instance_norm(x),
          [F(2, 3, 5)], mod),
        C("F.group_norm", lambda m, x, w, b: _f(m).group_norm(
            x, 2, weight=w, bias=b), [F(2, 4, 3, 3), F(4), F(4)], mod),
        C("F.group_norm_plain", lambda m, x: _f(m).group_norm(x, 3),
          [F(2, 6, 4)], mod),
        C("F.local_response_norm", lambda m, x: _f(m).local_response_norm(
            x, 3), [F(2, 5, 3, 3)], mod),
        C("F.local_response_norm_even", lambda m, x:
          _f(m).local_response_norm(x, 4, 1e-2, 0.5, 2.0), [F(1, 6, 2)],
          mod),
        C("F.normalize", lambda m, x: _f(m).normalize(x), [F(3, 4)], mod),
        C("F.normalize_p1_axis0", lambda m, x: _f(m).normalize(x, 1, 0),
          [F(3, 4)], mod),
    ]


def _loss_cases():
    C, F, I = OpCase, _F, _I
    mod = "loss"
    prob = dict(lo=0.05, hi=0.95)
    cases = []
    for red in ("mean", "sum", "none"):
        cases += [
            C(f"F.mse_loss_{red}", lambda m, x, y, r=red: _f(m).mse_loss(
                x, y, r), [F(3, 4), F(3, 4)], mod),
            C(f"F.l1_loss_{red}", lambda m, x, y, r=red: _f(m).l1_loss(
                x, y, r), [F(3, 4), F(3, 4)], mod),
            C(f"F.smooth_l1_loss_{red}", lambda m, x, y, r=red:
              _f(m).smooth_l1_loss(x, y, r, 0.5), [F(3, 4), F(3, 4)], mod),
        ]
    cases += [
        C("F.square_error_cost", lambda m, x, y: _f(m).square_error_cost(
            x, y), [F(3, 4), F(3, 4)], mod),
        C("F.binary_cross_entropy", lambda m, p, y, w:
          _f(m).binary_cross_entropy(p, y, w),
          [F(3, 4, **prob), F(3, 4, lo=0, hi=1), F(3, 4, **prob)], mod),
        C("F.binary_cross_entropy_sum", lambda m, p, y:
          _f(m).binary_cross_entropy(p, y, reduction="sum"),
          [F(3, 4, **prob), F(3, 4, lo=0, hi=1)], mod),
        C("F.bce_with_logits", lambda m, z, y:
          _f(m).binary_cross_entropy_with_logits(z, y),
          [F(3, 4), F(3, 4, lo=0, hi=1)], mod),
        C("F.bce_with_logits_weights", lambda m, z, y, w, pw:
          _f(m).binary_cross_entropy_with_logits(z, y, w, "none", pw),
          [F(3, 4), F(3, 4, lo=0, hi=1), F(4, **prob), F(4, **prob)], mod),
        C("F.sigmoid_focal_loss", lambda m, z, y:
          _f(m).sigmoid_focal_loss(z, y),
          [F(3, 4), _A([[0, 1, 0, 1]] * 3)], mod),
        C("F.sigmoid_focal_loss_norm", lambda m, z, y, n:
          _f(m).sigmoid_focal_loss(z, y, n, 0.5, 1.5, "mean"),
          [F(3, 4), _A([[1, 0, 0, 1]] * 3), _A(4.0)], mod),
        C("F.kl_div", lambda m, x, y: _f(m).kl_div(x, y),
          [F(3, 4), F(3, 4, lo=0, hi=1)], mod),
        C("F.kl_div_batchmean", lambda m, x, y: _f(m).kl_div(
            x, y, "batchmean"), [F(3, 4), F(3, 4, lo=0, hi=1)], mod),
        C("F.huber_loss", lambda m, x, y: _f(m).huber_loss(x, y, 0.7),
          [F(3, 4), F(3, 4)], mod),
        C("F.hinge_loss", lambda m, x, y: _f(m).hinge_loss(x, y),
          [F(3, 1), _A([[0.0], [1.0], [1.0]])], mod),
        C("F.log_loss", lambda m, p, y: _f(m).log_loss(p, y),
          [F(3, 1, **prob), _A([[0.0], [1.0], [1.0]])], mod),
        C("F.margin_ranking_loss", lambda m, a, b, y:
          _f(m).margin_ranking_loss(a, b, y, 0.1),
          [F(5), F(5), _A([1.0, -1.0, 1.0, 1.0, -1.0])], mod),
        C("F.cosine_similarity", lambda m, a, b: _f(m).cosine_similarity(
            a, b), [F(3, 4), F(3, 4)], mod),
        C("F.cosine_similarity_axis0", lambda m, a, b:
          _f(m).cosine_similarity(a, b, 0), [F(3, 4), F(3, 4)], mod),
        C("F.cosine_embedding_loss", lambda m, a, b, y:
          _f(m).cosine_embedding_loss(a, b, y, 0.2),
          [F(4, 3), F(4, 3), _A([1, -1, 1, -1], np.int64)], mod),
        C("F.triplet_margin_loss", lambda m, a, p, n:
          _f(m).triplet_margin_loss(a, p, n),
          [F(4, 3), F(4, 3), F(4, 3)], mod),
        C("F.triplet_margin_loss_swap", lambda m, a, p, n:
          _f(m).triplet_margin_loss(a, p, n, 0.5, 1.0, swap=True,
                                    reduction="sum"),
          [F(4, 3), F(4, 3), F(4, 3)], mod),
        C("F.label_smooth", lambda m, y: _f(m).label_smooth(y),
          [F(3, 4, lo=0, hi=1)], mod),
        C("F.label_smooth_prior", lambda m, y, p: _f(m).label_smooth(
            y, p, 0.2), [F(3, 4, lo=0, hi=1), F(1, 4, lo=0, hi=1)], mod),
        C("F.ctc_loss", lambda m, lp, lab, il, ll: _f(m).ctc_loss(
            lp, lab, il, ll), [F(6, 2, 5), _A([[1, 2, 2], [3, 1, 0]],
                                              np.int64),
                               _A([6, 5], np.int64), _A([3, 2], np.int64)],
          mod),
        C("F.ctc_loss_sum_norm", lambda m, lp, lab, il, ll: _f(m).ctc_loss(
            lp, lab, il, ll, blank=4, reduction="sum", norm_by_times=True),
          [F(5, 2, 5), _A([[1, 2], [0, 3]], np.int64),
           _A([5, 4], np.int64), _A([2, 1], np.int64)], mod),
        C("F.ctc_loss_impossible", lambda m, lp, lab, il, ll:
          _f(m).ctc_loss(lp, lab, il, ll, reduction="none"),
          [F(2, 1, 4), _A([[1, 1, 1]], np.int64), _A([2], np.int64),
           _A([3], np.int64)], mod, grad=False),
        C("F.warpctc", lambda m, lp, lab: _f(m).warpctc(lp, lab),
          [F(5, 2, 4), _A([[1, 2], [3, 3]], np.int64)], mod),
        C("F.hinge_embedding_loss", lambda m, x, y:
          _f(m).hinge_embedding_loss(x, y, 0.5),
          [F(6), _A([1.0, -1.0, 1.0, -1.0, -1.0, 1.0])], mod),
        C("F.rank_loss", lambda m, y, a, b: _f(m).rank_loss(y, a, b),
          [F(4, 1, lo=0, hi=1), F(4, 1), F(4, 1)], mod),
        C("F.dice_loss", lambda m, x, y: _f(m).dice_loss(x, y),
          [F(3, 4, lo=0, hi=1), I(0, 4, 3, 1)], mod),
        C("F.ctc_greedy_decoder", lambda m, x: _f(m).ctc_greedy_decoder(
            x, blank=0), [F(7, 2, 4)], mod, grad=False),
        C("F.ctc_greedy_decoder_lengths", lambda m, x, n:
          _f(m).ctc_greedy_decoder(x, 3, n, padding_value=-1),
          [F(2, 6, 4), _A([6, 4], np.int64)], mod, grad=False),
        C("F.cross_entropy_soft", lambda m, x, y: _f(m).cross_entropy(
            x, y, soft_label=True), [F(3, 4), F(3, 4, lo=0, hi=1)], mod),
        C("F.nll_loss", lambda m, x, y: _f(m).nll_loss(x, y),
          [F(4, 3), I(0, 3, 4)], mod),
    ]
    return cases




def _sorted_ids(n, k):
    """``n`` sorted segment ids in ``[0, k)`` with segment 1 empty."""
    def make(rng):
        ids = np.sort(rng.integers(0, k, n))
        ids[ids == 1] = 0
        return ids.astype(np.int64)
    return make


def _tied_rows(n, d):
    """``[n, d]`` floats whose first two rows are equal (a tie inside a
    segment)."""
    def make(rng):
        a = rng.standard_normal((n, d)).astype(np.float32)
        a[1] = a[0]
        return a
    return make


def _unpool_idx(n, c, k, hw):
    def make(rng):
        return np.stack([np.stack([rng.permutation(hw)[:k]
                                   for _ in range(c)]) for _ in range(n)]
                        ).reshape(n, c, int(k ** .5), int(k ** .5)
                                  ).astype(np.int64)
    return make


def _iob(n, t, types):
    """Valid IOB tag rows (:func:`iob_tags`)."""
    def make(rng):
        return iob_tags(rng, [t] * n, t, types)
    return make


def _ties(*shape, levels=3):
    """Floats from a few repeated levels: windows of equal maxima."""
    def make(rng):
        return rng.integers(0, levels, shape).astype(np.float32)
    return make


def _a3_cases():
    """The A3 functionals: the convolutions, the pools and the
    interpolation modes (``nn/functional/{conv,pooling,common}.py``)."""
    C, F = OpCase, _F
    cv, pl, it = "a3_conv", "a3_pool", "a3_interp"
    cases = [
        C("F.conv1d", lambda m, x, w, b: _f(m).conv1d(x, w, b, padding=1),
          [F(2, 3, 7), F(4, 3, 3), F(4)], cv),
        C("F.conv1d_nlc_stride_groups", lambda m, x, w: _f(m).conv1d(
            x, w, stride=2, groups=2, data_format="NLC"),
          [F(2, 9, 4), F(6, 2, 3)], cv),
        C("F.conv2d_depthwise_same", lambda m, x, w: _f(m).conv2d(
            x, w, stride=2, padding="SAME", groups=4),
          [F(2, 4, 7, 7), F(4, 1, 5, 5)], cv),
        C("F.conv3d", lambda m, x, w, b: _f(m).conv3d(
            x, w, b, padding=[1, 0, 1], dilation=[1, 2, 1]),
          [F(1, 2, 4, 6, 5), F(3, 2, 3, 2, 3), F(3)], cv),
        C("F.conv3d_ndhwc_pairs", lambda m, x, w: _f(m).conv3d(
            x, w, padding=[0, 1, 1, 0, 1, 1], data_format="NDHWC"),
          [F(1, 3, 4, 4, 2), F(2, 2, 2, 2, 2)], cv),
        C("F.conv1d_transpose", lambda m, x, w, b: _f(m).conv1d_transpose(
            x, w, b, stride=2, padding=1, output_padding=1),
          [F(2, 3, 5), F(3, 4, 3), F(4)], cv),
        C("F.conv2d_transpose", lambda m, x, w, b: _f(m).conv2d_transpose(
            x, w, b, stride=2, padding=1),
          [F(2, 4, 3, 4), F(4, 3, 3, 3), F(3)], cv),
        C("F.conv2d_transpose_groups_dilation", lambda m, x, w:
          _f(m).conv2d_transpose(x, w, stride=[2, 1], padding=[1, 0],
                                 output_padding=[1, 0], groups=2,
                                 dilation=[1, 2]),
          [F(1, 4, 3, 3), F(4, 2, 3, 2)], cv),
        C("F.conv2d_transpose_pairs_nhwc", lambda m, x, w:
          _f(m).conv2d_transpose(x, w, stride=2,
                                 padding=[0, 1, 1, 2], output_padding=1,
                                 data_format="NHWC"),
          [F(1, 3, 4, 2), F(2, 3, 3, 3)], cv),
        C("F.conv3d_transpose", lambda m, x, w, b: _f(m).conv3d_transpose(
            x, w, b, stride=2, padding=1),
          [F(1, 2, 3, 2, 3), F(2, 3, 3, 3, 3), F(3)], cv),
        C("F.deformable_conv_v1", lambda m, x, o, w, b:
          _f(m).deformable_conv(x, o * 1.5, w, bias=b, padding=1),
          [F(2, 4, 5, 5), F(2, 18, 5, 5), F(3, 4, 3, 3), F(3)], cv),
        C("F.deformable_conv_v2_groups", lambda m, x, o, mk, w:
          _f(m).deformable_conv(x, o, w, mask=mk, stride=2,
                                deformable_groups=2, groups=2),
          [F(1, 4, 6, 6), F(1, 16, 3, 3), F(1, 8, 3, 3, lo=0, hi=1),
           F(4, 2, 2, 2)], cv),
        C("F.max_pool3d", lambda m, x: _f(m).max_pool3d(x, 2, padding=1),
          [F(1, 2, 4, 5, 4)], pl),
        C("F.max_pool3d_ceil_ndhwc", lambda m, x: _f(m).max_pool3d(
            x, 3, 2, ceil_mode=True, data_format="NDHWC"),
          [F(1, 5, 6, 4, 2)], pl),
        C("F.avg_pool3d", lambda m, x: _f(m).avg_pool3d(x, 2, padding=1),
          [F(1, 2, 4, 5, 4)], pl),
        C("F.avg_pool3d_inclusive_ceil", lambda m, x: _f(m).avg_pool3d(
            x, [2, 3, 2], 2, ceil_mode=True, exclusive=False),
          [F(1, 2, 5, 5, 4)], pl),
        C("F.adaptive_avg_pool3d", lambda m, x: _f(m).adaptive_avg_pool3d(
            x, [2, 3, 2]), [F(1, 2, 5, 7, 4)], pl),
        C("F.adaptive_max_pool1d", lambda m, x: _f(m).adaptive_max_pool1d(
            x, 3), [F(2, 3, 8)], pl),
        C("F.adaptive_max_pool2d", lambda m, x: _f(m).adaptive_max_pool2d(
            x, [3, 2]), [F(2, 3, 7, 6)], pl),
        C("F.adaptive_max_pool2d_uniform", lambda m, x:
          _f(m).adaptive_max_pool2d(x, 2), [F(1, 2, 4, 6)], pl),
        C("F.adaptive_max_pool3d", lambda m, x: _f(m).adaptive_max_pool3d(
            x, [2, 2, 3]), [F(1, 2, 5, 4, 7)], pl),
        C("F.max_pool2d_mask", lambda m, x: _f(m).max_pool2d(
            x, 3, 2, padding=1, return_mask=True), [F(2, 3, 7, 6)], pl,
          grad=False),
        C("F.max_pool2d_mask_ties", lambda m, x: _f(m).max_pool2d(
            x, 2, return_mask=True), [_ties(2, 2, 6, 6)], pl, grad=False),
        C("F.max_pool2d_mask_ties_padded", lambda m, x: _f(m).max_pool2d(
            x - 1.0, [3, 2], [2, 1], padding=[1, 1], return_mask=True),
          [_ties(1, 2, 5, 5, levels=2)], pl, grad=False),
        C("F.max_pool2d_mask_ties_padded_3x3", lambda m, x:
          _f(m).max_pool2d(x - 1.0, 3, 1, padding=1, return_mask=True),
          [_ties(1, 2, 5, 6, levels=2)], pl, grad=False),
    ]
    for mode in ("bilinear", "bicubic", "area"):
        for kw, tag in ((dict(scale_factor=2), "up"),
                        (dict(size=[3, 2]), "down"),
                        (dict(size=[7, 3]), "mixed")):
            cases.append(C(
                f"F.interpolate_{mode}_{tag}", lambda m, x, mode=mode,
                kw=kw: _f(m).interpolate(x, mode=mode, **kw),
                [F(2, 3, 5, 6)], it))
        cases.append(C(
            f"F.interpolate_{mode}_align_corners", lambda m, x, mode=mode:
            _f(m).interpolate(x, size=[7, 4], mode=mode,
                              align_corners=True), [F(1, 2, 4, 5)], it))
    cases += [
        C("F.interpolate_linear_ncw", lambda m, x: _f(m).interpolate(
            x, size=[11], mode="linear", data_format="NCW"),
          [F(2, 3, 6)], it),
        C("F.interpolate_bilinear_nhwc", lambda m, x: _f(m).interpolate(
            x, scale_factor=[1.5, 0.5], mode="bilinear",
            data_format="NHWC"), [F(1, 4, 6, 2)], it),
        C("F.interpolate_trilinear", lambda m, x: _f(m).interpolate(
            x, size=[5, 2, 7], mode="trilinear", data_format="NCDHW"),
          [F(1, 2, 3, 4, 5)], it),
        C("F.interpolate_trilinear_align_corners", lambda m, x:
          _f(m).interpolate(x, scale_factor=2, mode="trilinear",
                            align_corners=True, data_format="NCDHW"),
          [F(1, 1, 2, 3, 2)], it),
        C("F.upsample_bicubic", lambda m, x: _f(m).upsample(
            x, size=[4, 9], mode="bicubic"), [F(1, 2, 3, 3)], it),
    ]
    return cases


def _structured_cases():
    C, F, I, A = OpCase, _F, _I, _A
    L = lambda *v: A(list(v), np.int64)  # noqa: E731
    host = dict(host=True)
    inc = lambda m: m.incubate  # noqa: E731
    o = lambda m: m.ops  # noqa: E731
    cases = []
    for kind in ("sum", "mean", "max", "min"):
        cases.append(C(f"segment_{kind}", lambda m, d, i, k=kind: getattr(
            inc(m), f"segment_{k}")(d, i, num_segments=5),
            [F(9, 3), _sorted_ids(9, 4)], "segment"))
        cases.append(C(f"segment_{kind}_ties", lambda m, d, i, k=kind:
                       getattr(inc(m), f"segment_{k}")(d, i, 3),
                       [_tied_rows(6, 2), L(0, 0, 0, 2, 2, 2)], "segment"))
    cases += [
        C("segment_pool_mean", lambda m, d, i: inc(m).segment_pool(
            d, i, "MEAN", 4), [F(7, 2, 2), _sorted_ids(7, 4)], "segment"),
        C("segment_sum_host", lambda m, d, i: inc(m).segment_sum(d, i),
          [F(7, 3), _sorted_ids(7, 4)], "segment", **host),
        # sequence
        C("sequence_mask_maxlen", lambda m, x: o(m).sequence_mask(
            x, maxlen=6, dtype="float32"), [L(2, 0, 5)], "sequence"),
        C("sequence_mask_host", lambda m, x: o(m).sequence_mask(x),
          [L(2, 4, 3)], "sequence", **host),
        C("sequence_pad", lambda m, x, n: o(m).sequence_pad(
            x, 0.5, maxlen=5, length=n), [F(9, 2), L(2, 4, 3)], "sequence"),
        C("sequence_pad_host", lambda m, x, n: o(m).sequence_pad(
            x, -1.0, length=n), [F(9, 2), L(2, 4, 3)], "sequence", **host),
        C("sequence_unpad", lambda m, x, n: o(m).sequence_unpad(x, n),
          [F(3, 4, 2), L(2, 4, 1)], "sequence", **host),
    ]
    for pt in ("sum", "average", "sqrt", "max", "min", "first", "last"):
        cases.append(C(f"sequence_pool_{pt}", lambda m, x, n, p=pt:
                       o(m).sequence_pool(x, p, n),
                       [F(3, 5, 2), L(2, 5, 1)], "sequence"))
    cases += [
        C("sequence_pool_dense", lambda m, x: o(m).sequence_pool(x, "max"),
          [F(2, 4, 3)], "sequence"),
        C("sequence_first_step", lambda m, x, n: o(m).sequence_first_step(
            x, n), [F(2, 4, 3), L(3, 1)], "sequence"),
        C("sequence_last_step", lambda m, x, n: o(m).sequence_last_step(
            x, n), [F(2, 4, 3), L(3, 1)], "sequence"),
        C("sequence_softmax", lambda m, x, n: o(m).sequence_softmax(x, n),
          [F(3, 5), L(5, 2, 0)], "sequence"),
        C("sequence_softmax_dense", lambda m, x: o(m).sequence_softmax(x),
          [F(2, 4)], "sequence"),
        C("sequence_reverse", lambda m, x, n: o(m).sequence_reverse(x, n),
          [F(2, 5, 2), L(3, 5)], "sequence"),
        C("sequence_reverse_dense", lambda m, x: o(m).sequence_reverse(x),
          [F(2, 4)], "sequence"),
        C("sequence_expand", lambda m, x, n: o(m).sequence_expand(x, n),
          [F(3, 2), L(2, 0, 3)], "sequence", **host),
        C("sequence_expand_as", lambda m, x, y: o(m).sequence_expand_as(
            x, y), [F(2, 3), F(6, 1)], "sequence"),
        C("sequence_concat", lambda m, a, b, na, nb: o(m).sequence_concat(
            [a, b], [na, nb]), [F(2, 3, 2), F(2, 4, 2), L(2, 3), L(4, 1)],
          "sequence"),
        C("sequence_slice", lambda m, x, off, n: o(m).sequence_slice(
            x, off, n), [F(2, 5, 2), L(1, 0), L(3, 2)], "sequence"),
        C("sequence_enumerate", lambda m, x, n: o(m).sequence_enumerate(
            x, 3, 0, n), [I(1, 9, 2, 5), L(5, 3)], "sequence"),
        C("sequence_enumerate_dense", lambda m, x: o(m).sequence_enumerate(
            x, 2, pad_value=-1), [I(1, 9, 2, 4)], "sequence"),
        C("sequence_erase", lambda m, x, n: o(m).sequence_erase(
            x, [2, 4], n), [I(0, 6, 2, 6), L(6, 4)], "sequence"),
        C("sequence_conv", lambda m, x, w, b, n: o(m).sequence_conv(
            x, w, b, 3, -1, lengths=n),
          [F(2, 5, 3), F(9, 4), F(4), L(5, 3)], "sequence"),
        C("sequence_conv_default", lambda m, x, w: o(m).sequence_conv(
            x, w, context_length=2), [F(2, 4, 3), F(6, 2)], "sequence"),
        C("im2sequence", lambda m, x: o(m).im2sequence(
            x, (2, 2), (1, 2), (0, 1, 1, 0)), [F(2, 3, 5, 5)], "sequence"),
        # beam
        C("gather_tree", lambda m, i, p: m.nn.functional.gather_tree(i, p),
          [I(0, 9, 5, 2, 3), I(0, 3, 5, 2, 3)], "beam"),
        C("beam_search", lambda m, pi, ps, sc: o(m).beam_search(
            pi, ps, None, sc, 3, 4), [I(0, 5, 2, 3), F(2, 3), F(2, 3, 5)],
          "beam"),
        C("beam_search_not_accumulated", lambda m, pi, ps, sc:
          o(m).beam_search(pi, ps, None, sc, 2, 0, is_accumulated=False),
          [I(0, 3, 2, 2), F(2, 2), F(2, 2, 4)], "beam"),
        C("beam_search_decode", lambda m, i, p, sc: o(m).beam_search_decode(
            i, p, sc), [I(0, 9, 4, 2, 3), I(0, 3, 4, 2, 3), F(2, 3)],
          "beam"),
        C("ctc_align", lambda m, x, n: o(m).ctc_align(
            x, 0, True, -1, lengths=n), [I(0, 4, 2, 8), L(8, 5)], "beam"),
        C("ctc_align_keep_repeats", lambda m, x: o(m).ctc_align(
            x, 1, merge_repeated=False), [I(0, 3, 2, 6)], "beam"),
        C("edit_distance", lambda m, h, r, nh, nr: o(m).edit_distance(
            h, r, True, nh, nr), [I(0, 4, 3, 5), I(0, 4, 3, 4), L(5, 3, 0),
                                  L(4, 2, 3)], "beam"),
        C("edit_distance_raw", lambda m, h, r: o(m).edit_distance(
            h, r, normalized=False), [I(0, 3, 2, 4), I(0, 3, 2, 5)], "beam"),
        # crf
        C("linear_chain_crf", lambda m, e, t, y, n: o(m).linear_chain_crf(
            e, t, y, n), [F(3, 6, 4), F(6, 4), I(0, 4, 3, 6), L(6, 4, 1)],
          "crf"),
        C("linear_chain_crf_full", lambda m, e, t, y: o(m).linear_chain_crf(
            e, t, y), [F(2, 5, 3), F(5, 3), I(0, 3, 2, 5)], "crf"),
        C("crf_decoding", lambda m, e, t, n: o(m).crf_decoding(
            e, t, length=n), [F(3, 6, 4), F(6, 4), L(6, 4, 1)], "crf"),
        C("crf_decoding_label", lambda m, e, t, y, n: o(m).crf_decoding(
            e, t, y, n), [F(3, 6, 4), F(6, 4), I(0, 4, 3, 6), L(6, 4, 2)],
          "crf"),
        C("viterbi_decode", lambda m, p, t, n: o(m).viterbi_decode(p, t, n),
          [F(3, 6, 5), F(5, 5), L(6, 3, 1)], "crf"),
        C("viterbi_decode_no_bos_eos", lambda m, p, t: o(m).viterbi_decode(
            p, t, include_bos_eos_tag=False), [F(2, 4, 3), F(3, 3)], "crf"),
        C("chunk_eval_iob", lambda m, a, b, n: o(m).chunk_eval(
            a, b, "IOB", 3, n), [_iob(3, 12, 3), _iob(3, 12, 3), L(12, 9, 5)],
          "crf", **host),
        C("chunk_eval_iobes", lambda m, a, b: o(m).chunk_eval(
            a, b, "IOBES", 2, excluded_chunk_types=[1]),
          [I(0, 9, 2, 10), I(0, 9, 2, 10)], "crf", **host),
        # extras
        C("shape", lambda m, x: o(m).shape(x), [F(3, 4)], "extras"),
        C("size", lambda m, x: o(m).size(x), [F(3, 4)], "extras"),
        C("assign_value", lambda m: o(m).assign_value(
            [2, 3], "float32", list(range(6))), [], "extras"),
        C("fill_constant_batch_size_like", lambda m, x:
          o(m).fill_constant_batch_size_like(x, [1, 4], "float32", 2.0),
          [F(3, 2)], "extras"),
        C("pad_constant_like", lambda m, x, y: o(m).pad_constant_like(
            x, y, 1.5), [F(4, 5), F(2, 3)], "extras"),
        C("squared_l2_distance", lambda m, x, y: o(m).squared_l2_distance(
            x, y), [F(4, 3), F(4, 3)], "extras"),
        C("bpr_loss", lambda m, x, y: o(m).bpr_loss(x, y),
          [F(4, 5), I(0, 5, 4, 1)], "extras"),
        C("modified_huber_loss", lambda m, x, y: o(m).modified_huber_loss(
            x, y), [F(8, 1, lo=-2, hi=2), I(0, 2, 8, 1)], "extras"),
        C("teacher_student_sigmoid_loss", lambda m, x, y:
          o(m).teacher_student_sigmoid_loss(x, y),
          [F(8, 1), F(8, 1, lo=-2, hi=2)], "extras"),
        C("center_loss", lambda m, x, y, c: o(m).center_loss(x, y, c, 0.2),
          [F(5, 3), I(0, 4, 5), F(4, 3)], "extras"),
        C("center_loss_fixed", lambda m, x, y, c: o(m).center_loss(
            x, y, c, update_center=False), [F(5, 3), I(0, 4, 5), F(4, 3)],
          "extras"),
        C("margin_rank_loss", lambda m, y, a, b: o(m).margin_rank_loss(
            y, a, b, 0.2), [A([[1.], [-1.], [1.], [-1.]]), F(4, 1), F(4, 1)],
          "extras"),
        C("mean_iou", lambda m, p, y: o(m).mean_iou(p, y, 5),
          [I(0, 4, 10), I(0, 4, 10)], "extras"),
        C("precision_recall", lambda m, p, y: o(m).precision_recall(p, y, 4),
          [F(6, 4, lo=0, hi=1), I(0, 4, 6, 1)], "extras", grad=False),
        C("positive_negative_pair", lambda m, s, y, q:
          o(m).positive_negative_pair(s, y, q),
          [F(8, 1), I(0, 3, 8, 1), I(0, 2, 8, 1)], "extras", grad=False),
        C("affine_channel", lambda m, x, a, b: o(m).affine_channel(x, a, b),
          [F(2, 3, 4, 4), F(3), F(3)], "extras"),
        C("affine_channel_nhwc", lambda m, x, a, b: o(m).affine_channel(
            x, a, b, "NHWC"), [F(2, 4, 4, 3), F(3), F(3)], "extras"),
        C("data_norm", lambda m, x, n, s, q: o(m).data_norm(x, n, s, q),
          [F(4, 3), F(3, lo=1, hi=5), F(3), F(3, lo=1, hi=5)], "extras"),
        C("batch_fc", lambda m, x, w, b: o(m).batch_fc(x, w, b),
          [F(2, 3, 4), F(2, 4, 5), F(2, 1, 5)], "extras"),
        C("partial_concat", lambda m, a, b: o(m).partial_concat(
            [a, b], 1, 2), [F(3, 5), F(3, 5)], "extras"),
        C("partial_sum", lambda m, a, b: o(m).partial_sum([a, b], -3),
          [F(3, 5), F(3, 5)], "extras"),
        C("cvm", lambda m, x: o(m).cvm(x), [F(4, 5, lo=0, hi=3)], "extras"),
        C("cvm_drop", lambda m, x: o(m).cvm(x, False), [F(4, 5)], "extras"),
        C("filter_by_instag", lambda m, x, t: o(m).filter_by_instag(
            x, t, [1, 3], out_val_if_empty=-2),
          [F(4, 3), I(0, 5, 4, 2)], "extras"),
        C("row_conv", lambda m, x, w: o(m).row_conv(x, w),
          [F(2, 5, 3), F(3, 3)], "extras"),
        C("conv_shift", lambda m, x, y: o(m).conv_shift(x, y),
          [F(2, 7), F(2, 3)], "extras"),
        C("add_position_encoding", lambda m, x: o(m).add_position_encoding(
            x, 0.5, 2.0), [F(2, 5, 6)], "extras"),
        C("add_position_encoding_odd", lambda m, x:
          o(m).add_position_encoding(x), [F(1, 3, 7)], "extras"),
        C("correlation", lambda m, x, y: o(m).correlation(
            x, y, 2, 1, 2, 1, 1), [F(1, 2, 6, 6), F(1, 2, 6, 6)], "extras"),
        C("correlation_strided", lambda m, x, y: o(m).correlation(
            x, y, 2, 1, 2, 2, 2), [F(1, 2, 6, 6), F(1, 2, 6, 6)], "extras"),
        C("similarity_focus", lambda m, x: o(m).similarity_focus(
            x, 1, [0, 2]), [F(2, 3, 4, 5)], "extras", grad=False),
        C("fsp", lambda m, x, y: o(m).fsp(x, y),
          [F(2, 3, 4, 4), F(2, 5, 4, 4)], "extras"),
        C("spp_max", lambda m, x: o(m).spp(x, 3), [F(2, 3, 8, 8)],
          "extras"),
        C("spp_avg", lambda m, x: o(m).spp(x, 2, "avg"), [F(1, 2, 6, 6)],
          "extras"),
        C("max_unpool2d", lambda m, x, i: o(m).max_unpool2d(x, i, 2),
          [F(1, 2, 2, 2), _unpool_idx(1, 2, 4, 16)], "extras"),
        C("match_matrix_tensor", lambda m, x, y, w, nx, ny:
          o(m).match_matrix_tensor(x, y, w, nx, ny),
          [F(2, 3, 4), F(2, 5, 6), F(4, 2, 6), L(3, 2), L(5, 4)], "extras"),
        # sampled (the deterministic heads)
        C("F.hsigmoid_loss", lambda m, x, y, w, b: _f(m).hsigmoid_loss(
            x, y, 6, w, b), [F(4, 3), I(0, 6, 4), F(5, 3), F(5)], "sampled"),
        C("F.hsigmoid_loss_pow2", lambda m, x, y, w: _f(m).hsigmoid_loss(
            x, y, 8, w), [F(5, 3), I(0, 8, 5, 1), F(7, 3)], "sampled"),
        C("F.hsigmoid_loss_custom", lambda m, x, y, w, pt, pc, b:
          _f(m).hierarchical_sigmoid(x, y, 5, w, b, pt, pc),
          [F(3, 4), I(0, 5, 3), F(6, 4),
           A([[0, 2, -1], [1, 4, 5], [3, -1, -1]], np.int64),
           A([[1, 0, 0], [0, 1, 1], [1, 0, 0]], np.int64), F(6, 1)],
          "sampled"),
    ]
    return cases


#: every case of the op table, by module
OP_CASES = (_math_cases() + _manipulation_cases() + _creation_cases()
            + _linalg_cases() + _activation_cases() + _common_cases()
            + _norm_cases() + _loss_cases() + _structured_cases()
            + _a3_cases())

#: the cases run on the card (ties and host reads stay on the CPU)
CUDA_CASES = [c for c in OP_CASES if c.cuda]

#: the ops that read on the host, run eagerly on the card
HOST_CASES = [c for c in OP_CASES if c.host]

#: the structured half's modules (phase 23 of ``chip_smoke.py``)
STRUCTURED = ("segment", "sequence", "beam", "crf", "extras", "sampled")

#: the A3 functionals' modules (phase 25 of ``chip_smoke.py``)
A3 = ("a3_conv", "a3_pool", "a3_interp")


def cuda_case_holds(case, port):
    """Run ``case`` through the port on CUDA and on the CPU (the same
    seeded inputs) and hold them together: forward within the case's
    tolerance (integer and index outputs bitwise), gradients within its
    gradient tolerance. Raises AssertionError naming the case."""
    from paddle_tpu_torch.core import device as tdevice
    saved = tdevice._CURRENT[0]
    try:
        port.set_device("gpu")      # ops that take no tensor follow it
        got = run_case(port, case, place="gpu")
        port.set_device("cpu")
        ref = run_case(port, case, place="cpu")
    finally:
        tdevice._CURRENT[0] = saved
    assert_case_close(case, got, ref, "cuda vs cpu", tol=case.cuda_tol,
                      gtol=max(case.gtol, 1e-4))


def random_ops_hold(P, place):
    """The random ops and random initializers on ``place``: the same
    draws after the same ``P.seed``, shapes and dtypes, and bounds and
    moments at 200,000 draws (mean within 0.01, std within 1%, a
    permutation a permutation). Returns the list of failures."""
    from paddle_tpu_torch.core import device as tdevice
    saved = tdevice._CURRENT[0]
    P.set_device(place)
    fails = []
    n = 200_000
    F = P.nn.functional
    I = P.nn.initializer
    draws = {
        "uniform": lambda: P.uniform([n], min=-2.0, max=3.0),
        "rand": lambda: P.rand([n]),
        "normal": lambda: P.normal(1.0, 2.0, [n]),
        "normal_tensor": lambda: P.normal(P.zeros([n]), P.ones([n]) * 3.0),
        "randn": lambda: P.randn([n]),
        "standard_normal": lambda: P.standard_normal([n], "float64"),
        "randint": lambda: P.randint(-3, 5, [n]),
        "randperm": lambda: P.randperm(1000),
        "bernoulli": lambda: P.bernoulli(P.full([n], 0.3)),
        "multinomial": lambda: P.multinomial(P.to_tensor(
            [0.1, 0.2, 0.7]), 3),
        "multinomial_replace": lambda: P.multinomial(P.to_tensor(
            [[0.25, 0.75]]), n, replacement=True),
        "truncated_normal": lambda: P.truncated_normal([n], 0.5, 2.0),
        "uniform_": lambda: P.zeros([n]).uniform_(0.0, 2.0),
        "normal_": lambda: P.zeros([n]).normal_(-1.0, 0.5),
        "dropout": lambda: F.dropout(P.ones([n]), 0.25),
        "dropout_axis": lambda: F.dropout(P.ones([n // 100, 100]), 0.5,
                                          axis=0),
        "alpha_dropout": lambda: F.alpha_dropout(P.randn([n]), 0.2),
        "rrelu": lambda: F.rrelu(-P.ones([n]), 0.1, 0.3, training=True),
        "gumbel_softmax": lambda: F.gumbel_softmax(P.zeros([n // 4, 4]),
                                                   hard=True),
        "init_Uniform": lambda: P.to_tensor(I.Uniform(-1.0, 1.0)([n])),
        "init_Normal": lambda: P.to_tensor(I.Normal(0.5, 2.0)([n])),
        "init_TruncatedNormal": lambda: P.to_tensor(
            I.TruncatedNormal(0.0, 1.0)([n])),
        "init_XavierUniform": lambda: P.to_tensor(
            I.XavierUniform()([400, 500])),
        "init_XavierNormal": lambda: P.to_tensor(
            I.XavierNormal()([400, 500])),
        "init_KaimingUniform": lambda: P.to_tensor(
            I.KaimingUniform()([400, 500])),
        "init_KaimingNormal": lambda: P.to_tensor(
            I.KaimingNormal()([400, 500])),
        "init_Orthogonal": lambda: P.to_tensor(I.Orthogonal(2.0)([30, 50])),
    }
    checks = {
        "uniform": lambda a: a.min() >= -2 and a.max() < 3 and abs(
            a.mean() - 0.5) < 0.02 and abs(a.std() - 5 / 12 ** .5) < 0.02,
        "rand": lambda a: a.min() >= 0 and a.max() < 1 and abs(
            a.mean() - 0.5) < 0.01,
        "normal": lambda a: abs(a.mean() - 1) < 0.02 and abs(
            a.std() - 2) < 0.02,
        "normal_tensor": lambda a: abs(a.mean()) < 0.03 and abs(
            a.std() - 3) < 0.03,
        "randn": lambda a: abs(a.mean()) < 0.01 and abs(a.std() - 1) < 0.01,
        "standard_normal": lambda a: a.dtype == np.float64 and abs(
            a.mean()) < 0.01,
        "randint": lambda a: a.dtype == np.int64 and a.min() == -3 and
        a.max() == 4 and abs(a.mean() - 0.5) < 0.03,
        "randperm": lambda a: np.array_equal(np.sort(a), np.arange(1000)),
        "bernoulli": lambda a: set(np.unique(a)) <= {0.0, 1.0} and abs(
            a.mean() - 0.3) < 0.01,
        "multinomial": lambda a: sorted(a.tolist()) == [0, 1, 2],
        "multinomial_replace": lambda a: abs(a.mean() - 0.75) < 0.01,
        "truncated_normal": lambda a: a.min() >= 0.5 - 4.0 - 1e-5 and
        a.max() <= 0.5 + 4.0 + 1e-5 and abs(a.mean() - 0.5) < 0.02 and
        abs(a.std() - 2 * 0.8796) < 0.02,
        "uniform_": lambda a: a.min() >= 0 and a.max() < 2 and abs(
            a.mean() - 1) < 0.01,
        "normal_": lambda a: abs(a.mean() + 1) < 0.01 and abs(
            a.std() - 0.5) < 0.01,
        "dropout": lambda a: np.all((a == 0) | np.isclose(a, 1 / 0.75))
        and abs((a == 0).mean() - 0.25) < 0.01,
        "dropout_axis": lambda a: all(len(set(r)) == 1 for r in a[:50]),
        "alpha_dropout": lambda a: abs(a.mean()) < 0.02 and abs(
            a.std() - 1) < 0.03,
        "rrelu": lambda a: a.min() >= -0.3 and a.max() <= -0.1 and abs(
            a.mean() + 0.2) < 0.01,
        "gumbel_softmax": lambda a: np.allclose(a.sum(1), 1.0) and
        np.allclose(a.max(1), 1.0) and abs(a.mean(0) - 0.25).max() < 0.02,
        "init_Uniform": lambda a: a.min() >= -1 and a.max() < 1,
        "init_Normal": lambda a: abs(a.mean() - 0.5) < 0.02 and abs(
            a.std() - 2) < 0.02,
        "init_TruncatedNormal": lambda a: np.abs(a).max() <= 2.0 + 1e-6
        and abs(a.std() - 0.8796) < 0.01,
        "init_XavierUniform": lambda a: np.abs(a).max() <= (
            6 / 900) ** .5 and abs(a.std() - (2 / 900) ** .5) < 1e-3,
        "init_XavierNormal": lambda a: abs(a.std() - (2 / 900) ** .5)
        < 1e-3,
        "init_KaimingUniform": lambda a: np.abs(a).max() <= (
            6 / 400) ** .5 and abs(a.std() - (2 / 400) ** .5) < 1e-3,
        "init_KaimingNormal": lambda a: abs(a.std() - (2 / 400) ** .5)
        < 1e-3,
        "init_Orthogonal": lambda a: np.allclose(
            a @ a.T, 4 * np.eye(30), atol=1e-4),
    }
    try:
        for name, make in draws.items():
            P.seed(17)
            first = make()
            P.seed(17)
            second = make()
            a, b = np.asarray(first.numpy()), np.asarray(second.numpy())
            if not np.array_equal(a, b):
                fails.append(f"{name}: draws differ under one seed")
            elif place == "gpu" and first.place != P.CUDAPlace(0):
                fails.append(f"{name}: on {first.place}, not the card")
            elif not checks[name](a):
                fails.append(f"{name}: bounds or moments off (mean "
                             f"{a.mean():.4f}, std {a.std():.4f})")
    finally:
        tdevice._CURRENT[0] = saved
    return fails


# -- the A3 layer table -------------------------------------------------------

class LayerCase(OpCase):
    """One layer called on seeded inputs: ``build(m)`` makes the layer of
    package ``m``, ``call(layer, *tensors)`` (by default ``layer(*ts)``)
    runs it in training mode with ``train``, else in eval mode;
    ``grad=False`` takes no gradient of the inputs; ``module`` is
    ``"common"`` or ``"activation"`` (the activation and loss layers).
    :func:`run_layer_case` gives its outputs, the gradients of a seeded
    cotangent for its float inputs and its parameters, and its state
    after the call (running statistics move in training)."""

    def __init__(self, name, build, makers, call=None, train=False,
                 tol=1e-5, gtol=1e-4, grad=True, module="common"):
        super().__init__(name, None, makers, module, grad=grad, tol=tol,
                         gtol=gtol)
        self.build, self.train = build, train
        self.call = call or (lambda layer, *ts: layer(*ts))


def run_layer_case(m, case, place=None, state=None):
    """``(outputs, input grads, {param: grad}, {name: state})`` of ``case``
    through package ``m`` as NumPy arrays; with ``state`` (NumPy or
    tensors by name) the layer's parameters and buffers are set from it
    first (``set_state_dict``)."""
    layer = case.build(m)
    if state is not None:
        missing, unexpected = layer.set_state_dict(state)
        assert not missing and not unexpected, (case, missing, unexpected)
    if case.train:
        layer.train()
    else:
        layer.eval()
    arrays = case.arrays()
    floats = [a.dtype.kind == "f" for a in arrays]
    kw = {} if place is None else {"place": place}
    ts = [m.to_tensor(a, stop_gradient=not (f and case.grad), **kw)
          for a, f in zip(arrays, floats)]
    out = case.call(layer, *ts)
    leaves = _leaves(out)
    outs = [_np_of(v) for v in leaves]
    after = {k: _np_of(v) for k, v in layer.state_dict().items()}
    rng = np.random.default_rng(zlib.crc32(("cot" + case.name).encode()))
    loss = None
    for v in leaves:
        if not v.stop_gradient and _np_of(v).dtype.kind == "f":
            cot = m.to_tensor(rng.standard_normal(v.shape).astype(
                np.float32), **kw)
            term = (v * cot).sum()
            loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    grads = [_np_of(t.grad) if case.grad else None
             for t, f in zip(ts, floats) if f]
    pgrads = {n: _np_of(p.grad) for n, p in layer.named_parameters()}
    return outs, grads, pgrads, after


def assert_layer_case_close(case, got, ref, what, tol=None, gtol=None):
    """``got`` against ``ref`` (:func:`run_layer_case`'s): outputs and
    state within ``tol`` of the largest entry (the rest bitwise),
    gradients within ``gtol``; parameter and state names equal."""
    tol = case.tol if tol is None else tol
    gtol = case.gtol if gtol is None else gtol
    (outs, grads, pgrads, state), (routs, rgrads, rpgrads, rstate) = got, \
        ref
    assert sorted(pgrads) == sorted(rpgrads), (case, what, sorted(pgrads),
                                               sorted(rpgrads))
    assert sorted(state) == sorted(rstate), (case, what, sorted(state),
                                             sorted(rstate))
    names = sorted(pgrads)
    assert_case_close(
        case, (outs + [state[k] for k in sorted(state)],
               grads + [pgrads[k] for k in names]),
        (routs + [rstate[k] for k in sorted(rstate)],
         rgrads + [rpgrads[k] for k in names]), what, tol, gtol)


def _layer_cases():
    """Every layer class of A3 (``nn/layers_common.py``,
    ``nn/layers_activation.py``, ``nn/container.py``, the weight and
    spectral norms), each on seeded inputs."""
    L, F, I = LayerCase, _F, _I
    n = lambda m: m.nn  # noqa: E731
    act = "activation"
    cases = [
        L("Conv1D", lambda m: n(m).Conv1D(3, 4, 3, padding=1),
          [F(2, 3, 7)]),
        L("Conv2D_depthwise", lambda m: n(m).Conv2D(4, 4, 3, stride=2,
                                                     padding=1, groups=4,
                                                     bias_attr=False),
          [F(2, 4, 7, 7)]),
        L("Conv3D", lambda m: n(m).Conv3D(2, 3, [3, 2, 3], padding=1),
          [F(1, 2, 4, 5, 4)]),
        L("Conv1DTranspose", lambda m: n(m).Conv1DTranspose(
            3, 4, 3, stride=2, padding=1, output_padding=1), [F(2, 3, 5)]),
        L("Conv2DTranspose", lambda m: n(m).Conv2DTranspose(
            4, 6, 3, stride=2, padding=1, groups=2), [F(2, 4, 3, 4)]),
        L("Conv3DTranspose", lambda m: n(m).Conv3DTranspose(
            2, 3, 2, stride=2), [F(1, 2, 2, 3, 2)]),
        L("BatchNorm_train", lambda m: n(m).BatchNorm(3),
          [F(4, 3, 5)], train=True),
        L("BatchNorm3D_train", lambda m: n(m).BatchNorm3D(2),
          [F(2, 2, 3, 3, 2)], train=True),
        L("BatchNorm3D_eval", lambda m: n(m).BatchNorm3D(2),
          [F(2, 2, 3, 3, 2)]),
        L("SyncBatchNorm_train", lambda m: n(m).SyncBatchNorm(3),
          [F(4, 3, 2, 2)], train=True),
        L("SyncBatchNorm_converted", lambda m: n(m).SyncBatchNorm.
          convert_sync_batchnorm(n(m).Sequential(
              n(m).Conv2D(2, 3, 1), n(m).BatchNorm2D(3))),
          [F(2, 2, 3, 3)], train=True),
        L("GroupNorm", lambda m: n(m).GroupNorm(2, 4), [F(2, 4, 3, 3)]),
        L("InstanceNorm1D", lambda m: n(m).InstanceNorm1D(3),
          [F(2, 3, 6)]),
        L("InstanceNorm2D", lambda m: n(m).InstanceNorm2D(3),
          [F(2, 3, 4, 4)]),
        L("InstanceNorm3D", lambda m: n(m).InstanceNorm3D(2),
          [F(2, 2, 3, 2, 3)]),
        L("LocalResponseNorm", lambda m: n(m).LocalResponseNorm(3),
          [F(2, 5, 3, 3)]),
        L("SpectralNorm", lambda m: n(m).SpectralNorm([4, 3, 2], dim=1,
                                                      power_iters=2),
          [F(4, 3, 2)]),
        L("MaxPool3D", lambda m: n(m).MaxPool3D(2, padding=1),
          [F(1, 2, 4, 5, 4)]),
        L("AvgPool3D", lambda m: n(m).AvgPool3D(2, 1), [F(1, 2, 3, 4, 3)]),
        L("AdaptiveAvgPool3D", lambda m: n(m).AdaptiveAvgPool3D(2),
          [F(1, 2, 5, 4, 3)]),
        L("AdaptiveMaxPool1D", lambda m: n(m).AdaptiveMaxPool1D(3),
          [F(2, 3, 7)]),
        L("AdaptiveMaxPool2D", lambda m: n(m).AdaptiveMaxPool2D([2, 3]),
          [F(2, 3, 5, 7)]),
        L("AdaptiveMaxPool3D", lambda m: n(m).AdaptiveMaxPool3D(2),
          [F(1, 2, 4, 5, 3)]),
        L("MaxPool2D_mask", lambda m: n(m).MaxPool2D(2, return_mask=True),
          [F(2, 3, 4, 6)], grad=False),
        L("Dropout_axis_eval", lambda m: n(m).Dropout(0.4, axis=1),
          [F(2, 3, 4)]),
        L("Dropout2D_eval", lambda m: n(m).Dropout2D(0.5),
          [F(2, 3, 4, 4)]),
        L("Dropout3D_eval", lambda m: n(m).Dropout3D(0.5),
          [F(2, 3, 2, 2, 2)]),
        L("AlphaDropout_eval", lambda m: n(m).AlphaDropout(0.3),
          [F(3, 4)]),
        L("Upsample_bilinear", lambda m: n(m).Upsample(
            scale_factor=2, mode="bilinear"), [F(1, 2, 3, 4)]),
        L("UpsamplingBilinear2D", lambda m: n(m).UpsamplingBilinear2D(
            size=[5, 7]), [F(1, 2, 3, 4)]),
        L("UpsamplingNearest2D", lambda m: n(m).UpsamplingNearest2D(
            scale_factor=2), [F(1, 2, 3, 4)]),
        L("PixelShuffle", lambda m: n(m).PixelShuffle(2), [F(1, 8, 2, 3)]),
        L("Pad1D", lambda m: n(m).Pad1D([1, 2], mode="reflect"),
          [F(2, 3, 5)]),
        L("Pad2D", lambda m: n(m).Pad2D([1, 0, 2, 1], value=0.5),
          [F(1, 2, 3, 4)]),
        L("Pad3D", lambda m: n(m).Pad3D([1, 1, 0, 1, 1, 0],
                                        mode="replicate"),
          [F(1, 2, 2, 3, 2)]),
        L("ZeroPad2D", lambda m: n(m).ZeroPad2D([1, 1, 0, 2]),
          [F(1, 2, 3, 3)]),
        L("CosineSimilarity", lambda m: n(m).CosineSimilarity(axis=1),
          [F(3, 5), F(3, 5)]),
        L("Bilinear", lambda m: n(m).Bilinear(3, 4, 5), [F(2, 3), F(2, 4)]),
        L("Unfold", lambda m: n(m).Unfold([2, 2], 1, 1), [F(1, 2, 3, 3)]),
        L("PReLU", lambda m: n(m).PReLU(3, 0.1), [F(2, 3, 4)], module=act),
        L("PReLU_scalar", lambda m: n(m).PReLU(), [F(2, 3)], module=act),
        L("RReLU_eval", lambda m: n(m).RReLU(), [F(3, 4)], module=act),
        L("Maxout", lambda m: n(m).Maxout(2), [F(2, 6, 3)], module=act),
        L("GLU", lambda m: n(m).GLU(1), [F(3, 4)], module=act),
        L("GELU_tanh", lambda m: n(m).GELU(approximate=True), [F(3, 4)],
          module=act),
        L("Softmax_axis0", lambda m: n(m).Softmax(0), [F(3, 4)], module=act),
        L("Hardtanh_bounds", lambda m: n(m).Hardtanh(-0.5, 2.0),
          [F(3, 4)], module=act),
        L("Softplus_beta", lambda m: n(m).Softplus(2.0, 3.0), [F(3, 4)],
          module=act),
        L("MSELoss", lambda m: n(m).MSELoss(), [F(3, 4), F(3, 4)], module=act),
        L("L1Loss_sum", lambda m: n(m).L1Loss("sum"), [F(3, 4), F(3, 4)],
          module=act),
        L("NLLLoss", lambda m: n(m).NLLLoss(), [F(4, 5), I(0, 5, 4)],
          module=act),
        L("BCELoss", lambda m: n(m).BCELoss(),
          [F(3, 4, lo=0.05, hi=0.95), F(3, 4, lo=0, hi=1)], module=act),
        L("BCEWithLogitsLoss", lambda m: n(m).BCEWithLogitsLoss(),
          [F(3, 4), F(3, 4, lo=0, hi=1)], module=act),
        L("KLDivLoss", lambda m: n(m).KLDivLoss("batchmean"),
          [F(3, 4), F(3, 4, lo=0.1, hi=1)], module=act),
        L("SmoothL1Loss", lambda m: n(m).SmoothL1Loss(delta=0.5),
          [F(3, 4), F(3, 4)], module=act),
        L("MarginRankingLoss", lambda m: n(m).MarginRankingLoss(0.1),
          [F(5), F(5), _A([1, -1, 1, 1, -1])], module=act),
        L("CTCLoss", lambda m: n(m).CTCLoss(), [
            _log_probs(6, 2, 4), _A([[1, 2, 1], [3, 1, 0]], np.int32),
            _A([6, 5], np.int64), _A([3, 2], np.int64)], module=act),
        L("CosineEmbeddingLoss", lambda m: n(m).CosineEmbeddingLoss(0.2),
          [F(4, 3), F(4, 3), _A([1, -1, 1, -1], np.int64)], module=act),
        L("TripletMarginLoss", lambda m: n(m).TripletMarginLoss(),
          [F(4, 3), F(4, 3), F(4, 3)], module=act),
        L("HSigmoidLoss", lambda m: n(m).HSigmoidLoss(3, 5),
          [F(4, 3), _A([[0], [2], [4], [1]], np.int64)], module=act),
        L("PairwiseDistance", lambda m: n(m).PairwiseDistance(),
          [F(4, 3), F(4, 3)], module=act),
        L("LayerList_LayerDict_ParameterList", _containers, [F(2, 3)]),
        L("weight_norm", lambda m: n(m).utils.weight_norm(
            n(m).Linear(3, 4), dim=1), [F(2, 3)]),
        L("spectral_norm_hook", lambda m: n(m).utils.spectral_norm(
            n(m).Linear(4, 3), n_power_iterations=2), [F(2, 4)]),
    ]
    plain = ["ReLU6", "GELU", "Sigmoid", "LogSoftmax", "ELU", "SELU",
             "CELU", "Silu", "Swish", "Mish", "Hardswish", "Hardsigmoid",
             "Hardshrink", "Softshrink", "Tanhshrink", "Softsign",
             "LogSigmoid", "ThresholdedReLU"]
    cases += [L(k, lambda m, k=k: getattr(n(m), k)(), [F(3, 4)],
                call=lambda layer, x: layer(x * 3.0), module=act)
              for k in plain]
    return cases


def _log_probs(t, b, c):
    def make(rng):
        z = rng.standard_normal((t, b, c))
        return (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(
            np.float32)
    return make


def _containers(m):
    """A layer over ``LayerList`` (appended, inserted into, sliced),
    ``LayerDict`` and ``ParameterList``."""
    nn = m.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = nn.LayerList([nn.Linear(3, 4)])
            self.blocks.append(nn.Linear(4, 4))
            self.blocks.insert(1, nn.Tanh())
            self.heads = nn.LayerDict({"a": nn.Linear(4, 2)})
            self.heads["b"] = nn.Linear(4, 2)
            self.scales = nn.ParameterList(
                [self.create_parameter([2], default_initializer=nn.
                                       initializer.Constant(v))
                 for v in (0.5, 2.0)])

        def forward(self, x):
            for blk in self.blocks[:3]:
                x = blk(x)
            return [self.heads[k](x) * p for k, p in zip(
                self.heads.keys(), self.scales)]
    return Net()


#: every case of the A3 layer table
LAYER_CASES = _layer_cases()


def layer_case_holds(case, port):
    """``case`` through the port on CUDA and on the CPU, from the same
    state (the CPU build's, carried by ``set_state_dict``): outputs,
    gradients and state after the call within the case's tolerances.
    Raises AssertionError naming the case."""
    from paddle_tpu_torch.core import device as tdevice
    saved = tdevice._CURRENT[0]
    try:
        port.set_device("cpu")
        state = case.build(port).state_dict()
        ref = run_layer_case(port, case, place="cpu", state=state)
        port.set_device("gpu")
        got = run_layer_case(port, case, place="gpu", state=state)
    finally:
        tdevice._CURRENT[0] = saved
    assert_layer_case_close(case, got, ref, "cuda vs cpu", tol=case.cuda_tol,
                            gtol=max(case.gtol, 1e-4))


def vit(m, image=224, patch=16, width=768, depth=12, heads=12,
        classes=1000, mlp_ratio=4, epsilon=1e-6, attn_impl="auto"):
    """A ViT written from package ``m``'s ``nn`` as a paddle user writes
    one; by default PaddleClas's ``ViT_base_patch16_224`` (image 224,
    patch 16, width 768, depth 12, 12 heads, MLP ratio 4, ``qkv_bias``,
    LayerNorm epsilon 1e-6, 1000 classes, every dropout 0): a ``Conv2D``
    patch embedding, a class token and position embedding from
    ``create_parameter`` with ``TruncatedNormal(std=0.02)``, a
    ``LayerList`` of pre-norm blocks (``LayerNorm``,
    ``MultiHeadAttention``, residual; ``LayerNorm``, ``Linear``,
    ``GELU``, ``Linear``, residual), a final ``LayerNorm`` and a
    ``Linear`` head on the class token. It returns the logits in training
    and their ``Softmax`` in eval (the predict program). ``attn_impl``
    goes to every ``MultiHeadAttention``."""
    nn = m.nn

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.norm1 = nn.LayerNorm(width, epsilon=epsilon)
            self.attn = nn.MultiHeadAttention(width, heads,
                                              attn_impl=attn_impl)
            self.norm2 = nn.LayerNorm(width, epsilon=epsilon)
            self.mlp = nn.Sequential(nn.Linear(width, width * mlp_ratio),
                                     nn.GELU(),
                                     nn.Linear(width * mlp_ratio, width))

        def forward(self, x):
            h = self.norm1(x)
            x = x + self.attn(h, h, h)
            return x + self.mlp(self.norm2(x))

    class ViT(nn.Layer):
        def __init__(self):
            super().__init__()
            tokens = (image // patch) ** 2 + 1
            attr = m.ParamAttr(
                initializer=nn.initializer.TruncatedNormal(std=0.02))
            self.patch_embed = nn.Conv2D(3, width, patch, stride=patch)
            self.cls_token = self.create_parameter([1, 1, width], attr)
            self.pos_embed = self.create_parameter([1, tokens, width], attr)
            self.blocks = nn.LayerList([Block() for _ in range(depth)])
            self.norm = nn.LayerNorm(width, epsilon=epsilon)
            self.head = nn.Linear(width, classes)
            self.softmax = nn.Softmax()

        def forward(self, x):
            x = m.transpose(m.flatten(self.patch_embed(x), 2), [0, 2, 1])
            cls = m.expand(self.cls_token, [x.shape[0], 1, width])
            x = m.concat([cls, x], axis=1) + self.pos_embed
            for block in self.blocks:
                x = block(x)
            logits = self.head(self.norm(x)[:, 0])
            return logits if self.training else self.softmax(logits)
    return ViT()


# -- the BERT-CRF tagger: a sequence labeller as a paddle user writes one ----

#: MSRA-NER's IOB tags over PER, ORG and LOC: ``2 * type`` opens a chunk
#: (B), ``2 * type + 1`` continues it (I), ``2 * NER_TYPES`` is O
NER_TYPES = 3
NER_TAGS = 2 * NER_TYPES + 1


def iob_tags(rng, lengths, T, types=NER_TYPES):
    """Valid IOB rows ``[len(lengths), T]`` (O past each length)."""
    out = np.full((len(lengths), T), 2 * types, np.int64)
    for r, n in enumerate(lengths):
        i = 0
        while i < n:
            if rng.random() < 0.3:
                ty, span = int(rng.integers(0, types)), int(rng.integers(1, 5))
                span = min(span, n - i)
                out[r, i] = 2 * ty
                out[r, i + 1:i + span] = 2 * ty + 1
                i += span
            else:
                i += 1
    return out


def bert_crf_tagger(m, bert, hidden, num_tags=NER_TAGS):
    """PaddleNLP's BERT + CRF tagger for MSRA-NER, as a paddle user writes
    it for package ``m``: ``(network, loss)``. The network maps ``(ids,
    lengths)`` to the emissions (a ``Linear`` over ``bert``'s sequence
    output) and the lengths, and in eval mode also to the Viterbi path
    (``crf_decoding``); the transition ``[num_tags + 2, num_tags]`` is a
    ``create_parameter``; the loss is ``linear_chain_crf(...).mean()``.
    The head names its initializer (the reference's default,
    Xavier-uniform): a port layer without one is drawn only by
    ``reset_parameters``."""
    class BertCrfTagger(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = bert
            self.emission = m.nn.Linear(hidden, num_tags, weight_attr=(
                m.ParamAttr(initializer=m.nn.initializer.XavierUniform())))
            self.transition = self.create_parameter([num_tags + 2,
                                                     num_tags])

        def forward(self, ids, lengths):
            seq, _ = self.bert(ids)
            em = self.emission(seq)
            if self.training:
                return em, lengths
            return em, lengths, m.ops.crf_decoding(em, self.transition,
                                                   length=lengths)

    net = BertCrfTagger()

    class CrfLoss(m.nn.Layer):
        def forward(self, em, lengths, *rest):
            return m.ops.linear_chain_crf(em, net.transition, rest[-1],
                                          lengths).mean()
    return net, CrfLoss()


def cond_net(m, loop=False):
    """The JAX package's ``cond`` train step (``tests/test_control_flow.py``
    ``:99-124``) for package ``m``: ``Linear(4, 1)`` and a forward that
    branches on its data, the branch not taken (while the mean stays
    under 100) taking ``sqrt`` of a negative input; with ``loop``, a
    ``while_loop`` whose trip count is read from the data instead. The
    weight's initializer is named, as :func:`bert_crf_tagger`'s."""
    class CondNet(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = m.nn.Linear(4, 1, weight_attr=m.ParamAttr(
                initializer=m.nn.initializer.XavierUniform()))

        def forward(self, x):
            h = self.fc(x)
            if loop:
                return m.ops.while_loop(lambda v: m.sum(v) < 100.0,
                                        lambda v: [v * 2.0 + 1.0], [h])[0]
            return m.ops.cond(m.mean(h) < 100.0, lambda: h,
                              lambda: m.sqrt(-m.abs(h) - 1.0))
    return CondNet()


# -- beam search over a GPT, as a user writes it --------------------------------

def gpt_beam_cells(m, model, prompts, cached):
    """The two cells a user writes to beam-decode a GPT whose prompts end
    in the start token: ``(cell, inits)``. Cached: the prefix before the
    last token prefilled once into the incremental cache, one token a
    step; full prefix: the token history as the state, the whole prefix a
    step with no cache."""
    pre = m.to_tensor(np.asarray(prompts)[:, :-1].astype(np.int64))
    if cached:
        _, cache = model(pre, cache=model.gpt.gen_cache(pre))

        def cell(ids, c):
            logits, c = model(m.reshape(ids, [-1, 1]), cache=c)
            return logits[:, -1], c
        return cell, cache

    def cell(ids, hist):
        hist = m.concat([hist, m.reshape(ids, [-1, 1]).astype(hist.dtype)],
                        axis=1)
        return model(hist)[:, -1], hist
    return cell, pre


def structured_draws_hold(P, place):
    """The structured half's draws on ``place``: on it, equal after the
    same ``P.seed``, and ``shuffle_batch``'s ``seed`` argument
    independent of it. Returns the list of failures."""
    from paddle_tpu_torch.core import device as tdevice
    saved = tdevice._CURRENT[0]
    P.set_device(place)
    F = P.nn.functional
    fails = []
    try:
        x = P.to_tensor(np.arange(64, dtype=np.float32).reshape(32, 2))
        w = P.to_tensor(np.random.default_rng(0).standard_normal(
            (20, 2)).astype(np.float32))
        y = P.to_tensor(np.arange(32) % 20)
        draws = {
            "shuffle_batch": lambda: P.ops.shuffle_batch(x)[1],
            "uniform_like": lambda: P.ops.uniform_random_batch_size_like(
                x, [1, 3]),
            "gaussian_like": lambda: P.ops.gaussian_random_batch_size_like(
                x, [1, 3]),
            "nce": lambda: F.nce(x, y[:, None], w, num_neg_samples=4,
                                 sampler="log_uniform"),
            "sampling_id": lambda: F.sampling_id(F.softmax(x)),
            "sample_logits": lambda: F.sample_logits(
                F.linear(x, w.T), y[:, None], 5)[0],
            "class_center_sample": lambda: F.class_center_sample(
                y[:4], 20, 8)[1]}
        for name, make in draws.items():
            P.seed(3)
            a = make()
            P.seed(3)
            if a.place != P.CUDAPlace(0) and place == "gpu":
                fails.append(f"{name}: on {a.place}, not the card")
            elif not np.array_equal(a.numpy(), make().numpy()):
                fails.append(f"{name}: draws differ under one seed")
        a = P.ops.shuffle_batch(x, seed=5)[1].numpy()
        P.seed(99)
        if not np.array_equal(a, P.ops.shuffle_batch(x, seed=5)[1].numpy()):
            fails.append("shuffle_batch(seed=5) follows the global seed")
    finally:
        tdevice._CURRENT[0] = saved
    return fails


# -- the op-built GPT: a user's paddle program written from Tensor ops ------

def gpt_weight_names(num_layers):
    """The ``GPTForCausalLM`` state-dict names the op-built GPT takes its
    weights by (the same in both packages), in its parameter order: the
    global-norm clip sums the parameters' squares in this order, so the
    same order gives the same rounding."""
    names = ["gpt.word_embeddings.weight", "gpt.position_embeddings.weight"]
    for i in range(num_layers):
        p = f"gpt.decoder.layers.{i}."
        for part in ("self_attn.q_proj", "self_attn.k_proj",
                     "self_attn.v_proj", "self_attn.out_proj", "linear1",
                     "linear2", "norm1", "norm2"):
            names += [p + part + ".weight", p + part + ".bias"]
    return names + ["gpt.decoder.norm.weight", "gpt.decoder.norm.bias"]


def op_built_gpt(m, weights, num_layers, num_heads, dense=False):
    """A GPT written as a paddle user writes one, from the op surface of
    package ``m`` (the JAX package or the port) alone: every weight a
    ``create_parameter`` with ``ParamAttr(initializer=Assign(array))``
    from ``weights`` (float32 arrays by :func:`gpt_weight_names`; the
    port's ``Assign`` also takes its tensors), the
    forward from ``F.embedding``, ``arange``/``unsqueeze``/``tile``,
    ``F.layer_norm``, ``matmul`` and ``+``, ``reshape``,
    ``F.flash_attention(causal=True)`` (or, ``dense``, the reference's
    dense branch: ``transpose``, ``triu(full(-1e9), 1)``, ``matmul``,
    ``F.softmax``), ``F.gelu`` and the tied head ``matmul(h, wte,
    transpose_y=True)``. ``model.loss(logits, ids)`` is the shifted
    next-token cross entropy through slicing, ``reshape`` and
    ``F.cross_entropy``."""
    F = m.nn.functional

    class OpGPT(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self._names = []
            for name in gpt_weight_names(num_layers):
                arr = weights[name]          # NumPy, or a tensor (port)
                p = self.create_parameter(
                    list(arr.shape), attr=m.ParamAttr(
                        initializer=m.nn.initializer.Assign(arr)))
                attr = name.replace(".", "_")
                setattr(self, attr, p)
                self._names.append(attr)

        def w(self, name):
            return getattr(self, name.replace(".", "_"))

        def _attention(self, x, p, b, s, hidden):
            d = hidden // num_heads
            q = m.matmul(x, self.w(p + "q_proj.weight")) + \
                self.w(p + "q_proj.bias")
            k = m.matmul(x, self.w(p + "k_proj.weight")) + \
                self.w(p + "k_proj.bias")
            v = m.matmul(x, self.w(p + "v_proj.weight")) + \
                self.w(p + "v_proj.bias")
            shape = [b, -1, num_heads, d]
            q, k, v = (m.reshape(t, shape) for t in (q, k, v))
            if not dense:
                out, _ = F.flash_attention(q, k, v, causal=True)
                return m.reshape(out, [b, s, hidden])
            q, k, v = (m.transpose(t, [0, 2, 1, 3]) for t in (q, k, v))
            mask = m.triu(m.full([s, s], -1e9), 1)
            scores = m.matmul(q * (1.0 / float(np.sqrt(d))), k,
                              transpose_y=True) + mask
            out = m.matmul(F.softmax(scores), v)
            return m.reshape(m.transpose(out, [0, 2, 1, 3]), [b, s, hidden])

        def forward(self, ids):
            b, s = ids.shape[0], ids.shape[1]
            wte = self.w("gpt.word_embeddings.weight")
            hidden = wte.shape[1]
            pos = m.tile(m.arange(s).unsqueeze(0), [b, 1])
            h = F.embedding(ids, wte) + F.embedding(
                pos, self.w("gpt.position_embeddings.weight"))
            for i in range(num_layers):
                p = f"gpt.decoder.layers.{i}."
                x = F.layer_norm(h, hidden, self.w(p + "norm1.weight"),
                                 self.w(p + "norm1.bias"))
                a = self._attention(x, p + "self_attn.", b, s, hidden)
                h = h + (m.matmul(a, self.w(p + "self_attn.out_proj.weight"))
                         + self.w(p + "self_attn.out_proj.bias"))
                x = F.layer_norm(h, hidden, self.w(p + "norm2.weight"),
                                 self.w(p + "norm2.bias"))
                x = F.gelu(m.matmul(x, self.w(p + "linear1.weight"))
                           + self.w(p + "linear1.bias"))
                h = h + (m.matmul(x, self.w(p + "linear2.weight"))
                         + self.w(p + "linear2.bias"))
            h = F.layer_norm(h, hidden, self.w("gpt.decoder.norm.weight"),
                             self.w("gpt.decoder.norm.bias"))
            return m.matmul(h, wte, transpose_y=True)

        @staticmethod
        def loss(logits, ids):
            v = logits.shape[-1]
            return F.cross_entropy(m.reshape(logits[:, :-1, :], [-1, v]),
                                   m.reshape(ids[:, 1:], [-1]))

    return OpGPT()


def test_op_table_case_names_are_unique():
    names = [c.name for c in OP_CASES]
    assert len(names) == len(set(names)), sorted(
        n for n in set(names) if names.count(n) > 1)
