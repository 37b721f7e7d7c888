"""The op library and the Tensor's method table (counterpart of
``paddle_tpu/ops/__init__.py``).

``ops.dispatch`` is the funnel every op runs through; ``ops.creation``,
``ops.math``, ``ops.manipulation`` and ``ops.linalg`` hold the dense op
surface of the reference, and ``ops.segment``, ``ops.sequence``,
``ops.beam``, ``ops.crf``, ``ops.control_flow`` and ``ops.extras`` its
structured half, ``ops.detection`` the detection ops; this package re-exports their names as the reference's
does (``:19-45``: ``control_flow``'s ``increment`` and ``sequence``'s
``sequence_mask`` are the names here). ``_attach_methods`` puts the
reference's method table on :class:`~paddle_tpu_torch.core.tensor.Tensor`
(``:48``), with its in-place variants (``:139``), operator dunders
(``:166``) and ``T``; :func:`_late_alias`, which the package's
``__init__`` calls once ``nn`` is loaded, adds the fluid-era names
(``:191``). The operators with hand-written CUDA kernels (counterparts
of the Pallas kernels in ``paddle_tpu/ops``) live in
the module ``paddle_tpu_torch.ops.flash_attention`` (whose op
``flash_attention`` this namespace exports under the module's name, as the
reference's does, so the module is reached by
``importlib.import_module``), ``ops.paged_attention`` and ``ops.custom`` (greedy NMS), each module
holding its kernel's wrapper and plain version, with ``ops.detection``
built on the NMS kernel; they build their kernels on first launch, never
at import. Ops bound with ``ops.custom.register_op`` land in this
namespace."""
from __future__ import annotations

import sys

import torch

from ..core.tensor import Tensor
from . import creation, dispatch, linalg, manipulation, math
from .creation import *  # noqa: F401,F403
from .dispatch import (OP_REGISTRY, apply, apply_raw,  # noqa: F401
                       disable_static, enable_static, in_dygraph_mode)
# the op, under the name the reference's namespace gives it; this name then
# shadows its module, which importlib.import_module reaches by path
from .flash_attention import flash_attention  # noqa: F401
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .control_flow import (array_length, array_read,  # noqa: F401,E402
                           array_write, case, cond, create_array, increment,
                           switch_case, while_loop)
from .segment import (segment_max, segment_mean,  # noqa: F401,E402
                      segment_min, segment_pool, segment_sum)
from .extras import *  # noqa: F401,F403,E402
from .crf import (chunk_eval, crf_decoding,  # noqa: F401,E402
                  linear_chain_crf, viterbi_decode)
from .sequence import (im2sequence, sequence_concat,  # noqa: F401,E402
                       sequence_conv, sequence_enumerate, sequence_erase,
                       sequence_expand, sequence_expand_as,
                       sequence_first_step, sequence_last_step,
                       sequence_mask, sequence_pad, sequence_pool,
                       sequence_reverse, sequence_slice, sequence_softmax,
                       sequence_unpad)
from .beam import (beam_search, beam_search_decode,  # noqa: F401,E402
                   ctc_align, edit_distance, gather_tree)
from .detection import (anchor_generator, bipartite_match,  # noqa: F401,E402
                        box_clip, box_coder, box_decoder_and_assign,
                        collect_fpn_proposals, deformable_psroi_pooling,
                        density_prior_box, distribute_fpn_proposals,
                        generate_proposals, iou_similarity, matrix_nms,
                        multiclass_nms, polygon_box_transform, prior_box,
                        prroi_pool, psroi_pool, roi_align, roi_pool,
                        smooth_l1, target_assign, yolo_box, yolov3_loss)


def _attach_methods():
    m, mp, cr = math, manipulation, creation
    methods = {
        # math
        "abs": m.abs, "exp": m.exp, "log": m.log, "log2": m.log2,
        "log10": m.log10, "log1p": m.log1p, "sqrt": m.sqrt,
        "rsqrt": m.rsqrt, "square": m.square, "sin": m.sin, "cos": m.cos,
        "tan": m.tan, "tanh": m.tanh, "sigmoid": m.sigmoid,
        "floor": m.floor, "ceil": m.ceil, "round": m.round,
        "trunc": m.trunc, "sign": m.sign, "reciprocal": m.reciprocal,
        "erf": m.erf, "erfinv": m.erfinv, "lgamma": m.lgamma,
        "digamma": m.digamma, "neg": m.neg, "isnan": m.isnan,
        "isinf": m.isinf, "isfinite": m.isfinite,
        "logical_not": m.logical_not, "bitwise_not": m.bitwise_not,
        "add": m.add, "subtract": m.subtract, "multiply": m.multiply,
        "divide": m.divide, "floor_divide": m.floor_divide, "mod": m.mod,
        "remainder": m.remainder, "pow": m.pow, "maximum": m.maximum,
        "minimum": m.minimum, "fmax": m.fmax, "fmin": m.fmin,
        "atan2": m.atan2, "logical_and": m.logical_and,
        "logical_or": m.logical_or, "logical_xor": m.logical_xor,
        "bitwise_and": m.bitwise_and, "bitwise_or": m.bitwise_or,
        "bitwise_xor": m.bitwise_xor, "equal": m.equal,
        "not_equal": m.not_equal, "greater_than": m.greater_than,
        "greater_equal": m.greater_equal, "less_than": m.less_than,
        "less_equal": m.less_equal, "equal_all": m.equal_all,
        "allclose": m.allclose, "isclose": m.isclose,
        "matmul": m.matmul, "mm": m.mm, "bmm": m.bmm, "mv": m.mv,
        "dot": m.dot, "inner": m.inner, "outer": m.outer, "kron": m.kron,
        "cross": m.cross, "trace": m.trace, "scale": m.scale,
        "clip": m.clip, "lerp": m.lerp, "nan_to_num": m.nan_to_num,
        # reductions
        "sum": m.sum, "mean": m.mean, "prod": m.prod, "max": m.max,
        "min": m.min, "amax": m.amax, "amin": m.amin, "all": m.all,
        "any": m.any, "std": m.std, "var": m.var, "median": m.median,
        "nanmean": m.nanmean, "nansum": m.nansum, "quantile": m.quantile,
        "logsumexp": m.logsumexp, "cumsum": m.cumsum,
        "cumprod": m.cumprod, "count_nonzero": m.count_nonzero,
        "norm": m.norm, "dist": m.dist,
        # search and sort
        "argmax": m.argmax, "argmin": m.argmin, "argsort": m.argsort,
        "sort": m.sort, "topk": m.topk, "kthvalue": m.kthvalue,
        "mode": m.mode, "where": m.where, "nonzero": m.nonzero,
        "masked_select": m.masked_select, "masked_fill": m.masked_fill,
        "index_select": m.index_select, "index_sample": m.index_sample,
        "take_along_axis": m.take_along_axis,
        "put_along_axis": m.put_along_axis, "gather": m.gather,
        "gather_nd": m.gather_nd, "scatter": m.scatter,
        "scatter_nd_add": m.scatter_nd_add, "bincount": m.bincount,
        "histogram": m.histogram, "unique": m.unique,
        "unique_consecutive": m.unique_consecutive,
        "searchsorted": m.searchsorted,
        # manipulation
        "reshape": mp.reshape, "reshape_": mp.reshape_,
        "transpose": mp.transpose, "moveaxis": mp.moveaxis,
        "swapaxes": mp.swapaxes, "split": mp.split, "chunk": mp.chunk,
        "squeeze": mp.squeeze, "squeeze_": mp.squeeze_,
        "unsqueeze": mp.unsqueeze, "unsqueeze_": mp.unsqueeze_,
        "flatten": mp.flatten, "tile": mp.tile, "expand": mp.expand,
        "expand_as": mp.expand_as, "broadcast_to": mp.broadcast_to,
        "flip": mp.flip, "roll": mp.roll, "unbind": mp.unbind,
        "unstack": mp.unstack, "repeat_interleave": mp.repeat_interleave,
        "slice": mp.slice, "strided_slice": mp.strided_slice,
        "tolist": mp.tolist, "tensordot": mp.tensordot,
        # linalg
        "cholesky": linalg.cholesky, "inverse": linalg.inv,
        "matrix_power": linalg.matrix_power,
        # creation
        "fill_": cr.fill_, "zero_": cr.zero_, "uniform_": cr.uniform_,
        "normal_": cr.normal_,
        # the rest of the reference's tensor/__init__.py method list
        "acos": m.acos, "asin": m.asin, "atan": m.atan, "cosh": m.cosh,
        "sinh": m.sinh, "conj": m.conj, "real": m.real, "imag": m.imag,
        "stanh": m.stanh, "addmm": m.addmm, "tril": cr.tril,
        "triu": cr.triu, "multinomial": cr.multinomial, "mul": m.multiply,
        "floor_mod": m.mod, "reverse": mp.flip,
    }
    for name, fn in methods.items():
        setattr(Tensor, name, fn)
    Tensor.t = mp.t
    Tensor.numel = cr.numel
    Tensor.is_empty = m.is_empty

    def _rank_m(self):
        from ..tensor import rank      # deferred: tensor imports ops
        return rank(self)
    Tensor.rank = _rank_m

    # in-place variants: the functional result adopted by the Tensor,
    # recorded by autograd (core/tensor.py ``_swap_payload``)
    def _inplace_of(fn):
        def method(self, *a, **k):
            self._swap_payload(fn(self, *a, **k))
            return self
        return method
    for iname, ifn in {
            "add_": m.add, "subtract_": m.subtract, "scale_": m.scale,
            "clip_": m.clip, "exp_": m.exp, "sqrt_": m.sqrt,
            "rsqrt_": m.rsqrt, "reciprocal_": m.reciprocal,
            "floor_": m.floor, "ceil_": m.ceil, "round_": m.round,
            "tanh_": m.tanh, "flatten_": mp.flatten,
            "scatter_": m.scatter}.items():
        setattr(Tensor, iname, _inplace_of(ifn))

    # operator dunders; Python's operators take a number on either side,
    # so the reflected forms swap the operands into the same op
    def _reflected(fn):
        def method(self, other):
            return fn(other, self)
        return method

    dunders = {
        "__add__": m.add, "__radd__": _reflected(m.add),
        "__sub__": m.subtract, "__rsub__": _reflected(m.subtract),
        "__mul__": m.multiply, "__rmul__": _reflected(m.multiply),
        "__truediv__": m.divide, "__rtruediv__": _reflected(m.divide),
        "__floordiv__": m.floor_divide,
        "__rfloordiv__": _reflected(m.floor_divide),
        "__mod__": m.mod, "__rmod__": _reflected(m.mod),
        "__pow__": m.pow, "__rpow__": _reflected(m.pow),
        "__matmul__": m.matmul, "__rmatmul__": _reflected(m.matmul),
        "__neg__": m.neg, "__abs__": m.abs,
        "__eq__": m.equal, "__ne__": m.not_equal, "__gt__": m.greater_than,
        "__ge__": m.greater_equal, "__lt__": m.less_than,
        "__le__": m.less_equal, "__invert__": m.logical_not,
        "__and__": m.bitwise_and, "__or__": m.bitwise_or,
        "__xor__": m.bitwise_xor,
    }
    for name, fn in dunders.items():
        setattr(Tensor, name, fn)

    def _T(self):
        return mp.transpose(self, list(range(self.ndim))[::-1])
    Tensor.T = property(_T)


_attach_methods()


def _late_alias():
    """The fluid-era op names (reference ``:191``): activations and losses
    of ``nn.functional``, the ``linalg`` ops, and 1:1 renames of ops
    above. Called from the package's ``__init__`` once ``nn`` is loaded
    (``nn`` imports ``ops``)."""
    from ..nn import functional as F
    mod = sys.modules[__name__]
    f_names = ["relu", "relu6", "gelu", "silu", "selu", "elu", "celu",
               "mish", "swish", "softmax", "log_softmax", "leaky_relu",
               "prelu", "maxout", "softplus", "softsign", "hardshrink",
               "softshrink", "tanhshrink", "hardsigmoid", "hardswish",
               "hardtanh", "log_sigmoid", "thresholded_relu", "grid_sample",
               "affine_grid", "interpolate", "upsample", "pixel_shuffle",
               "dropout", "label_smooth", "sigmoid_focal_loss",
               "smooth_l1_loss", "kl_div", "one_hot", "deformable_conv"]
    for n in f_names:
        if hasattr(F, n) and not hasattr(mod, n):
            setattr(mod, n, getattr(F, n))
    fluid_map = {"logsigmoid": "log_sigmoid", "hard_sigmoid": "hardsigmoid",
                 "hard_shrink": "hardshrink", "tanh_shrink": "tanhshrink",
                 "hard_swish": "hardswish", "brelu": "hardtanh",
                 "kldiv_loss": "kl_div"}
    for alias, src in fluid_map.items():
        if hasattr(F, src) and not hasattr(mod, alias):
            setattr(mod, alias, getattr(F, src))
    for n in ["cholesky", "inverse", "det", "slogdet", "qr", "svd", "eig",
              "eigh", "eigvals", "eigvalsh", "matrix_power", "matrix_rank",
              "multi_dot", "pinv", "lstsq", "solve", "triangular_solve",
              "cholesky_solve", "lu", "matrix_exp"]:
        if hasattr(linalg, n) and not hasattr(mod, n):
            setattr(mod, n, getattr(linalg, n))
    # fluid 'mul' is a flattened matrix multiply (operators/mul_op.cc)
    renames = {"arg_max": "argmax", "arg_min": "argmin", "mul": "matmul",
               "minus": "subtract", "reverse": "flip",
               "fill_constant": "full", "reduce_sum": "sum",
               "reduce_mean": "mean", "reduce_max": "max",
               "reduce_min": "min", "reduce_prod": "prod",
               "reduce_all": "all", "reduce_any": "any",
               "elementwise_add": "add", "elementwise_sub": "subtract",
               "elementwise_mul": "multiply", "elementwise_div": "divide",
               "elementwise_pow": "pow", "elementwise_max": "maximum",
               "elementwise_min": "minimum", "elementwise_mod": "mod",
               "elementwise_floordiv": "floor_divide",
               "expand_as_v2": "expand_as", "expand_v2": "expand",
               "matmul_v2": "matmul", "one_hot_v2": "one_hot",
               "p_norm": "norm", "nonzero": "nonzero"}
    for alias, src in renames.items():
        if hasattr(mod, src) and not hasattr(mod, alias):
            setattr(mod, alias, getattr(mod, src))


def kernel_launches():
    """Each hand-written kernel's launches in this process, by its
    wrapper's name (the ``launches`` counts of B1-B5's wrappers; a graph's
    replay adds the launches it captured)."""
    import importlib
    fa, pa, nms = (importlib.import_module(f"{__name__}.{m}") for m in (
        "flash_attention", "paged_attention", "custom"))
    return {w.__name__: w.launches for w in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
        fa.flash_attention_bwd_dkv, pa.paged_attention, nms.greedy_nms)}


def _soft_relu(a, threshold):
    return torch.log1p(torch.exp(torch.clamp(a, -threshold, threshold)))


def soft_relu(x, threshold=40.0, name=None):
    """``log(1 + exp(clip(x, ±threshold)))`` (reference: activation_op.h
    SoftReluFunctor)."""
    return apply("soft_relu", _soft_relu, x, threshold=threshold)
