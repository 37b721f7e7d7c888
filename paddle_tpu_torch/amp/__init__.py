"""paddle.amp: automatic mixed precision (counterpart of
``paddle_tpu/amp/__init__.py``).

``auto_cast`` (alias ``amp_guard``) casts the inputs of each op by the
reference's lists: at O1 the white-listed ops (matrix products and
convolutions) take the low type; at O2 every op that is not black-listed
does; a black-listed op (losses, softmax, reductions) takes a low-type
input back to float32. Normalisation ops compute their statistics in
float32 inside (``nn/functional/norm.py``), so under bfloat16 they pass
their inputs through as they are, and under float16 they are black. Only
floating tensors are cast, and float64 never.

The reference casts in its op-dispatch funnel. The port has none, so each
of its functional ops that has a reference op name calls
:func:`cast_inputs` under that name first (``linear``, ``matmul_v2``,
``softmax``, ``layer_norm``, ``flash_attention`` ...). When AMP is off the
call costs one dict lookup. Tensor operators (``+``, ``*``, slicing,
reshape) do not consult it, where the reference casts them too at O2.
The casts go through ``Tensor.to``, which is differentiable: a float32
weight that an O1 op reads in bfloat16 gets its gradient back in float32.
The state is read on every call of an op. ``Model.train_batch`` keys its
compiled step by :func:`state_key` beside the input signature, so a step
captured under one state is never replayed under another; the reference's
compiled train step reads the state once, when it is first traced for an
input signature, and keeps it.

``GradScaler`` (alias ``AmpScaler``) does dynamic loss scaling, as the
float16 recipe needs; with bfloat16 it only tracks non-finite steps.
``unscale_`` unscales every gradient in place and reduces one found-inf
flag with one host sync. The port has no process-wide metrics registry,
so the reference's ``amp.found_inf_steps`` and ``amp.loss_scale`` stats
are the scaler's own ``found_inf_steps`` and ``loss_scale``.

``decorate`` casts every floating parameter and buffer of a model to the
low type at O2; master weights come from the optimizer's own
``multi_precision=True``. The reference accepts ``master_weight`` and
``save_dtype`` and never reads them; here any value other than None
raises, since ignoring it would train or save otherwise than asked.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "NORM_OPS", "cast_inputs",
           "auto_cast", "amp_guard", "enable_operator_amp",
           "disable_operator_amp", "is_auto_cast_enabled", "get_amp_dtype",
           "state_key", "decorate", "GradScaler", "AmpScaler"]

# reference: imperative/amp_auto_cast.cc default lists
WHITE_LIST = {
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "matmul_v2", "bmm", "mm", "mv", "linear", "mul",
    "einsum", "addmm",
}
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "reduce_mean",
    "reduce_sum", "logsumexp", "mean", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "bce_loss", "nll_loss",
    "cross_entropy", "p_norm", "dist", "squared_l2_norm", "cumsum",
    "mse_loss", "l1_loss", "kldiv_loss", "softmax", "log_softmax",
}
NORM_OPS = {"layer_norm", "batch_norm", "instance_norm", "group_norm",
            "norm"}

# process-wide, as the reference's
_STATE = {"enabled": False, "dtype": None, "level": "O1",
          "custom_white": set(), "custom_black": set()}

_LOW = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _convert_dtype(dtype):
    """torch.bfloat16 or torch.float16 from a torch dtype or a name
    ("bfloat16", "paddle.float16", a numpy dtype)."""
    key = str(dtype).lower().replace("paddle.", "").replace("torch.", "")
    if key not in _LOW:
        raise ValueError(f"AMP dtype {dtype!r}: bfloat16 or float16")
    return _LOW[key]


def _cast(t, low, cast_low, black):
    if not isinstance(t, torch.Tensor) or not t.is_floating_point():
        return t
    if cast_low and t.dtype != low and t.dtype != torch.float64:
        return t.to(low)
    if not cast_low and black and t.dtype == low:
        return t.to(torch.float32)
    return t


def cast_inputs(op_name: str, *tensors):
    """``tensors`` as op ``op_name`` takes them under the current AMP
    state (the reference's ``_amp_hook``), as a tuple; anything that is
    not a floating tensor (None, integer labels) passes through."""
    if not _STATE["enabled"]:
        return tensors
    low = _STATE["dtype"]
    custom_black = _STATE["custom_black"]
    white = (WHITE_LIST | _STATE["custom_white"]) - custom_black
    black = BLACK_LIST | custom_black
    if low == torch.float16:
        black = black | NORM_OPS
    elif op_name in NORM_OPS and op_name not in custom_black:
        return tensors  # bf16-neutral: f32 statistics inside the op
    if _STATE["level"] == "O2":
        cast_low = op_name not in black
    else:
        cast_low = op_name in white
    in_black = op_name in black
    return tuple(_cast(t, low, cast_low, in_black) for t in tensors)


def _set_state(enable, dtype, level, custom_white_list, custom_black_list):
    _STATE["enabled"] = bool(enable)
    _STATE["dtype"] = _convert_dtype(dtype)
    _STATE["level"] = level
    _STATE["custom_white"] = set(custom_white_list or ())
    _STATE["custom_black"] = set(custom_black_list or ())


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Cast op inputs by the lists inside the block (reference:
    amp/auto_cast.py:20; bfloat16 by default, "float16" for the recipe
    with loss scaling); the state before it comes back on exit."""
    prev = dict(_STATE)
    _set_state(enable, dtype, level, custom_white_list, custom_black_list)
    try:
        yield
    finally:
        _STATE.update(prev)


amp_guard = auto_cast


def enable_operator_amp(level="O1", dtype="bfloat16", custom_white_list=None,
                        custom_black_list=None):
    """Turn per-op casting on for the whole process, without a block."""
    _set_state(True, dtype, level, custom_white_list, custom_black_list)


def disable_operator_amp():
    _STATE["enabled"] = False


def is_auto_cast_enabled():
    return _STATE["enabled"]


def get_amp_dtype():
    """The low type of the current state (a torch dtype), or None before
    any AMP state was set."""
    return _STATE["dtype"]


def state_key():
    """A hashable key of the AMP state the ops read now: ``(False,)``
    when off, else the type, level and custom lists."""
    if not _STATE["enabled"]:
        return (False,)
    return (True, str(_STATE["dtype"]), _STATE["level"],
            tuple(sorted(_STATE["custom_white"])),
            tuple(sorted(_STATE["custom_black"])))


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """At O2, cast every floating parameter and buffer of each model to
    ``dtype`` in place (the parameter objects stay, so an optimizer built
    on them keeps them). Returns the models, and the optimizers unchanged
    when given. Master weights are the optimizer's: build Adam/AdamW with
    ``multi_precision=True``."""
    if master_weight is not None:
        raise ValueError(
            "decorate(master_weight=...) is not taken: master weights are "
            "the optimizer's own, so build it with multi_precision=True "
            "(float32 masters) or False (none)")
    if save_dtype is not None:
        raise ValueError(
            "decorate(save_dtype=...) is not taken: state dicts are saved "
            "in the parameters' own types; cast them before saving")
    low = _convert_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(low)           # floating parameters and buffers only
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)


class GradScaler:
    """Dynamic loss scaling (reference: amp/grad_scaler.py:20 ->
    fluid/dygraph/amp/loss_scaler.py:27 AmpScaler).

    ``scale(loss)`` multiplies by the scale; ``unscale_(opt)`` divides the
    gradients of ``opt``'s parameters (``p.grad``) in place and records
    whether any is not finite; ``step(opt)`` unscales if that was not done
    and steps unless a gradient was not finite; ``update()`` grows the
    scale after ``incr_every_n_steps`` finite steps in a row and shrinks it
    (to at least 1) after ``decr_every_n_nan_or_inf`` non-finite ones.
    ``found_inf_steps`` counts the non-finite unscales and ``loss_scale``
    is the scale in force (the reference's ``amp.*`` monitor stats)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # optimizers unscaled since the last update(): no double unscale,
        # no step on gradients still scaled
        self._unscaled_ids = set()
        self.found_inf_steps = 0

    @property
    def loss_scale(self) -> float:
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        if id(optimizer) in self._unscaled_ids:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer since "
                "the last update()")
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        if grads:
            # one multiply and one max-|g| per gradient, grouped by the
            # foreach kernels, then a single host sync for the flag
            torch._foreach_mul_(grads, 1.0 / self._scale)
            top = torch._foreach_norm(grads, float("inf"))
            if not bool(torch.isfinite(
                    torch.stack([t.float() for t in top])).all()):
                self._found_inf = True
                self.found_inf_steps += 1
        self._unscaled_ids.add(id(optimizer))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if id(optimizer) not in self._unscaled_ids:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        self._unscaled_ids.clear()
        if not (self._enable and self._dynamic):
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        """``scaled_loss.backward()``, :meth:`step`, :meth:`update`, as the
        reference's (so the caller does not call backward first)."""
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        """Both key sets of the reference: its own ``good_steps`` and
        ``bad_steps`` and AmpScaler's ``incr_count`` and ``decr_count``."""
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps,
                "use_dynamic_loss_scaling": self._dynamic,
                "found_inf": self._found_inf}

    def load_state_dict(self, state):
        self._scale = float(state.get("scale", self._scale))
        self._incr_ratio = state.get("incr_ratio", self._incr_ratio)
        self._decr_ratio = state.get("decr_ratio", self._decr_ratio)
        self._incr_every_n = state.get("incr_every_n_steps",
                                       self._incr_every_n)
        self._decr_every_n = state.get("decr_every_n_nan_or_inf",
                                       self._decr_every_n)
        self._good_steps = int(state.get(
            "good_steps", state.get("incr_count", self._good_steps)))
        self._bad_steps = int(state.get(
            "bad_steps", state.get("decr_count", self._bad_steps)))
        self._dynamic = bool(state.get("use_dynamic_loss_scaling",
                                       self._dynamic))
        self._found_inf = bool(state.get("found_inf", False))


AmpScaler = GradScaler
