"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s layout and names module by module
and runs on an NVIDIA H100. It imports ``torch`` and never ``jax`` or
``paddle_tpu``. Every entry point runs on CUDA unless the caller asks
for the CPU (``device="cpu"``, ``place="cpu"`` or ``set_device("cpu")``;
see :func:`resolve_device`); each kernel the JAX package wrote in
Pallas is a hand-written CUDA kernel under ``csrc/`` with a plain
PyTorch version beside it, which CPU tensors take.

``import paddle_tpu_torch as paddle`` gives the reference's top-level
names that are ported (``paddle_tpu/__init__.py:110-156``): the
:class:`Tensor` and :class:`Parameter`, ``to_tensor`` and the ported
ops (``linalg`` and the detection ops among them), ``ParamAttr``, grad
mode, ``grad``, ``PyLayer``, devices and places, dtypes and flags,
``batch`` (``reader``'s), and the subpackages (``vision``, ``text``,
``reader``, ``distributed``, ``profiler``, ``observability`` and
``sentinel`` among them). A dygraph program runs on them
as written for the reference::

    paddle.set_device("cpu")            # or leave it: CUDA
    x = paddle.to_tensor(images)
    loss = F.cross_entropy(model(x), paddle.to_tensor(labels))
    loss.backward(); opt.step(); opt.clear_grad()
"""
from torch import dtype  # noqa: F401 (paddle.dtype: the dtypes' class)

from . import (amp, autograd, distributed, framework_io, incubate, io,
               metric, nn, observability, optimizer, profiler,
               quantization, reader, regularizer, sentinel, tensor, text,
               utils, vision)
from .autograd import PyLayer, PyLayerContext
from .core import (CPUPlace, CUDAPlace, Place, TPUPlace, device_count,
                   get_device, get_flags, is_compiled_with_cuda,
                   is_compiled_with_tpu, set_device, set_flags)
from .core.autograd_engine import (enable_grad, grad, is_grad_enabled,
                                   no_grad, set_grad_enabled)
from .core.device import resolve_device, synchronize
from .core.dtypes import (bfloat16, bool_, complex64, complex128, float16,
                          float32, float64, get_default_dtype, int8, int16,
                          int32, int64, set_default_dtype, uint8)
from .core.generator import get_rng_state, seed, set_rng_state
from .core.tensor import Parameter, Tensor
from .framework_io import load, save, state_dict_from_reference
from .hapi import Model, callbacks, summary
from .reader import batch
from .io import DataLoader
from .nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .nn.layer_base import ParamAttr
from .ops import *  # noqa: F401,F403
from .ops import _late_alias, linalg
from .ops.dispatch import disable_static, enable_static, in_dygraph_mode
from .ops.linalg import cholesky, inverse, matrix_power
from .tensor import rank

_late_alias()                     # ops' fluid-era names, once nn is loaded
from .ops import reverse  # noqa: E402

in_dynamic_mode = in_dygraph_mode   # reference: paddle/__init__.py:268
bool8 = bool_
bool = bool_  # noqa: A001 (paddle.bool)

__version__ = "0.1.0"


def is_tensor(x):
    """True for a Tensor or a Parameter."""
    return isinstance(x, (Tensor, Parameter))


def is_grad_enabled_():
    return is_grad_enabled()


def disable_signal_handler():
    """API parity no-op (reference: platform/init.cc:363)."""
    return None
