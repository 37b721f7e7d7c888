"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s layout and names module by module
and runs on an NVIDIA H100. It imports ``torch`` and never ``jax`` or
``paddle_tpu``. Every entry point runs on CUDA unless the caller passes
``device="cpu"`` (see :func:`resolve_device`); each kernel the JAX package
wrote in Pallas is a hand-written CUDA kernel under ``csrc/`` with a plain
PyTorch version beside it, which CPU tensors take.
"""
from . import amp, framework_io, nn, optimizer, regularizer
from .core.device import resolve_device
from .core.generator import seed
from .framework_io import load, save, state_dict_from_reference
from .hapi import Model

__version__ = "0.1.0"

__all__ = ["resolve_device", "seed", "amp", "framework_io", "load",
           "save", "state_dict_from_reference", "Model", "nn", "optimizer",
           "regularizer"]
