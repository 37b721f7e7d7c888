"""Seeded random generators (counterpart of ``paddle_tpu/core/generator.py``:
``seed``, ``default_generator``, ``get_rng_state``/``set_rng_state``).

The JAX package keeps one functional PRNG key and splits a subkey per
draw (``next_key``). The port keeps one ``torch.Generator`` per device,
made on first use from the last :func:`seed` (0 until one is given);
:func:`seed` re-seeds every generator made so far and NumPy's global
generator, as ``paddle.seed`` does. ``Dropout`` and
``nn.functional.dropout`` draw their masks from here, never from torch's
global default generator, so a seeded training step repeats bit for bit.
The two packages draw different bits from the same seed: tests that need
the same noise in both feed it from NumPy.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

__all__ = ["seed", "default_generator", "get_rng_state", "set_rng_state"]

_LOCK = threading.Lock()
_SEED = [0]
_GENERATORS: Dict[torch.device, torch.Generator] = {}


def _key(device) -> torch.device:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_generator(device=None) -> torch.Generator:
    """The generator of ``device`` (the CPU when None), made and seeded
    from the last :func:`seed` on first use."""
    dev = _key(device)
    with _LOCK:
        gen = _GENERATORS.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_SEED[0])
            _GENERATORS[dev] = gen
        return gen


def seed(value: int) -> torch.Generator:
    """paddle.seed: re-seed every device's generator (those made later
    start from ``value`` too) and NumPy's global generator. Returns the
    CPU generator."""
    value = int(value)
    with _LOCK:
        _SEED[0] = value
        for gen in _GENERATORS.values():
            gen.manual_seed(value)
    np.random.seed(value & 0xFFFFFFFF)
    return default_generator("cpu")


def get_rng_state() -> Dict[str, torch.Tensor]:
    """The state of every generator made so far, by device name."""
    with _LOCK:
        return {str(dev): gen.get_state()
                for dev, gen in _GENERATORS.items()}


def set_rng_state(state: Dict[str, torch.Tensor]):
    """Restore states from :func:`get_rng_state`."""
    for name, s in state.items():
        default_generator(name).set_state(s)
