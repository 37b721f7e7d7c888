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

:func:`draw` is the one door every random mask of the port goes through,
so that activation recompute (``distributed/fleet/utils.py``) can keep a
block's draws from its forward (:func:`keeping_draws`) and hand the same
tensors to its re-run in the backward (:func:`reusing_draws`), which then
draws nothing. The JAX package gets the same masks by passing the same
keys to the re-run.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List

import numpy as np
import torch

__all__ = ["seed", "default_generator", "get_rng_state", "set_rng_state",
           "draw", "keeping_draws", "reusing_draws"]

_LOCK = threading.Lock()
_SEED = [0]
_GENERATORS: Dict[torch.device, torch.Generator] = {}
#: the draws list of the innermost keeping_draws / reusing_draws block
#: of this thread, with the next position to reuse (None when keeping)
_DRAWS = threading.local()


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


def draw(make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()``, a tensor drawn from a generator. Inside
    :func:`keeping_draws` it is also appended to the block's list; inside
    :func:`reusing_draws` the next tensor of the list is returned instead
    and nothing is drawn."""
    state = getattr(_DRAWS, "state", None)
    if state is None:
        return make()
    draws, pos = state
    if pos is None:
        t = make()
        draws.append(t)
        return t
    if pos[0] >= len(draws):
        raise RuntimeError("recompute: the re-run draws more random masks "
                           "than its forward did")
    t = draws[pos[0]]
    pos[0] += 1
    return t


@contextlib.contextmanager
def keeping_draws(draws: List[torch.Tensor]):
    """Append every :func:`draw` of this thread inside to ``draws``."""
    prev = getattr(_DRAWS, "state", None)
    _DRAWS.state = (draws, None)
    try:
        yield
    finally:
        _DRAWS.state = prev


@contextlib.contextmanager
def reusing_draws(draws: List[torch.Tensor]):
    """Answer the :func:`draw` calls of this thread inside with
    ``draws``, in order, from the first."""
    prev = getattr(_DRAWS, "state", None)
    _DRAWS.state = (draws, [0])
    try:
        yield
    finally:
        _DRAWS.state = prev
