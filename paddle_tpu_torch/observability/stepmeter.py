"""MFU and FLOPs per step (``train.mfu`` and the like; counterpart of
``paddle_tpu/observability/stepmeter.py``).

Two measurements meet here:

* **FLOPs per step.** The JAX package reads XLA's cost analysis of the
  compiled step without running it. The port counts a run of the step's
  plain function under ``torch.utils.flop_counter.FlopCounterMode``
  (:func:`compiled_flops`), which sees the matrix products and
  convolutions torch runs. The hand-written kernels run through
  ``ctypes`` where the counter cannot see them, so each kernel's wrapper
  adds its own work while a count runs (:func:`note_kernel_flops`, the
  formulas of PERF.md's bounds: B1 ``4*B*H*D*pairs``, B2 ``6*``, B3
  ``8*``, B4 ``4*rows*H*D``), and on the CPU runs its plain version
  hidden from the counter (:func:`uncounted`), so a step counts the same
  on both devices. The raw count is halved: one multiply-add is one FLOP,
  the convention of ``paddle.flops`` and ``bench.py``'s analytic
  constants, so MFU reads half of the usual two-FLOPs-per-MAC figure.
  Where XLA counts a loop's body once, this counts every iteration that
  runs; XLA also counts element-wise work, which this does not.
* **Wall time per step**, measured by the caller around a step that
  synchronises (the train loop's loss fetch, the decode tick's token
  fetch), so it is device and host time, not launch time.

:meth:`StepMeter.step` publishes ``<prefix>.mfu``,
``<prefix>.flops_per_step`` and the ``<prefix>.step_ms`` and
``<prefix>.mfu_pct`` histograms to a ``StatRegistry``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

from ..core import monitor as _monitor

#: dense bf16 peak FLOP/s (two FLOPs a multiply-add, the data sheets'
#: convention) by a fragment of ``torch.cuda.get_device_name``: the H100
#: SXM data sheet's 989 TFLOP/s
_PEAKS = (("H100 80GB HBM3", 989.0e12), ("H100 SXM", 989.0e12))

#: the CPU's normalizer, the JAX package's proxy
CPU_PEAK_FLOPS = 1.0e12

#: the kernel FLOPs of the count in progress, or None: one index on the
#: kernels' launch path while no count runs
_COUNT = [None]


def default_peak_flops(device=None) -> float:
    """Peak FLOP/s of ``device`` (default: the port's current device):
    ``PADDLE_TPU_PEAK_FLOPS`` if set; on CUDA the data sheet's dense
    bf16 peak of a card the table knows, else ``ValueError`` (no number
    is guessed); on the CPU the JAX package's 1 TFLOP/s proxy."""
    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    from ..core.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return CPU_PEAK_FLOPS
    import torch
    name = torch.cuda.get_device_name(dev)
    for frag, peak in _PEAKS:
        if frag in name:
            return peak
    raise ValueError(
        f"default_peak_flops: no peak is known for {name!r}; set "
        f"PADDLE_TPU_PEAK_FLOPS (FLOP/s) or pass peak_flops")


class _Tally:
    __slots__ = ("flops", "by_kernel")

    def __init__(self):
        self.flops = 0.0
        self.by_kernel: Dict[str, float] = {}


def counting() -> bool:
    """True while :func:`compiled_flops` counts."""
    return _COUNT[0] is not None


def note_kernel_flops(kernel: str, raw_flops: float):
    """Add a hand-written kernel's work (two FLOPs a multiply-add) to the
    count in progress; nothing while none runs. The tally is
    process-wide: a kernel another thread launches during a count is
    counted too."""
    t = _COUNT[0]
    if t is not None:
        t.flops += raw_flops
        t.by_kernel[kernel] = t.by_kernel.get(kernel, 0.0) + raw_flops


@contextlib.contextmanager
def uncounted():
    """Hide the ops run inside from the count in progress (a kernel's
    plain version, whose work :func:`note_kernel_flops` has added)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield


def count_flops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counter; returns
    ``(result, raw_flops, by_kernel)``: all FLOPs (two a multiply-add)
    and the kernels' share by name."""
    from torch.utils.flop_counter import FlopCounterMode
    if _COUNT[0] is not None:
        raise RuntimeError("count_flops: a count is already running")
    tally = _COUNT[0] = _Tally()
    try:
        with FlopCounterMode(display=False) as counter:
            out = fn(*args, **kwargs)
    finally:
        _COUNT[0] = None
    return out, counter.get_total_flops() + tally.flops, tally.by_kernel


def compiled_flops(fn, *args, mac_convention: bool = True,
                   **kwargs) -> Optional[float]:
    """FLOPs of one run of ``fn(*args, **kwargs)``, the hand-written
    kernels' included; None when nothing was counted. Unlike the JAX
    package's, which compiles without running, this RUNS ``fn`` once: a
    caller whose ``fn`` moves state (weights, caches, generators) keeps
    that state itself. ``mac_convention`` halves the raw count."""
    _, flops, _ = count_flops(fn, *args, **kwargs)
    if flops <= 0:
        return None
    return flops / 2.0 if mac_convention else float(flops)


class StepMeter:
    """Publishes live MFU from (FLOPs per step, measured wall per step).

    ``flops_per_step`` is set once per compiled signature (the count
    runs the step once); :meth:`step` is the per-step call: two registry
    writes and two histogram samples. The peak is ``peak_flops`` or
    :func:`default_peak_flops` of ``device``."""

    def __init__(self, peak_flops: Optional[float] = None,
                 registry: Optional["_monitor.StatRegistry"] = None,
                 prefix: str = "train", *, device=None):
        self.peak_flops = (float(peak_flops) if peak_flops
                           else default_peak_flops(device))
        self.registry = (registry if registry is not None
                         else _monitor.default_registry())
        self.prefix = prefix
        self.flops_per_step: Optional[float] = None
        self.last_mfu: Optional[float] = None

    def set_flops_per_step(self, flops: Optional[float]):
        if flops:
            self.flops_per_step = float(flops)
            self.registry.set(f"{self.prefix}.flops_per_step",
                              self.flops_per_step)

    def measure_flops(self, fn, *args, **kwargs) -> Optional[float]:
        """Count one run of ``fn`` and adopt it as ``flops_per_step``."""
        self.set_flops_per_step(compiled_flops(fn, *args, **kwargs))
        return self.flops_per_step

    def step(self, wall_s: float, flops: Optional[float] = None
             ) -> Optional[float]:
        """Record one step; returns its MFU (None while the FLOPs or the
        wall are unknown). ``flops`` overrides the per-signature value."""
        reg = self.registry
        p = self.prefix
        reg.observe(f"{p}.step_ms", wall_s * 1e3)
        f = flops if flops is not None else self.flops_per_step
        if not f or wall_s <= 0.0:
            return None
        mfu = f / wall_s / self.peak_flops
        self.last_mfu = mfu
        reg.set(f"{p}.mfu", mfu)
        reg.observe(f"{p}.mfu_pct", mfu * 100.0)
        return mfu
