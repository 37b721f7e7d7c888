"""EWMA/z-score loss-spike detection (counterpart of
``paddle_tpu/sentinel/detector.py``): host arithmetic on the loss float
the trainer or the probe already fetched, the JAX package's exactly.

The finiteness probe (``guard.py``) catches NaN and Inf; this catches a
loss that is finite but diverging. An EWMA mean and variance, with the
z-score of each new sample against them; spike samples are excluded
from the update, so a divergence cannot drag the baseline up after it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple


class LossSpikeDetector:
    """Streaming z-score detector over the scalar training loss.

    ``update(loss)`` returns ``(z, spike)``. During the first
    ``warmup_steps`` healthy samples the detector only learns the baseline
    and never reports a spike (the early loss curve is legitimately steep).
    Non-finite samples are the guard's job and are reported as a spike with
    ``z = inf`` without touching the statistics.
    """

    def __init__(self, alpha: float = 0.05, z_threshold: float = 6.0,
                 warmup_steps: int = 20, eps: float = 1e-12):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if z_threshold <= 0.0:
            raise ValueError(f"z_threshold must be > 0, got {z_threshold}")
        self.alpha = float(alpha)
        self.z_threshold = float(z_threshold)
        self.warmup_steps = int(warmup_steps)
        self.eps = float(eps)
        self.reset()

    def reset(self):
        """Forget the baseline (after a rollback the restored loss regime
        may differ from the diverged one that trained the statistics)."""
        self._mean: Optional[float] = None
        self._var = 0.0
        self._healthy_samples = 0

    # -- introspection -------------------------------------------------------
    @property
    def mean(self) -> Optional[float]:
        return self._mean

    @property
    def std(self) -> float:
        return math.sqrt(max(self._var, 0.0))

    @property
    def warmed_up(self) -> bool:
        return self._healthy_samples >= self.warmup_steps

    def zscore(self, loss: float) -> float:
        """z of ``loss`` against the current baseline (0 while unlearned)."""
        if self._mean is None:
            return 0.0
        return (float(loss) - self._mean) / math.sqrt(self._var + self.eps)

    # -- streaming update ----------------------------------------------------
    def update(self, loss: float) -> Tuple[float, bool]:
        """Feed one loss sample; returns ``(z, spike)``.

        Only an *upward* excursion is a spike — a loss dropping fast is
        good news, not divergence.
        """
        loss = float(loss)
        if not math.isfinite(loss):
            return float("inf"), True
        z = self.zscore(loss)
        spike = self.warmed_up and z > self.z_threshold
        if spike:
            return z, True
        # EW mean/variance (West-style): variance sees the pre-update delta
        if self._mean is None:
            self._mean = loss
        else:
            delta = loss - self._mean
            self._mean += self.alpha * delta
            self._var = (1.0 - self.alpha) * (self._var
                                              + self.alpha * delta * delta)
        self._healthy_samples += 1
        return z, False

    def state_dict(self) -> dict:
        return {"mean": self._mean, "var": self._var,
                "healthy_samples": self._healthy_samples}

    def load_state_dict(self, state: dict):
        self._mean = state.get("mean")
        self._var = float(state.get("var", 0.0))
        self._healthy_samples = int(state.get("healthy_samples", 0))
