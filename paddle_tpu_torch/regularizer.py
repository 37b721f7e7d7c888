"""Weight regularizers (counterpart of ``paddle_tpu/regularizer.py``).

A regularizer holds a coefficient. The optimizers add ``coeff * p`` to a
parameter's gradient before the update (``Optimizer._regularized_grad``),
for :class:`L1Decay` as for :class:`L2Decay`: that is what the JAX
package computes, although its L1 docstring speaks of ``sign(p)``; the
port keeps the JAX behaviour and a test pins it.
"""
from __future__ import annotations


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff


class L2Decay(WeightDecayRegularizer):
    """``grad += coeff * p``."""


class L1Decay(WeightDecayRegularizer):
    """Applied as ``grad += coeff * p``, like :class:`L2Decay` (the JAX
    package's behaviour, see the module docstring)."""
    _l1 = True


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay
