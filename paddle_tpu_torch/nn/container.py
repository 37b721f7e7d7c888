"""Container layers (counterpart of ``Sequential`` in
``paddle_tpu/nn/container.py``; ``LayerList``, ``LayerDict`` and
``ParameterList`` are not ported yet, ROADMAP.md queue A3)."""
from __future__ import annotations

import collections

from torch import nn


class Sequential(nn.Sequential):
    """Sublayers named ``"0"``, ``"1"``, ... as in the JAX package, or
    by the keys of one ``OrderedDict``, or by ``(name, layer)`` pairs."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, (list, tuple)) and len(layer) == 2:
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)
