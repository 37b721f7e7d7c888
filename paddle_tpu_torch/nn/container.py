"""Container layers (counterpart of ``paddle_tpu/nn/container.py``):
``Sequential``, ``LayerList``, ``LayerDict`` and ``ParameterList``.

``Sequential``, ``LayerList`` and ``LayerDict`` are torch's
``Sequential``, ``ModuleList`` and ``ModuleDict`` with the port's
``Layer`` boundary: sublayers are named ``"0"``, ``"1"``, ... (or by
their keys), so state-dict keys read ``layers.0.…`` in both packages,
and the reference's ``append``, ``extend``, ``insert``, indexing and
slicing (a slice is a container of the same layers), ``keys``/
``values``/``items``, ``update``, ``pop`` and ``clear`` behave as its
own. ``ParameterList`` holds port ``Parameter``s under ``"0"``, ``"1"``,
... (a tensor appended is made one, as ``add_parameter`` does).
"""
from __future__ import annotations

import collections

from torch import nn

from .layer_base import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(nn.Sequential, Layer):
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


class LayerList(nn.ModuleList, Layer):
    """A list of sublayers (reference ``:43``)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class LayerDict(nn.ModuleDict, Layer):
    """An ordered dict of sublayers (reference ``:84``)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(Layer):
    """A list of parameters named ``"0"``, ``"1"``, ... (reference
    ``:128``)."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self
