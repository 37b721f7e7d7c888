"""paddle.save / paddle.load pickles and the weight carry between packages
(counterpart of ``paddle_tpu/framework_io.py``).

A ``paddle.save`` file is a pickle of nested dicts, lists and tuples in
which each tensor is ``{"__paddle_tensor__": True, "data": ndarray,
"stop_gradient": bool, "name": str|None}``. Both packages write and read
that format, so a state dict moves between them with no conversion: the
parameter names are the same 1:1 (``gpt.word_embeddings.weight``,
``gpt.decoder.layers.{i}.self_attn.q_proj.weight``, ...,
``gpt.decoder.norm.bias``) and so are the layouts (``Linear`` weights are
``[in, out]``); so do the vision models' and BERT's (``layer1.0.conv1.
weight`` OIHW, BN's running statistics as the buffers ``_mean`` and
``_variance``, ``encoder.layers.{i}.self_attn.q_proj.weight``), with
no renaming. Loading unpickles, so only load files you trust.
"""
from __future__ import annotations

import os
import pickle
from typing import Mapping

import numpy as np
import torch

from .core.device import DeviceLike, resolve_device


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return {"__paddle_tensor__": True,
                "data": obj.detach().cpu().numpy(),
                "stop_gradient": not obj.requires_grad, "name": None}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_saveable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_saved(obj, return_numpy: bool):
    if isinstance(obj, dict):
        if obj.get("__paddle_tensor__"):
            data = np.asarray(obj["data"])
            return data if return_numpy else torch.from_numpy(data.copy())
        return {k: _from_saved(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_saved(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol: int = 4):
    """Write ``obj`` (a state dict or any nest of tensors) in the
    ``paddle.save`` format."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, return_numpy: bool = False):
    """Read a ``paddle.save`` file; tensors come back as CPU
    ``torch.Tensor`` (or ndarrays with ``return_numpy=True``)."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return _from_saved(blob, return_numpy)


def state_dict_from_reference(arrays: Mapping[str, np.ndarray],
                              device: DeviceLike = None
                              ) -> dict:
    """The weight carry: ``{name: ndarray}`` from the JAX package (its
    ``state_dict`` as numpy, or :func:`load` with ``return_numpy=True``)
    -> ``{name: torch.Tensor}`` on ``device``, names and layouts kept."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(a, copy=True)).to(dev)
            for name, a in arrays.items()}
