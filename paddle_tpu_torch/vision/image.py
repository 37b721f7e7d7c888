"""Image file IO (counterpart of ``paddle_tpu/vision/image.py``;
reference: operators/read_file_op.cc and decode_jpeg_op.cc, which decode
with nvjpeg on the GPU). Here decoding is on the host through PIL, since
it feeds the input pipeline. The machine with the card has no PIL: there
:func:`decode_jpeg`, :func:`image_load` and :func:`image_decode` raise
``ImportError``; :func:`read_file` needs none.
"""
from __future__ import annotations

import io as _io

import numpy as np

from ..core.tensor import Tensor
from ..ops.creation import to_tensor

__all__ = ["image_load", "image_decode", "read_file", "decode_jpeg"]


def _pil(what):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what} needs PIL, which is not installed; "
                          f"keep images as .npy arrays instead") from e
    return Image


def read_file(path, name=None):
    """The file's bytes as a uint8 Tensor."""
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    return to_tensor(data)


def decode_jpeg(x, mode="unchanged", name=None):
    """An encoded image's bytes -> CHW uint8 Tensor; ``mode`` is
    ``unchanged``, ``gray`` or ``rgb``."""
    Image = _pil("decode_jpeg")
    raw = x.numpy() if isinstance(x, Tensor) else np.asarray(x)
    img = Image.open(_io.BytesIO(raw.tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None, :, :] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return to_tensor(np.ascontiguousarray(arr))


def image_load(path, backend=None):
    """An image file as an HWC RGB array (the NumPy backend)."""
    Image = _pil("image_load")
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def image_decode(x, mode="rgb"):
    """:func:`decode_jpeg` under the vision namespace."""
    return decode_jpeg(x, mode=mode)
