"""Transform classes (counterpart of
``paddle_tpu/vision/transforms/__init__.py``; reference:
python/paddle/vision/transforms/transforms.py): the ``BaseTransform``
protocol collapsed to the image-only case, ``Compose``, and the
detection transforms of ``det_transforms``.

NumPy only, as :mod:`.functional`: they run in ``io.DataLoader``
workers. The random transforms draw from Python's ``random`` module in
the reference's order, so ``random.seed(s)`` gives the same crops,
flips and jitters in both packages.
"""
from __future__ import annotations

import numbers
import random
from typing import Sequence

import numpy as np

from . import functional as F
from .functional import (  # noqa: F401
    to_tensor, normalize, resize, crop, center_crop, hflip, vflip, pad,
    rotate, adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue,
    to_grayscale,
)
from .det_transforms import (  # noqa: F401
    DetCompose, ResizeImage, RandomFlipImage, NormalizeBox, BoxXYXY2XYWH,
    PadBox, NormalizeImage, Permute,
)


class Compose:
    """reference: transforms.py Compose."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"Compose([{inner}])"


class BaseTransform:
    """reference: transforms.py BaseTransform (keys/_apply_image protocol,
    collapsed to the image-only case the v2.0 zoo uses)."""

    def __init__(self, keys=None):
        self.keys = keys

    def _apply_image(self, img):
        raise NotImplementedError

    def __call__(self, img):
        return self._apply_image(img)

    def __repr__(self):
        return type(self).__name__ + "()"


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class RandomResizedCrop(BaseTransform):
    """reference: transforms.py RandomResizedCrop (scale/ratio sampling)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        if isinstance(size, int):
            size = (size, size)
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = F._to_numpy(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = random.uniform(*self.scale) * area
            aspect = np.exp(random.uniform(np.log(self.ratio[0]),
                                           np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                patch = F.crop(arr, top, left, ch, cw)
                return F.resize(patch, self.size, self.interpolation)
        return F.resize(F.center_crop(arr, min(h, w)), self.size,
                        self.interpolation)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(size, int):
            size = (size, size)
        self.size = size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        arr = F._to_numpy(img)
        if self.padding is not None:
            arr = F.pad(arr, self.padding, self.fill, self.padding_mode)
        th, tw = self.size
        h, w = arr.shape[:2]
        if self.pad_if_needed and (h < th or w < tw):
            # padding tuple is (left, top, right, bottom)
            arr = F.pad(arr, (max(tw - w, 0), max(th - h, 0),
                              max(tw - w, 0), max(th - h, 0)),
                        self.fill, self.padding_mode)
            h, w = arr.shape[:2]
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return F.crop(arr, top, left, th, tw)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return F.hflip(img) if random.random() < self.prob else F._to_numpy(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return F.vflip(img) if random.random() < self.prob else F._to_numpy(img)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, self.expand,
                        self.center, self.fill)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class Transpose(BaseTransform):
    """reference: transforms.py Transpose (HWC->CHW by default)."""

    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = F._to_numpy(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return F._to_numpy(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_brightness(img, factor)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return F._to_numpy(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return F._to_numpy(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return F._to_numpy(img)
        factor = random.uniform(-self.value, self.value)
        return F.adjust_hue(img, factor)


class ColorJitter(BaseTransform):
    """reference: transforms.py ColorJitter — random-order brightness/
    contrast/saturation/hue."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self.transforms[i](img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class RandomErasing(BaseTransform):
    """reference: transforms.py RandomErasing."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        arr = np.array(F._to_numpy(img))
        if random.random() >= self.prob:
            return arr
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            aspect = np.exp(random.uniform(np.log(self.ratio[0]),
                                           np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target / aspect)))
            ew = int(round(np.sqrt(target * aspect)))
            if eh < h and ew < w:
                top = random.randint(0, h - eh)
                left = random.randint(0, w - ew)
                arr[top:top + eh, left:left + ew] = self.value
                return arr
        return arr


# reference exports `paddle.vision.transforms.transforms` (submodule)
import sys as _sys
transforms = _sys.modules[__name__]
