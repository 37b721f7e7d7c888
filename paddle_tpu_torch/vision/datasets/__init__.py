"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets``;
reference: python/paddle/vision/datasets/): ``MNIST``, ``FashionMNIST``,
``Cifar10``/``100``, ``DatasetFolder``, ``ImageFolder``, ``VOC2012``,
``Flowers`` and ``VOCDetection``, parsed from the original file formats
(IDX for MNIST, pickled batches for CIFAR, class directories for
``DatasetFolder``) on local files only: nothing downloads
(``download=True`` without a path raises; fetching is ROADMAP queue
A11).

Decoding PNG or JPEG needs PIL, which the machine with the card does
not have: there those paths raise ``ImportError`` naming the way out
(``.npy`` arrays or a loader of one's own). ``DatasetFolder``'s ``.npy``
loader and the archive formats need NumPy only, so they run in
``io.DataLoader`` workers anywhere.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, List, Optional, Tuple

import numpy as np

from ...io import Dataset


def _no_download(name):
    raise RuntimeError(
        f"{name}: automatic download is unavailable (no network egress; "
        f"ROADMAP queue A11); pass the local file path(s) explicitly")


class MNIST(Dataset):
    """reference: vision/datasets/mnist.py MNIST (IDX ubyte files)."""

    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode.lower()
        self.transform = transform
        if image_path is None or label_path is None:
            _no_download(type(self).__name__)
        self.images = self._parse_images(image_path)
        self.labels = self._parse_labels(label_path)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    def _parse_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad MNIST image magic {magic} in {path}")
            data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return data.reshape(n, rows, cols)

    def _parse_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad MNIST label magic {magic} in {path}")
            return np.frombuffer(f.read(n), dtype=np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = int(self.labels[idx])
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img[None].astype(np.float32) / 255.0
        return img, np.array([label], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    """reference: vision/datasets/mnist.py FashionMNIST (same format)."""
    NAME = "fashion-mnist"


class Cifar10(Dataset):
    """reference: vision/datasets/cifar.py Cifar10 (python-pickle batches in
    a tar.gz)."""

    _train_members = [f"data_batch_{i}" for i in range(1, 6)]
    _test_members = ["test_batch"]

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode.lower()
        self.transform = transform
        if data_file is None:
            _no_download(type(self).__name__)
        self.data, self.labels = self._load(data_file)

    def _label_key(self):
        return b"labels"

    def _load(self, data_file):
        wanted = (self._train_members if self.mode == "train"
                  else self._test_members)
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tf:
            for member in tf.getmembers():
                base = os.path.basename(member.name)
                if base in wanted:
                    batch = pickle.load(tf.extractfile(member),
                                        encoding="bytes")
                    images.append(batch[b"data"])
                    labels.extend(batch[self._label_key()])
        if not images:
            raise ValueError(f"no {self.mode} batches found in {data_file}")
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        return data.transpose(0, 2, 3, 1), np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        img = self.data[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.transpose(2, 0, 1).astype(np.float32) / 255.0
        return img, np.array([self.labels[idx]], dtype=np.int64)

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    """reference: vision/datasets/cifar.py Cifar100."""
    _train_members = ["train"]
    _test_members = ["test"]

    def _label_key(self):
        return b"fine_labels"


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp", ".npy")


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    Image = _pil_image(path)
    with open(path, "rb") as f:
        return np.asarray(Image.open(f).convert("RGB"))


def _pil_image(path):
    """PIL's ``Image`` module, or the reference's message as an
    ``ImportError``."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"loading {path} needs PIL; save images as .npy arrays or "
            f"provide a custom loader") from e
    return Image


class DatasetFolder(Dataset):
    """reference: vision/datasets/folder.py DatasetFolder (class-per-dir)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
        if not classes:
            raise ValueError(f"no class directories found in {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            for dirpath, _, files in sorted(os.walk(os.path.join(root, c))):
                for fname in sorted(files):
                    path = os.path.join(dirpath, fname)
                    ok = (is_valid_file(path) if is_valid_file is not None
                          else fname.lower().endswith(extensions))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no valid files found under {root}")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """reference: vision/datasets/folder.py ImageFolder (flat, no labels)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or IMG_EXTENSIONS
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(dirpath, fname)
                ok = (is_valid_file(path) if is_valid_file is not None
                      else fname.lower().endswith(extensions))
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise ValueError(f"no valid files found under {root}")

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)


class VOC2012(Dataset):
    """reference: vision/datasets/voc2012.py VOC2012 — segmentation pairs
    straight out of the VOCtrainval tar (JPEGImages/*.jpg +
    SegmentationClass/*.png, split lists under ImageSets/Segmentation).

    Zero-egress environment: pass ``data_file`` (the
    VOCtrainval_11-May-2012.tar path) explicitly. The reference's mode
    quirk is kept for parity: 'train' reads the trainval list and 'test'
    reads the train list (voc2012.py MODE_FLAG_MAP).
    """

    SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
    MODE_FLAG_MAP = {"train": "trainval", "test": "train", "valid": "val"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        mode = mode.lower()
        if mode not in self.MODE_FLAG_MAP:
            raise ValueError(f"mode should be 'train', 'valid' or 'test', "
                             f"but got {mode}")
        if data_file is None:
            _no_download(type(self).__name__)
        self.transform = transform
        self.flag = self.MODE_FLAG_MAP[mode]
        self.data_tar = tarfile.open(data_file)
        self.name2mem = {m.name: m for m in self.data_tar.getmembers()}
        set_member = self.name2mem[self.SET_FILE.format(self.flag)]
        self.data, self.labels = [], []
        for line in self.data_tar.extractfile(set_member):
            name = line.strip().decode("utf-8")
            if not name:
                continue
            self.data.append(self.DATA_FILE.format(name))
            self.labels.append(self.LABEL_FILE.format(name))

    def _decode(self, member_name):
        import io as _io
        raw = self.data_tar.extractfile(self.name2mem[member_name]).read()
        if member_name.endswith(".npy"):
            return np.load(_io.BytesIO(raw))
        return np.array(_pil_image(member_name).open(_io.BytesIO(raw)))

    def __getitem__(self, idx):
        img = self._decode(self.data[idx])
        label = self._decode(self.labels[idx])
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.data)


class Flowers(Dataset):
    """reference: vision/datasets/flowers.py Flowers — 102-category Oxford
    flowers: images in a .tgz, labels + split indices in MATLAB .mat files.

    Zero-egress environment: pass ``data_file``/``label_file``/
    ``setid_file`` explicitly. The reference's train/test swap is kept for
    parity ('train' uses the official tstid split because it is larger).
    """

    MODE_FLAG_MAP = {"train": "tstid", "test": "trnid", "valid": "valid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        mode = mode.lower()
        if mode not in self.MODE_FLAG_MAP:
            raise ValueError(f"mode should be 'train', 'valid' or 'test', "
                             f"but got {mode}")
        if data_file is None or label_file is None or setid_file is None:
            _no_download(type(self).__name__)
        self.transform = transform
        import scipy.io as scio
        self.labels = scio.loadmat(label_file)["labels"][0]
        self.indexes = scio.loadmat(setid_file)[self.MODE_FLAG_MAP[mode]][0]
        # extract once next to the archive, like the reference
        self.data_path = data_file
        for suffix in (".tgz", ".tar.gz", ".tar"):
            if data_file.endswith(suffix):
                self.data_path = data_file[:-len(suffix)] + "/"
                break
        if self.data_path != data_file and not os.path.exists(
                os.path.join(self.data_path, ".extracted")):
            os.makedirs(self.data_path, exist_ok=True)
            with tarfile.open(data_file) as tf:
                tf.extractall(self.data_path, filter="data")
            with open(os.path.join(self.data_path, ".extracted"), "w"):
                pass    # sentinel: skip re-extraction next construction

    def __getitem__(self, idx):
        index = int(self.indexes[idx])
        label = np.array([self.labels[index - 1]], np.int64)
        for ext in ("jpg/image_%05d.jpg", "jpg/image_%05d.npy"):
            path = os.path.join(self.data_path, ext % index)
            if os.path.exists(path):
                break
        image = _default_loader(path)
        if self.transform is not None:
            image = self.transform(image)
        return image, label

    def __len__(self):
        return len(self.indexes)


VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


class VOCDetection(Dataset):
    """Pascal-VOC *detection* annotations out of a VOCdevkit directory —
    the ingest side of the YOLOv3 workload (reference capability:
    PaddleDetection's VOCDataSet feeding
    fluid/operators/detection/yolov3_loss_op.cc; the base repo ships only
    the segmentation reader, voc2012.py).

    Returns ``(image HWC uint8, gt_box [M, 4] float32 xyxy pixels,
    gt_label [M] int64, difficult [M] int64)`` per sample. Samples with
    zero boxes are kept (empty arrays) — padding to fixed M is the
    transform/collate layer's job (static shapes for the TPU).
    """

    def __init__(self, root, year="2012", mode="train", transform=None,
                 classes=None, keep_difficult=True, image_set=None):
        self.root = root
        self.transform = transform
        self.keep_difficult = keep_difficult
        classes = classes or VOC_CLASSES
        self.classes = tuple(classes)
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        base = os.path.join(root, f"VOC{year}")
        if not os.path.isdir(base):
            base = root     # already pointing inside VOCdevkit/VOCxxxx
        self._img_dir = os.path.join(base, "JPEGImages")
        self._ann_dir = os.path.join(base, "Annotations")
        set_file = os.path.join(base, "ImageSets", "Main",
                                (image_set or mode) + ".txt")
        if os.path.exists(set_file):
            with open(set_file) as f:
                self.ids = [l.split()[0] for l in f if l.strip()]
        else:                           # no split list: every annotation
            self.ids = sorted(os.path.splitext(f)[0]
                              for f in os.listdir(self._ann_dir)
                              if f.endswith(".xml"))
        if not self.ids:
            raise ValueError(f"VOCDetection: no samples under {base}")

    def _parse_ann(self, xml_path):
        import xml.etree.ElementTree as ET
        rootel = ET.parse(xml_path).getroot()
        boxes, labels, difficult = [], [], []
        for obj in rootel.iter("object"):
            name = obj.find("name").text.strip().lower()
            if name not in self.class_to_idx:
                continue
            diff = int((obj.find("difficult").text or 0)
                       if obj.find("difficult") is not None else 0)
            if diff and not self.keep_difficult:
                continue
            bb = obj.find("bndbox")
            # VOC pixel indices are 1-based inclusive
            box = [float(bb.find(k).text) - 1.0
                   for k in ("xmin", "ymin", "xmax", "ymax")]
            boxes.append(box)
            labels.append(self.class_to_idx[name])
            difficult.append(diff)
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int64),
                np.asarray(difficult, np.int64))

    def __getitem__(self, idx):
        name = self.ids[idx]
        for ext in (".jpg", ".npy", ".png"):
            p = os.path.join(self._img_dir, name + ext)
            if os.path.exists(p):
                break
        img = _default_loader(p)
        boxes, labels, difficult = self._parse_ann(
            os.path.join(self._ann_dir, name + ".xml"))
        sample = (img, boxes, labels, difficult)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    def __len__(self):
        return len(self.ids)


# reference exposes per-dataset submodules (vision/datasets/mnist.py etc.);
# here one module defines them all — alias the names for import parity
import sys as _sys
mnist = cifar = folder = voc2012 = flowers = _sys.modules[__name__]
