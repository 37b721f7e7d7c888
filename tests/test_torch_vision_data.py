"""The port's vision input pipeline (``vision/transforms``,
``vision/datasets``, ``vision/image.py``) against the JAX package's on
the CPU: every ``functional`` function and every transform class on
seeded uint8 and float images (the bilinear resize antialiased when it
shrinks; the random transforms under one ``random.seed``; the detection
transforms), every dataset on local files the test writes in the
original formats, ``read_file``/``decode_jpeg``, and a 2-worker
``DataLoader`` over a ``DatasetFolder`` of ``.npy`` images run to its
end.

The JAX package resizes with ``jax.image.resize`` and the port with
NumPy copies of its weight matrices: float outputs agree at 1e-5, and
uint8 outputs are equal except where the float value lies within 1e-3
of a rounding boundary (a near tie, counted)."""
import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu.vision.transforms as JT  # noqa: E402
import paddle_tpu.vision.transforms.functional as JF  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
import paddle_tpu_torch.vision.transforms as PT  # noqa: E402
import paddle_tpu_torch.vision.transforms.functional as PF  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _img(h=23, w=31, c=3, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    return rng.random((h, w, c), dtype=np.float32)


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _tie_budget(size):
    """How many elements a uint8 resize may part by one rounding step:
    the rounding ties (an upscale's weights put many values at exactly
    .5; ``test_resize_matches_jax_image_resize`` holds each difference
    to a tie)."""
    return 2 + size // 1000


def assert_image_close(got, ref, what="", step=None):
    """Images equal: floats at 1e-5, uint8 bitwise but for a few
    one-step rounding ties; ``step`` (a float image made from a resized
    uint8 one) allows the same few elements to part by one uint8 step
    scaled by ``step``."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        what, got.shape, ref.shape, got.dtype, ref.dtype)
    if got.dtype != np.uint8:
        tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
        off = np.abs(got - ref) > tol
        if step is not None and off.any():
            d = np.abs(got - ref)[off] / step
            assert np.all(np.abs(d - 1.0) < 1e-3), (what, d)
            assert off.sum() <= _tie_budget(ref.size), (what, off.sum())
            return
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=tol,
                                   err_msg=what)
        return
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (what, diff.max())
    assert (diff > 0).sum() <= _tie_budget(diff.size), (what, diff.sum())


def _resize_pair(arr, size):
    return PF.resize(arr, size), JF.resize(arr, size)


@pytest.mark.parametrize("size", [(12, 17), (40, 50), 16, (23, 9), (7, 31)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_matches_jax_image_resize(size, dtype):
    """Shrinking (antialiased), growing, the short side to an int, one
    axis unchanged; float images at 1e-5, uint8 equal but at near ties
    (their float values within 1e-3 of .5)."""
    arr = _img(dtype=dtype)
    got, ref = _resize_pair(arr, size)
    if dtype == np.float32:
        assert_image_close(got, ref, str(size))
        return
    fgot, fref = _resize_pair(arr.astype(np.float32), size)
    assert_image_close(fgot, fref, f"float {size}")
    frac = np.abs(fref - np.floor(fref) - 0.5)
    differs = got != ref
    assert np.all(frac[differs] < 1e-3), (size, frac[differs])


def _functional_calls():
    return [
        ("to_tensor", lambda F, a: F.to_tensor(a)),
        ("to_tensor_hwc", lambda F, a: F.to_tensor(a, data_format="HWC")),
        ("normalize_chw", lambda F, a: F.normalize(
            a.transpose(2, 0, 1), [120.0, 110.0, 100.0], [60.0, 55.0, 50.0])),
        ("normalize_hwc", lambda F, a: F.normalize(
            a, [0.5, 0.4, 0.3], [0.2, 0.25, 0.3], data_format="HWC")),
        ("crop", lambda F, a: F.crop(a, 3, 5, 10, 12)),
        ("center_crop", lambda F, a: F.center_crop(a, 11)),
        ("center_crop_pair", lambda F, a: F.center_crop(a, (9, 20))),
        ("hflip", lambda F, a: F.hflip(a)),
        ("vflip", lambda F, a: F.vflip(a)),
        ("pad_int", lambda F, a: F.pad(a, 3, fill=7)),
        ("pad_pair_reflect", lambda F, a: F.pad(a, (2, 4),
                                                padding_mode="reflect")),
        ("pad_edge", lambda F, a: F.pad(a, (1, 2, 3, 4), padding_mode="edge")),
        ("pad_symmetric", lambda F, a: F.pad(a, 2,
                                             padding_mode="symmetric")),
        ("rotate", lambda F, a: F.rotate(a, 30.0)),
        ("rotate_expand_fill", lambda F, a: F.rotate(a, -75.0, expand=True,
                                                     fill=9)),
        ("rotate_center", lambda F, a: F.rotate(a, 45.0, center=(3, 4))),
        ("adjust_brightness", lambda F, a: F.adjust_brightness(a, 1.3)),
        ("adjust_contrast", lambda F, a: F.adjust_contrast(a, 0.6)),
        ("adjust_saturation", lambda F, a: F.adjust_saturation(a, 1.7)),
        ("adjust_hue", lambda F, a: F.adjust_hue(a, 0.2)),
        ("adjust_hue_negative", lambda F, a: F.adjust_hue(a, -0.45)),
        ("to_grayscale", lambda F, a: F.to_grayscale(a)),
        ("to_grayscale_3", lambda F, a: F.to_grayscale(a, 3)),
    ]


@pytest.mark.parametrize("name,call", _functional_calls(),
                         ids=[n for n, _ in _functional_calls()])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_functional_matches_jax(name, call, dtype):
    arr = _img(dtype=dtype)
    assert_image_close(call(PF, arr.copy()), call(JF, arr.copy()), name)


def _transforms():
    return [
        ("Compose", lambda T: T.Compose([T.Resize((16, 20)),
                                         T.CenterCrop(12), T.Transpose()])),
        ("ToTensor", lambda T: T.ToTensor()),
        ("Normalize", lambda T: T.Normalize(mean=[123.675, 116.28, 103.53],
                                            std=[58.395, 57.12, 57.375],
                                            data_format="HWC")),
        ("Normalize_scalar", lambda T: T.Normalize(0.5, 0.25, data_format="HWC")),
        ("Resize", lambda T: T.Resize(15)),
        ("RandomResizedCrop", lambda T: T.RandomResizedCrop(14)),
        ("RandomResizedCrop_narrow", lambda T: T.RandomResizedCrop(
            (10, 13), scale=(0.5, 0.9), ratio=(0.5, 2.0))),
        ("RandomCrop", lambda T: T.RandomCrop(10, padding=2)),
        ("RandomCrop_pad_if_needed", lambda T: T.RandomCrop(
            (30, 40), pad_if_needed=True, fill=3)),
        ("CenterCrop", lambda T: T.CenterCrop((10, 14))),
        ("RandomHorizontalFlip", lambda T: T.RandomHorizontalFlip(0.5)),
        ("RandomVerticalFlip", lambda T: T.RandomVerticalFlip(0.5)),
        ("RandomRotation", lambda T: T.RandomRotation(40, expand=True)),
        ("Pad", lambda T: T.Pad([1, 2], padding_mode="edge")),
        ("Transpose", lambda T: T.Transpose()),
        ("BrightnessTransform", lambda T: T.BrightnessTransform(0.4)),
        ("ContrastTransform", lambda T: T.ContrastTransform(0.4)),
        ("SaturationTransform", lambda T: T.SaturationTransform(0.4)),
        ("HueTransform", lambda T: T.HueTransform(0.3)),
        ("ColorJitter", lambda T: T.ColorJitter(0.3, 0.3, 0.3, 0.1)),
        ("Grayscale", lambda T: T.Grayscale(3)),
        ("RandomErasing", lambda T: T.RandomErasing(prob=1.0, value=5)),
        ("PaddleClas_train", lambda T: T.Compose([
            T.RandomResizedCrop(16), T.RandomHorizontalFlip(),
            T.Normalize(mean=[123.675, 116.28, 103.53],
                        std=[58.395, 57.12, 57.375], data_format="HWC"),
            T.Transpose()])),
    ]


@pytest.mark.parametrize("name,make", _transforms(),
                         ids=[n for n, _ in _transforms()])
def test_transform_matches_jax_under_one_seed(name, make):
    """Each transform on 6 images, the JAX package's and the port's each
    after ``random.seed(42)``: the same draws, the same images."""
    imgs = [_img(seed=s) for s in range(6)]
    out = {}
    for T in (JT, PT):
        t = make(T)
        random.seed(42)
        out[T] = [t(a.copy()) for a in imgs]
    std = np.array([58.395, 57.12, 57.375], np.float32)[:, None, None]
    for i, (g, r) in enumerate(zip(out[PT], out[JT])):
        if name == "PaddleClas_train":  # a resized uint8 image, normalised
            # back to uint8 steps: equal, or one step at a rounding tie
            g, r = _np(g) * std, _np(r) * std
            assert_image_close(g, r, f"{name} image {i}", step=1.0)
        else:
            assert_image_close(g, r, f"{name} image {i}")


def _det_sample(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    boxes = np.array([[2, 3, 20, 25], [10, 1, 39, 12], [0, 0, 5, 5]],
                     np.float32)
    return img, boxes, np.array([1, 4, 2]), np.array([0, 1, 0])


def test_det_transforms_match_jax():
    """``DetCompose`` of every detection transform on 3 samples; the
    resize ran through PIL here (``ResizeImage.backend``)."""
    out = {}
    for T in (JT, PT):
        t = T.DetCompose([T.ResizeImage(24), T.RandomFlipImage(0.5),
                          T.NormalizeBox(), T.BoxXYXY2XYWH(), T.PadBox(5),
                          T.NormalizeImage(), T.Permute()])
        out[T] = [t(_det_sample(s)) for s in range(3)]
        if T is PT:
            assert t.transforms[0].backend == "pil"
    for g, r in zip(out[PT], out[JT]):
        for a, b in zip(g, r):
            assert_image_close(np.asarray(a), np.asarray(b), "det")


def test_det_resize_numpy_branch_without_pil(monkeypatch):
    """Without PIL (the card's machine) ``ResizeImage`` takes the
    nearest-neighbour NumPy branch, as the JAX package's, and says so."""
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)
    sample = _det_sample()
    ref = JT.ResizeImage(24)
    t = PT.ResizeImage(24)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    got, want = t(sample), ref(sample)
    monkeypatch.undo()
    assert t.backend == "numpy"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- datasets on local files in their original formats -------------------------

def _write_idx(path, arr, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def _cifar_tar(path, members, label_key):
    rng = np.random.default_rng(1)
    with tarfile.open(path, "w:gz") as tf:
        for name in members:
            batch = {b"data": rng.integers(0, 256, (4, 3072)).astype(np.uint8),
                     label_key: rng.integers(0, 10, 4).tolist()}
            raw = pickle.dumps(batch)
            info = tarfile.TarInfo(name)
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))


def _add(tf, name, raw):
    info = tarfile.TarInfo(name)
    info.size = len(raw)
    tf.addfile(info, io.BytesIO(raw))


def _encoded(arr, fmt):
    buf = io.BytesIO()
    PIL.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _folder(root, n=3, classes=("cat", "dog"), ext=".npy"):
    rng = np.random.default_rng(2)
    for c in classes:
        os.makedirs(root / c, exist_ok=True)
        for i in range(n):
            arr = rng.integers(0, 256, (10 + i, 12, 3)).astype(np.uint8)
            if ext == ".npy":
                np.save(root / c / f"{i}.npy", arr)
            else:
                PIL.fromarray(arr).save(root / c / f"{i}{ext}")
    return root


def _same_items(pds, jds):
    assert len(pds) == len(jds) > 0
    for i in range(len(jds)):
        got, ref = pds[i], jds[i]
        got = got if isinstance(got, (list, tuple)) else [got]
        ref = ref if isinstance(ref, (list, tuple)) else [ref]
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(_np(a), _np(b))


def _dataset_builders(tmp):
    img = np.random.default_rng(3).integers(0, 256, (5, 6, 7)).astype(
        np.uint8)
    _write_idx(tmp / "img.gz", img, 2051)
    _write_idx(tmp / "lab.gz", np.arange(5, dtype=np.uint8), 2049)
    _cifar_tar(tmp / "c10.tar.gz", [f"cifar-10-batches-py/data_batch_{i}"
                                    for i in range(1, 6)]
               + ["cifar-10-batches-py/test_batch"], b"labels")
    _cifar_tar(tmp / "c100.tar.gz", ["cifar-100-python/train",
                                     "cifar-100-python/test"],
               b"fine_labels")
    _folder(tmp / "npy")
    _folder(tmp / "png", ext=".png")
    rng = np.random.default_rng(4)
    with tarfile.open(tmp / "voc.tar", "w") as tf:
        names = ["a", "b", "c"]
        for split, keep in (("trainval", names), ("train", names[:2]),
                            ("val", names[2:])):
            _add(tf, f"VOCdevkit/VOC2012/ImageSets/Segmentation/{split}.txt",
                 "\n".join(keep).encode())
        for n in names:
            _add(tf, f"VOCdevkit/VOC2012/JPEGImages/{n}.jpg", _encoded(
                rng.integers(0, 256, (8, 9, 3)).astype(np.uint8), "JPEG"))
            _add(tf, f"VOCdevkit/VOC2012/SegmentationClass/{n}.png",
                 _encoded(rng.integers(0, 21, (8, 9)).astype(np.uint8),
                          "PNG"))
    import scipy.io as scio
    with tarfile.open(tmp / "102flowers.tgz", "w:gz") as tf:
        for i in range(1, 5):
            _add(tf, f"jpg/image_{i:05d}.jpg", _encoded(
                rng.integers(0, 256, (7, 8, 3)).astype(np.uint8), "JPEG"))
    scio.savemat(tmp / "labels.mat", {"labels": np.array([[3, 1, 2, 5]])})
    scio.savemat(tmp / "setid.mat", {"tstid": np.array([[1, 2, 3]]),
                                     "trnid": np.array([[4]]),
                                     "valid": np.array([[2, 4]])})
    voc = tmp / "VOCdevkit" / "VOC2007"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        os.makedirs(voc / d, exist_ok=True)
    (voc / "ImageSets/Main/train.txt").write_text("000001\n000002\n")
    for k, name in enumerate(("000001", "000002")):
        np.save(voc / "JPEGImages" / f"{name}.npy",
                rng.integers(0, 256, (12, 14, 3)).astype(np.uint8))
        (voc / "Annotations" / f"{name}.xml").write_text(
            "<annotation>" + "".join(
                f"<object><name>{c}</name><difficult>{d}</difficult>"
                f"<bndbox><xmin>{2 + j}</xmin><ymin>3</ymin><xmax>{9 + j}"
                f"</xmax><ymax>11</ymax></bndbox></object>"
                for j, (c, d) in enumerate([("dog", 0), ("person", k),
                                            ("unicorn", 0)]))
            + "</annotation>")
    t = str(tmp)
    return {
        "MNIST": lambda m: m.vision.datasets.MNIST(f"{t}/img.gz",
                                                   f"{t}/lab.gz"),
        "MNIST_transform": lambda m: m.vision.datasets.MNIST(
            f"{t}/img.gz", f"{t}/lab.gz", transform=lambda a: a * 2),
        "FashionMNIST": lambda m: m.vision.datasets.FashionMNIST(
            f"{t}/img.gz", f"{t}/lab.gz", mode="test"),
        "Cifar10": lambda m: m.vision.datasets.Cifar10(f"{t}/c10.tar.gz"),
        "Cifar10_test": lambda m: m.vision.datasets.Cifar10(
            f"{t}/c10.tar.gz", mode="test"),
        "Cifar100": lambda m: m.vision.datasets.Cifar100(f"{t}/c100.tar.gz"),
        "DatasetFolder_npy": lambda m: m.vision.datasets.DatasetFolder(
            f"{t}/npy"),
        "DatasetFolder_png": lambda m: m.vision.datasets.DatasetFolder(
            f"{t}/png"),
        "ImageFolder": lambda m: m.vision.datasets.ImageFolder(f"{t}/png"),
        "VOC2012": lambda m: m.vision.datasets.VOC2012(f"{t}/voc.tar"),
        "VOC2012_valid": lambda m: m.vision.datasets.VOC2012(
            f"{t}/voc.tar", mode="valid"),
        "Flowers": lambda m: m.vision.datasets.Flowers(
            f"{t}/102flowers.tgz", f"{t}/labels.mat", f"{t}/setid.mat"),
        "Flowers_test": lambda m: m.vision.datasets.Flowers(
            f"{t}/102flowers.tgz", f"{t}/labels.mat", f"{t}/setid.mat",
            mode="test"),
        "VOCDetection": lambda m: m.vision.datasets.VOCDetection(
            f"{t}/VOCdevkit", year="2007"),
        "VOCDetection_no_difficult": lambda m: m.vision.datasets.VOCDetection(
            f"{t}/VOCdevkit", year="2007", keep_difficult=False),
    }


DATASETS = ["MNIST", "MNIST_transform", "FashionMNIST", "Cifar10",
            "Cifar10_test", "Cifar100", "DatasetFolder_npy",
            "DatasetFolder_png", "ImageFolder", "VOC2012", "VOC2012_valid",
            "Flowers", "Flowers_test", "VOCDetection",
            "VOCDetection_no_difficult"]


@pytest.fixture(scope="module")
def dataset_files(tmp_path_factory):
    return _dataset_builders(tmp_path_factory.mktemp("vision_data"))


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_matches_jax_item_for_item(dataset_files, name):
    make = dataset_files[name]
    _same_items(make(P), make(J))


def test_datasets_refuse_to_download():
    with pytest.raises(RuntimeError, match="download"):
        P.vision.datasets.MNIST()
    with pytest.raises(RuntimeError, match="download"):
        P.vision.datasets.Cifar10()


def test_decoding_without_pil_raises_import_error(tmp_path, monkeypatch):
    """The card's machine has no PIL: decoding a PNG raises ImportError
    with the reference's advice; ``.npy`` loading needs none."""
    import builtins
    root = _folder(tmp_path / "png", n=1, ext=".png")
    _folder(tmp_path / "npy", n=1)
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="needs PIL"):
        P.vision.datasets.DatasetFolder(str(root))[0]
    with pytest.raises(ImportError, match="PIL"):
        P.vision.image_load(str(root / "cat" / "0.png"))
    assert P.vision.datasets.DatasetFolder(
        str(tmp_path / "npy"))[0][0].shape == (10, 12, 3)


def test_read_file_and_decode_jpeg_match_jax(tmp_path):
    arr = np.random.default_rng(5).integers(0, 256, (9, 11, 3)).astype(
        np.uint8)
    path = tmp_path / "x.jpg"
    path.write_bytes(_encoded(arr, "JPEG"))
    for mode in ("unchanged", "gray", "rgb"):
        got = P.vision.decode_jpeg(P.vision.read_file(str(path)), mode=mode)
        ref = J.vision.decode_jpeg(J.vision.read_file(str(path)), mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))
    np.testing.assert_array_equal(
        P.vision.read_file(str(path)).numpy(),
        np.asarray(J.vision.read_file(str(path)).numpy()))
    np.testing.assert_array_equal(P.vision.image_load(str(path)),
                                  J.vision.image_load(str(path)))
    np.testing.assert_array_equal(
        P.vision.image_decode(P.vision.read_file(str(path))).numpy(),
        np.asarray(J.vision.image_decode(J.vision.read_file(
            str(path))).numpy()))


def test_namespaces_carry_the_reference_names():
    for mod, ref in ((P.vision, J.vision), (PT, JT),
                     (P.vision.datasets, J.vision.datasets),
                     (P.vision.ops, J.vision.ops), (PF, JF)):
        missing = {n for n in dir(ref) if not n.startswith("_")
                   and callable(getattr(ref, n)) and getattr(
                       getattr(ref, n), "__module__", "").startswith(
                       "paddle_tpu")} - set(dir(mod))
        assert not missing, (mod.__name__, sorted(missing))
    assert P.vision.get_image_backend() == "numpy"
    with pytest.raises(ValueError):
        P.vision.set_image_backend("opencv")


# -- the pipeline through loader workers ----------------------------------------

def test_dataloader_two_workers_over_a_dataset_folder(tmp_path):
    """PaddleClas's train transforms on a ``DatasetFolder`` of ``.npy``
    images in a 2-worker ``DataLoader`` (run to its end): float32 CHW
    batches; the first image of each worker equals the transforms run
    here under the worker's seed."""
    root = _folder(tmp_path / "train", n=6)
    tf = PT.Compose([PT.RandomResizedCrop(8), PT.RandomHorizontalFlip(),
                     PT.Normalize(mean=[123.675, 116.28, 103.53],
                                  std=[58.395, 57.12, 57.375],
                                  data_format="HWC"), PT.Transpose()])
    ds = P.vision.datasets.DatasetFolder(str(root), transform=tf)
    loader = P.io.DataLoader(ds, batch_size=3, num_workers=2, device="cpu",
                             timeout=60)
    np.random.seed(29)
    seed = np.random.RandomState(29).randint(0, 2 ** 31)
    batches = list(loader)
    assert len(batches) == 4
    x, y = batches[0]
    assert tuple(x.shape) == (3, 3, 8, 8) and x.dtype == torch.float32
    assert y.tolist() == [0, 0, 0]
    for wid, idx in ((0, 0), (1, 3)):
        random.seed(seed + wid)
        want = tf(np.load(ds.samples[idx][0]))
        np.testing.assert_allclose(batches[wid][0][0].numpy(), want,
                                   rtol=1e-6)


def test_loader_workers_draw_their_own_python_streams(tmp_path):
    """Each worker seeds Python's ``random``: two workers' first draws
    differ (the JAX package's workers replay their parent's stream)."""
    class Draws(P.io.Dataset):
        def __getitem__(self, i):
            return np.array([random.random()], np.float64)

        def __len__(self):
            return 4
    loader = P.io.DataLoader(Draws(), batch_size=2, num_workers=2,
                             device="cpu", timeout=60)
    b = [(x[0] if isinstance(x, list) else x).numpy().ravel()
         for x in loader]
    assert b[0][0] != b[1][0]
