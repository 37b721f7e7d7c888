"""The port's text datasets (``text/datasets.py``) against the JAX
package's on the CPU, item for item: ``UCIHousing``, ``Imdb``,
``Imikolov`` (NGRAM and SEQ), ``Movielens``, ``Conll05st``, ``WMT14``
and ``WMT16`` on small local archives that the test writes in the
original formats, every mode; and the refusal to download."""
import gzip
import io
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as P

WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "far", "big"]


def _add(tf, name, text):
    raw = text.encode("utf-8") if isinstance(text, str) else text
    info = tarfile.TarInfo(name)
    info.size = len(raw)
    tf.addfile(info, io.BytesIO(raw))


def _sentence(rng, n):
    return " ".join(rng.choice(WORDS, n))


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("text_data")
    rng = np.random.default_rng(0)
    np.savetxt(tmp / "housing.data", rng.random((20, 14)) * 10)
    with tarfile.open(tmp / "aclImdb.tar.gz", "w:gz") as tf:
        for split in ("train", "test"):
            for lab in ("pos", "neg"):
                for i in range(3):
                    _add(tf, f"aclImdb/{split}/{lab}/{i}_7.txt",
                         _sentence(rng, 8) + ", Great! (really)")
    with tarfile.open(tmp / "simple-examples.tgz", "w:gz") as tf:
        for split in ("train", "valid", "test"):
            _add(tf, f"./simple-examples/data/ptb.{split}.txt", "\n".join(
                _sentence(rng, int(rng.integers(3, 9))) + " <unk>"
                for _ in range(12)) + "\n")
    with zipfile.ZipFile(tmp / "ml-1m.zip", "w") as z:
        z.writestr("ml-1m/movies.dat", "\n".join(
            f"{m}::Movie {WORDS[m]} ({1990 + m})::Comedy|Drama"
            if m % 2 else f"{m}::The {WORDS[m]}::Action" for m in range(1, 6)))
        z.writestr("ml-1m/users.dat", "\n".join(
            f"{u}::{'MF'[u % 2]}::{[1, 18, 25, 35, 45, 50, 56][u % 7]}::"
            f"{u % 21}::12345" for u in range(1, 7)))
        z.writestr("ml-1m/ratings.dat", "\n".join(
            f"{int(rng.integers(1, 8))}::{int(rng.integers(1, 7))}::"
            f"{int(rng.integers(1, 6))}::97830{i}" for i in range(60)))
    conll = []
    for _ in range(4):
        for k in range(int(rng.integers(3, 7))):
            conll.append(f"{rng.choice(WORDS)} "
                         f"{rng.choice(['O', 'B-A0', 'I-A0', 'B-V', '-'])}")
        conll.append("")
    (tmp / "conll.props").write_text("\n".join(conll))
    with gzip.open(tmp / "conll.props.gz", "wt") as f:
        f.write("\n".join(conll))
    (tmp / "words.dict").write_text("\n".join(WORDS[:6]))
    (tmp / "labels.dict").write_text("\n".join(["O", "B-A0", "I-A0",
                                                "B-V"]))

    def pairs(n):
        return "\n".join(f"{_sentence(rng, 4)}\t{_sentence(rng, 5)}"
                         for _ in range(n)) + "\n"
    with tarfile.open(tmp / "wmt14.tgz", "w:gz") as tf:
        _add(tf, "wmt14/src.dict", "\n".join(["<s>", "<e>", "<unk>"]
                                             + WORDS[:7]))
        _add(tf, "wmt14/trg.dict", "\n".join(WORDS[3:]))
        _add(tf, "wmt14/train/train", pairs(6))
        _add(tf, "wmt14/test/test", pairs(3))
        _add(tf, "wmt14/gen/gen", pairs(2))
    with tarfile.open(tmp / "wmt16.tar.gz", "w:gz") as tf:
        _add(tf, "wmt16/vocab_en", "\n".join(WORDS))
        _add(tf, "wmt16/vocab_de", "\n".join(WORDS[::-1]))
        for split, n in (("train", 6), ("test", 3), ("val", 2)):
            _add(tf, f"wmt16/{split}", pairs(n))
    return tmp


def _cases(t):
    return {
        "UCIHousing_train": lambda m: m.text.UCIHousing(f"{t}/housing.data"),
        "UCIHousing_test": lambda m: m.text.UCIHousing(f"{t}/housing.data",
                                                       mode="test"),
        "Imdb_train": lambda m: m.text.Imdb(f"{t}/aclImdb.tar.gz", cutoff=1),
        "Imdb_test": lambda m: m.text.Imdb(f"{t}/aclImdb.tar.gz",
                                           mode="test", cutoff=2),
        "Imikolov_ngram": lambda m: m.text.Imikolov(
            f"{t}/simple-examples.tgz", data_type="NGRAM", window_size=3,
            min_word_freq=2),
        "Imikolov_seq_test": lambda m: m.text.Imikolov(
            f"{t}/simple-examples.tgz", data_type="SEQ", mode="test",
            min_word_freq=3),
        "Movielens_train": lambda m: m.text.Movielens(f"{t}/ml-1m.zip",
                                                      test_ratio=0.3),
        "Movielens_test": lambda m: m.text.Movielens(
            f"{t}/ml-1m.zip", mode="test", test_ratio=0.3, rand_seed=3),
        "Conll05st": lambda m: m.text.Conll05st(f"{t}/conll.props"),
        "Conll05st_gz_dicts": lambda m: m.text.Conll05st(
            f"{t}/conll.props.gz", word_dict_file=f"{t}/words.dict",
            target_dict_file=f"{t}/labels.dict"),
        "WMT14_train": lambda m: m.text.WMT14(f"{t}/wmt14.tgz", dict_size=8),
        "WMT14_gen": lambda m: m.text.WMT14(f"{t}/wmt14.tgz", mode="gen"),
        "WMT16_train": lambda m: m.text.WMT16(f"{t}/wmt16.tar.gz"),
        "WMT16_val_de": lambda m: m.text.WMT16(
            f"{t}/wmt16.tar.gz", mode="val", src_dict_size=6,
            trg_dict_size=7, lang="de"),
    }


CASES = ["UCIHousing_train", "UCIHousing_test", "Imdb_train", "Imdb_test",
         "Imikolov_ngram", "Imikolov_seq_test", "Movielens_train",
         "Movielens_test", "Conll05st", "Conll05st_gz_dicts", "WMT14_train",
         "WMT14_gen", "WMT16_train", "WMT16_val_de"]


def _flat(item):
    if isinstance(item, (tuple, list)):
        return [x for i in item for x in _flat(i)]
    return [np.asarray(item)]


@pytest.mark.parametrize("name", CASES)
def test_text_dataset_matches_jax_item_for_item(archives, name):
    make = _cases(archives)[name]
    got, ref = make(P), make(J)
    assert len(got) == len(ref) > 0
    for i in range(len(ref)):
        a, b = _flat(got[i]), _flat(ref[i])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype, (name, i)
            np.testing.assert_array_equal(x, y, err_msg=f"{name} {i}")
    for attr in ("word_idx", "word_dict", "label_dict", "src_dict",
                 "trg_dict"):
        if hasattr(ref, attr):
            assert getattr(got, attr) == getattr(ref, attr), (name, attr)


@pytest.mark.parametrize("cls", ["Imdb", "Imikolov", "Movielens",
                                 "UCIHousing", "Conll05st", "WMT14",
                                 "WMT16"])
def test_text_datasets_refuse_to_download(cls):
    with pytest.raises(RuntimeError, match="A11"):
        getattr(P.text, cls)()


def test_text_names():
    assert set(P.text.__all__) == set(J.text.__all__)
    for n in J.text.__all__:
        assert getattr(P.text, n) is getattr(P.text.datasets, n)
