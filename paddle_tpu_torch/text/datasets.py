"""Text datasets (counterpart of ``paddle_tpu/text/datasets.py``;
reference: python/paddle/text/datasets/{imdb,imikolov,movielens,
uci_housing,conll05,wmt14,wmt16}.py): ``UCIHousing``, ``Imdb``,
``Imikolov``, ``Movielens``, ``Conll05st``, ``WMT14`` and ``WMT16``,
parsed from the original archive formats given as ``data_file=``, with
the JAX package's output tuples.

Nothing downloads: without a local file the constructor raises (fetching
is ROADMAP queue A11). NumPy only, so the datasets run in
``io.DataLoader`` workers.
"""
from __future__ import annotations

import collections
import gzip
import io
import os
import re
import tarfile
import zipfile

import numpy as np

from ..io import Dataset

IMDB_URL = "https://dataset.bj.bcebos.com/imdb%2FaclImdb_v1.tar.gz"
IMDB_MD5 = "7c2ac02c03563afcf9b574c7e56c153a"
IMIKOLOV_URL = "https://dataset.bj.bcebos.com/imikolov%2Fsimple-examples.tgz"
IMIKOLOV_MD5 = "30177ea32e27c525793142b6bf2c8e2d"
UCI_URL = "http://paddlemodels.bj.bcebos.com/uci_housing/housing.data"
UCI_MD5 = "d4accdce7a25600298819f8e28e8d593"
ML_URL = "https://dataset.bj.bcebos.com/movielens%2Fml-1m.zip"
ML_MD5 = "c4d9eecfca2ab87c1945afe126590906"
CONLL_TEST_URL = "https://dataset.bj.bcebos.com/conll05st%2Fconll05st-tests.tar.gz"
CONLL_TEST_MD5 = "387719152ae52d60422c016e92a742fc"
WMT14_URL = ("https://dataset.bj.bcebos.com/wmt_shrinked_data%2F"
             "wmt14.tgz")
WMT14_MD5 = "0791583d57d5beb693b9414c5b36798c"
WMT16_URL = "https://dataset.bj.bcebos.com/wmt16%2Fwmt16.tar.gz"
WMT16_MD5 = "0c38be43600334966403524a40dcd81e"


def _check_exists_and_download(path, url, md5sum, name, download):
    """The local archive ``path``; the reference would fetch ``url`` when
    it is missing, which the port does not (no network; ROADMAP queue
    A11)."""
    if path and os.path.exists(path):
        return path
    raise RuntimeError(
        f"{name}: {path!r} does not exist and automatic download is "
        f"unavailable (ROADMAP queue A11); pass data_file= pointing at the "
        f"original archive ({url})")


class UCIHousing(Dataset):
    """reference: text/datasets/uci_housing.py — 13 features + price;
    features min/max/mean normalized over the whole table, 80/20 split."""

    def __init__(self, data_file=None, mode="train", download=True):
        assert mode in ("train", "test")
        self.mode = mode
        self.data_file = _check_exists_and_download(
            data_file, UCI_URL, UCI_MD5, "uci_housing", download)
        self._load_data()

    def _load_data(self, feature_num=14, ratio=0.8):
        data = np.loadtxt(self.data_file).reshape(-1, feature_num)
        maxs = data.max(axis=0)
        mins = data.min(axis=0)
        avgs = data.sum(axis=0) / data.shape[0]
        for i in range(feature_num - 1):
            data[:, i] = (data[:, i] - avgs[i]) / (maxs[i] - mins[i])
        offset = int(data.shape[0] * ratio)
        self.data = (data[:offset] if self.mode == "train"
                     else data[offset:]).astype(np.float32)

    def __getitem__(self, idx):
        row = self.data[idx]
        return row[:-1], row[-1:]

    def __len__(self):
        return len(self.data)


class Imdb(Dataset):
    """reference: text/datasets/imdb.py — aclImdb tar; word dict built from
    train pos+neg with frequency ``cutoff``; doc = int64 ids, label 0=pos,
    1=neg."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        assert mode in ("train", "test")
        self.mode = mode
        self.data_file = _check_exists_and_download(
            data_file, IMDB_URL, IMDB_MD5, "imdb", download)
        self.word_idx = self._build_work_dict(cutoff)
        self._load_anno()

    def _tokenize(self, pattern):
        data = []
        with tarfile.open(self.data_file) as tarf:
            for member in tarf.getmembers():
                if pattern.match(member.name):
                    f = tarf.extractfile(member)
                    text = f.read().decode("latin-1").lower()
                    data.append(text.translate(
                        str.maketrans("", "", "!\"#$%&'()*+,-./:;<=>?@"
                                      "[\\]^_`{|}~")).split())
        return data

    def _build_work_dict(self, cutoff):
        pat = re.compile(r"aclImdb/train/(pos|neg)/.*\.txt$")
        word_freq = collections.Counter()
        for doc in self._tokenize(pat):
            word_freq.update(doc)
        word_freq["<unk>"] = cutoff + 1
        items = [(w, c) for w, c in word_freq.items() if c > cutoff]
        items.sort(key=lambda x: (-x[1], x[0]))
        return {w: i for i, (w, _) in enumerate(items)}

    def _load_anno(self):
        unk = self.word_idx["<unk>"]
        self.docs, self.labels = [], []
        for lab, name in ((0, "pos"), (1, "neg")):
            pat = re.compile(
                rf"aclImdb/{self.mode}/{name}/.*\.txt$")
            for doc in self._tokenize(pat):
                self.docs.append(np.array(
                    [self.word_idx.get(w, unk) for w in doc], np.int64))
                self.labels.append(np.array([lab], np.int64))

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """reference: text/datasets/imikolov.py — PTB; NGRAM windows or SEQ
    with <s>/<e> markers; dict from train with freq > min_word_freq."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, download=True):
        assert data_type in ("NGRAM", "SEQ")
        assert mode in ("train", "test")
        self.data_type = data_type
        self.window_size = window_size
        self.mode = mode
        self.min_word_freq = min_word_freq
        self.data_file = _check_exists_and_download(
            data_file, IMIKOLOV_URL, IMIKOLOV_MD5, "imikolov", download)
        self.word_idx = self._build_work_dict(min_word_freq)
        self._load_anno()

    def _lines(self, split):
        path = f"./simple-examples/data/ptb.{split}.txt"
        with tarfile.open(self.data_file) as tarf:
            f = tarf.extractfile(path)
            for line in io.TextIOWrapper(f, encoding="utf-8"):
                yield line.strip().split()

    def _build_work_dict(self, cutoff):
        freq = collections.Counter()
        for words in self._lines("train"):
            freq.update(words)
        freq.pop("<unk>", None)
        items = [(w, c) for w, c in freq.items() if c > cutoff]
        items.sort(key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(items)}
        word_idx["<unk>"] = len(word_idx)
        return word_idx

    def _load_anno(self):
        unk = self.word_idx["<unk>"]
        self.data = []
        split = "train" if self.mode == "train" else "test"
        for words in self._lines(split):
            if self.data_type == "NGRAM":
                assert self.window_size > 0
                ws = ["<s>"] + words + ["<e>"]
                ids = [self.word_idx.get(w, unk) for w in ws]
                for i in range(self.window_size, len(ids) + 1):
                    self.data.append(
                        tuple(ids[i - self.window_size:i]))
            else:
                ids = [self.word_idx.get(w, unk)
                       for w in ["<s>"] + words + ["<e>"]]
                self.data.append((ids[:-1], ids[1:]))

    def __getitem__(self, idx):
        return tuple(np.array(x, np.int64) for x in self.data[idx]) \
            if self.data_type == "SEQ" else \
            np.array(self.data[idx], np.int64)

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """reference: text/datasets/movielens.py — ml-1m; each sample =
    (user_id, gender, age, job, movie_id, title_ids, category_ids,
    rating)."""

    AGES = [1, 18, 25, 35, 45, 50, 56]

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        assert mode in ("train", "test")
        self.mode = mode
        self.data_file = _check_exists_and_download(
            data_file, ML_URL, ML_MD5, "movielens", download)
        self._load(test_ratio, rand_seed)

    def _read(self, z, name):
        base = [n for n in z.namelist() if n.endswith(name)][0]
        return io.TextIOWrapper(z.open(base), encoding="latin-1")

    def _load(self, test_ratio, rand_seed):
        categories, titles_words = {}, {}
        movies, users = {}, {}
        with zipfile.ZipFile(self.data_file) as z:
            for line in self._read(z, "movies.dat"):
                mid, title, cats = line.strip().split("::")
                for c in cats.split("|"):
                    categories.setdefault(c, len(categories))
                words = title.lower().split()
                for w in words:
                    titles_words.setdefault(w, len(titles_words))
                movies[int(mid)] = (
                    [titles_words[w] for w in words],
                    [categories[c] for c in cats.split("|")])
            for line in self._read(z, "users.dat"):
                uid, gender, age, job, _zip = line.strip().split("::")
                users[int(uid)] = (0 if gender == "M" else 1,
                                   self.AGES.index(int(age)), int(job))
            rng = np.random.RandomState(rand_seed)
            self.data = []
            for line in self._read(z, "ratings.dat"):
                uid, mid, rating, _ts = line.strip().split("::")
                uid, mid = int(uid), int(mid)
                if mid not in movies or uid not in users:
                    continue
                is_test = rng.rand() < test_ratio
                if (self.mode == "test") != is_test:
                    continue
                g, a, j = users[uid]
                title_ids, cat_ids = movies[mid]
                self.data.append((uid, g, a, j, mid, title_ids, cat_ids,
                                  float(rating)))

    def __getitem__(self, idx):
        u, g, a, j, m, t, c, r = self.data[idx]
        return (np.array([u]), np.array([g]), np.array([a]), np.array([j]),
                np.array([m]), np.array(t), np.array(c),
                np.array([r], np.float32))

    def __len__(self):
        return len(self.data)


class Conll05st(Dataset):
    """reference: text/datasets/conll05.py — SRL test split; sample =
    (word_ids, ctx_n2/n1/0/p1/p2 ids, predicate ids, mark, label_ids).
    Simplified faithful form: (word_ids, predicate_id, label_ids) over the
    props column format (one token per line: ``word pred-label``)."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, download=True):
        self.data_file = _check_exists_and_download(
            data_file, CONLL_TEST_URL, CONLL_TEST_MD5, "conll05st",
            download)
        self.word_dict = (self._load_dict(word_dict_file)
                          if word_dict_file else None)
        self.label_dict = (self._load_dict(target_dict_file)
                           if target_dict_file else None)
        self._load()

    @staticmethod
    def _load_dict(path):
        with open(path) as f:
            return {line.strip(): i for i, line in enumerate(f)}

    def _load(self):
        """Parses a two-column (word, label) props file, sentence per
        blank-line block; builds dicts on the fly when none supplied."""
        sentences = []
        words, labels = [], []
        opener = gzip.open if self.data_file.endswith(".gz") else open
        if tarfile.is_tarfile(self.data_file):
            with tarfile.open(self.data_file) as t:
                member = [m for m in t.getmembers()
                          if m.name.endswith(".props")
                          or m.name.endswith(".txt")][0]
                lines = t.extractfile(member).read().decode().splitlines()
        else:
            with opener(self.data_file, "rt") as f:
                lines = f.read().splitlines()
        for line in lines:
            parts = line.split()
            if not parts:
                if words:
                    sentences.append((words, labels))
                    words, labels = [], []
                continue
            words.append(parts[0])
            labels.append(parts[-1])
        if words:
            sentences.append((words, labels))
        if self.word_dict is None:
            vocab = sorted({w for ws, _ in sentences for w in ws})
            self.word_dict = {w: i for i, w in enumerate(vocab)}
        if self.label_dict is None:
            labs = sorted({l for _, ls in sentences for l in ls})
            self.label_dict = {l: i for i, l in enumerate(labs)}
        self.data = []
        for ws, ls in sentences:
            wid = np.array([self.word_dict.get(w, 0) for w in ws], np.int64)
            pred = int(np.argmax([l != "-" and l != "O" for l in ls])) \
                if ls else 0
            lid = np.array([self.label_dict.get(l, 0) for l in ls], np.int64)
            self.data.append((wid, np.int64(pred), lid))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class _WMTBase(Dataset):
    """Shared parallel-corpus machinery for WMT14/WMT16: src/trg token-id
    sequences with <s>/<e>/<unk> conventions (reference: wmt14.py BOS=0,
    EOS=1, UNK=2)."""

    BOS, EOS, UNK = 0, 1, 2

    def _parse_pairs(self, src_lines, trg_lines, src_dict, trg_dict):
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        for s, t in zip(src_lines, trg_lines):
            s_ids = [src_dict.get(w, self.UNK) for w in s.split()]
            t_ids = [trg_dict.get(w, self.UNK) for w in t.split()]
            self.src_ids.append(np.array(s_ids, np.int64))
            self.trg_ids.append(np.array([self.BOS] + t_ids, np.int64))
            self.trg_ids_next.append(np.array(t_ids + [self.EOS], np.int64))

    def __getitem__(self, idx):
        return (self.src_ids[idx], self.trg_ids[idx],
                self.trg_ids_next[idx])

    def __len__(self):
        return len(self.src_ids)

    @staticmethod
    def _dict_from_lines(lines, size):
        d = {"<s>": 0, "<e>": 1, "<unk>": 2}
        for w in lines:
            w = w.strip()
            if w and w not in d and len(d) < size:
                d[w] = len(d)
        return d


class WMT14(_WMTBase):
    """reference: text/datasets/wmt14.py (shrunk en→fr corpus)."""

    def __init__(self, data_file=None, mode="train", dict_size=30000,
                 download=True):
        assert mode in ("train", "test", "gen")
        self.mode = mode
        self.data_file = _check_exists_and_download(
            data_file, WMT14_URL, WMT14_MD5, "wmt14", download)
        with tarfile.open(self.data_file) as t:
            names = t.getnames()

            def read(pred):
                ms = [n for n in names if pred(n)]
                out = []
                for m in ms:
                    out += t.extractfile(m).read().decode(
                        "utf-8", "ignore").splitlines()
                return out
            src_dict = self._dict_from_lines(
                read(lambda n: "src.dict" in n), dict_size)
            trg_dict = self._dict_from_lines(
                read(lambda n: "trg.dict" in n), dict_size)
            split = {"train": "train/", "test": "test/",
                     "gen": "gen/"}[mode]
            pairs = [n for n in names
                     if split in n and not n.endswith("/")]
            src_lines, trg_lines = [], []
            for n in sorted(pairs):
                body = t.extractfile(n).read().decode(
                    "utf-8", "ignore").splitlines()
                for line in body:
                    if "\t" in line:
                        s, tr = line.split("\t")[:2]
                        src_lines.append(s)
                        trg_lines.append(tr)
        self.src_dict, self.trg_dict = src_dict, trg_dict
        self._parse_pairs(src_lines, trg_lines, src_dict, trg_dict)


class WMT16(_WMTBase):
    """reference: text/datasets/wmt16.py (en↔de, separate dict files)."""

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=True):
        assert mode in ("train", "test", "val")
        self.mode = mode
        self.lang = lang
        self.data_file = _check_exists_and_download(
            data_file, WMT16_URL, WMT16_MD5, "wmt16", download)
        trg_lang = "de" if lang == "en" else "en"
        with tarfile.open(self.data_file) as t:
            names = t.getnames()

            def read_one(frag):
                ms = [n for n in names if frag in n]
                if not ms:
                    return []
                return t.extractfile(ms[0]).read().decode(
                    "utf-8", "ignore").splitlines()
            src_dict = self._dict_from_lines(
                read_one(f"vocab_{lang}"), src_dict_size
                if src_dict_size > 0 else 10 ** 9)
            trg_dict = self._dict_from_lines(
                read_one(f"vocab_{trg_lang}"), trg_dict_size
                if trg_dict_size > 0 else 10 ** 9)
            pairs = read_one({"train": "train", "test": "test",
                              "val": "val"}[mode])
            src_lines, trg_lines = [], []
            for line in pairs:
                if "\t" in line:
                    s, tr = line.split("\t")[:2]
                    src_lines.append(s)
                    trg_lines.append(tr)
        self.src_dict, self.trg_dict = src_dict, trg_dict
        self._parse_pairs(src_lines, trg_lines, src_dict, trg_dict)
