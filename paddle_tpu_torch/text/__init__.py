"""paddle.text of the port (counterpart of ``paddle_tpu/text``; reference:
python/paddle/text/__init__.py): the NLP datasets ``Imdb``, ``Imikolov``,
``Movielens``, ``UCIHousing``, ``Conll05st``, ``WMT14`` and ``WMT16``
over ``io.Dataset``, from local archives (``data_file=``)."""
from .datasets import (WMT14, WMT16, Conll05st, Imdb, Imikolov, Movielens,
                       UCIHousing)

__all__ = ["Imdb", "Imikolov", "Movielens", "UCIHousing", "Conll05st",
           "WMT14", "WMT16"]
