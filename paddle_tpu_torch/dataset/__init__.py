"""Datasets of the port — ``paddle_tpu/dataset`` counterparts: the
cache helpers (common.py), the deterministic synthetic generators
(synthetic.py), MNIST, CoNLL-05, the UCI 8x8 digits (digits.py,
from a copy in the package), WMT-14 (wmt14.py), MovieLens-1M
(movielens.py) and IMDB (imdb.py). The other datasets
are not ported yet (ROADMAP.md)."""

from paddle_tpu_torch.dataset import (common, conll05, digits, imdb, mnist,
                                      movielens, synthetic, wmt14)

__all__ = ["common", "conll05", "digits", "imdb", "mnist", "movielens",
           "synthetic", "wmt14"]
