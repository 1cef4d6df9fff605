"""Datasets of the port — ``paddle_tpu/dataset`` counterparts, every
one of them: the cache helpers (common.py), the deterministic synthetic
generators (synthetic.py), MNIST, CIFAR-10/100, UCI housing, IMDB,
imikolov (PTB n-grams), CoNLL-05, Oxford flowers, MovieLens-1M,
MQ2007, sentiment, VOC2012 and WMT-14, and the UCI 8x8 digits
(digits.py, from a copy in the package). Each reads the real file
under ``DATA_HOME`` where it is present, else the JAX package's seeded
synthetic fallback, drawn in the same order. Each ``convert`` writes
its splits as the JAX package's recordio shards (common.convert)."""

from paddle_tpu_torch.dataset import (cifar, common, conll05, digits, flowers,
                                      imdb, imikolov, mnist, movielens, mq2007,
                                      sentiment, synthetic, uci_housing,
                                      voc2012, wmt14)

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "imikolov", "conll05",
           "flowers", "movielens", "mq2007", "sentiment", "voc2012",
           "wmt14", "digits", "synthetic", "common"]
