"""Datasets of the port — ``paddle_tpu/dataset`` counterparts: the
cache helpers (common.py), the deterministic synthetic generators
(synthetic.py), MNIST and CoNLL-05. The other datasets are not ported
yet (ROADMAP.md)."""

from paddle_tpu_torch.dataset import common, conll05, mnist, synthetic

__all__ = ["common", "conll05", "mnist", "synthetic"]
