"""Online/continuous training — the loop the 2017 pserver ran in prod.

Serving journals every ranked request (``embed/sample`` records: the
feature ids it looked up, and the click/label once feedback lands);
this module re-ingests that journal as a TRAINING stream through the
self-healing reader pipeline (:func:`reader.pipeline.supervised` —
crashed-worker restart, error-budget quarantine, stall watchdog) and
pushes the resulting sparse gradients back into the LIVE store through
the async :class:`EmbeddingClient` — while the same shards keep serving
lookups. Freshness loop closed: a click at time t reshapes the rows the
very next request gathers.

The model is the classic linear-over-embeddings CTR ranker:
``p = sigmoid(sum_i row(id_i) . w)`` — each sample's gradient touches
exactly its own rows (d row_i = (p - y) * w), which is what makes the
updates sparse and the pserver pattern work.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.embed.shard import _emit_embed

__all__ = ["log_sample", "journal_sample_reader", "OnlineTrainer",
           "run_online"]


def log_sample(ids: Sequence[int], label: float, **fields):
    """Journal one serving sample (domain ``embed``, kind ``sample``) —
    the feedback record the online loop trains from. Wire it as
    ``InferenceServer(sample_log=...)`` via :func:`serving_sample_log`,
    or call it directly where the label (click) becomes known."""
    _emit_embed("sample", ids=[int(i) for i in np.asarray(ids).reshape(-1)
                               if int(i) >= 0],
                label=float(label), **fields)


def serving_sample_log(label_fn: Optional[Callable] = None):
    """Adapter for ``InferenceServer(sample_log=...)``: journals every
    served batch's integer feature ids as ``embed/sample`` records.
    ``label_fn(sample) -> float`` supplies the label (default 0.0 — a
    served-not-yet-clicked impression; the click pipeline rewrites it
    by journaling the sample again with label 1.0)."""
    def hook(samples):
        for s in samples:
            ids = np.asarray(s[0] if isinstance(s, (tuple, list)) else s)
            label = float(label_fn(s)) if label_fn is not None else 0.0
            log_sample(ids.reshape(-1), label)
    return hook


def journal_sample_reader(path: str, *, domain: str = "embed",
                          kind: str = "sample"):
    """A v2 Reader factory (zero-arg callable -> iterable) over the
    journal's sample records — feed it to ``supervised()`` like any
    other source; rotated segments are spanned by ``read_journal``."""
    from paddle_tpu_torch.obs.events import read_journal

    def reader():
        for rec in read_journal(path, domain=domain, kind=kind):
            yield (np.asarray(rec["ids"], np.int64),
                   float(rec.get("label", 0.0)))
    return reader


class OnlineTrainer:
    """Linear-over-embeddings CTR model against a live sharded table.

    Forward gathers each batch's rows through the client (so it sees
    every peer's pushes within the staleness bound); backward pushes
    row gradients asynchronously. The small dense ``w`` is local to
    this trainer — the 2017 split exactly: sparse parameters on the
    pserver, dense ones with the trainer."""

    def __init__(self, client, *, lr: float = 0.1, dense_lr: float = 0.05,
                 seed: int = 0):
        self.client = client
        self.lr = float(lr)
        self.dense_lr = float(dense_lr)
        rng = np.random.default_rng(seed)
        self.w = rng.normal(0.0, 0.1, client.dim).astype(np.float32)
        self.steps = 0
        self.samples = 0

    def step(self, batch: Sequence) -> float:
        """One update from ``batch`` = [(ids, label), ...]. Returns the
        mean logloss BEFORE the update."""
        all_ids = np.unique(np.concatenate(
            [np.asarray(ids, np.int64).reshape(-1) for ids, _ in batch]))
        rows = self.client.gather(all_ids)
        index = {int(k): i for i, k in enumerate(all_ids.tolist())}
        loss = 0.0
        g_rows = np.zeros_like(rows)
        g_w = np.zeros_like(self.w)
        for ids, label in batch:
            idx = [index[int(i)] for i in np.asarray(ids).reshape(-1)
                   if int(i) >= 0]
            x = rows[idx]                        # [k, dim]
            score = float(x.sum(axis=0) @ self.w)
            p = 1.0 / (1.0 + np.exp(-score))
            eps = 1e-7
            loss += -(label * np.log(p + eps)
                      + (1.0 - label) * np.log(1.0 - p + eps))
            err = np.float32(p - label)
            g_rows[idx] += err * self.w          # d loss / d row_i
            g_w += err * x.sum(axis=0)           # d loss / d w
        self.client.push(all_ids, g_rows / len(batch), lr=self.lr)
        self.w -= self.dense_lr * (g_w / len(batch))
        self.steps += 1
        self.samples += len(batch)
        return float(loss / len(batch))


def run_online(client, reader: Callable, *, batch_size: int = 8,
               lr: float = 0.1, max_batches: Optional[int] = None,
               num_workers: int = 2, seed: int = 0,
               trainer: Optional[OnlineTrainer] = None) -> Dict[str, Any]:
    """Drive the continuous loop: journal reader -> self-healing
    pipeline -> sparse updates against the live store. Returns stats
    (batches, samples, last/mean loss, client counters). The pipeline
    is the SAME supervised prefetcher training uses — a crashed decode
    worker or a corrupt journal record quarantines instead of stopping
    the freshness loop."""
    from paddle_tpu_torch.reader.pipeline import supervised

    trainer = trainer or OnlineTrainer(client, lr=lr, seed=seed)
    pipe = supervised(reader, num_workers=num_workers,
                      name="embed-online")
    losses: List[float] = []
    batch: List = []
    batches = 0
    t0 = time.perf_counter()
    for sample in pipe():
        batch.append(sample)
        if len(batch) < batch_size:
            continue
        losses.append(trainer.step(batch))
        batch = []
        batches += 1
        if max_batches is not None and batches >= max_batches:
            break
    if batch and (max_batches is None or batches < max_batches):
        losses.append(trainer.step(batch))
        batches += 1
    client.flush()
    elapsed = time.perf_counter() - t0
    stats = {"batches": batches, "samples": trainer.samples,
             "elapsed_s": round(elapsed, 4),
             "loss_last": losses[-1] if losses else None,
             "loss_mean": float(np.mean(losses)) if losses else None,
             "client": client.stats()}
    _emit_embed("online_pass", batches=batches,
                samples=trainer.samples,
                loss_last=stats["loss_last"])
    return stats
