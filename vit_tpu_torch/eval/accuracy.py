"""Accuracy evaluation: top-1 / top-5 and mean top probability over a
labeled image set, batched through an ``InferenceEngine`` — counterpart
of ``vit_tpu.eval.accuracy``, with the same report.

The engine's probabilities are a device tensor; each batch's comes to the
host as float32 numpy before it is ranked, so ``np.argsort`` breaks ties
exactly as the JAX package's scoring does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class AccuracyReport:
    n: int
    top1: float
    top5: float
    mean_top_prob: float

    def as_dict(self) -> Dict[str, float]:
        return {"n": self.n, "top1": self.top1, "top5": self.top5,
                "mean_top_prob": self.mean_top_prob}


def _host(a) -> np.ndarray:
    """A numpy array of ``a``: a torch tensor (on any device) or an array."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def evaluate(
    engine,
    images,
    labels: Sequence[int],
    batch_size: Optional[int] = None,
) -> AccuracyReport:
    """Run ``engine`` over ``images`` and score against ``labels``."""
    labels = _host(labels)
    n = len(labels)
    bs = batch_size or len(images)
    return evaluate_batches(
        engine, ((images[i : i + bs], labels[i : i + bs]) for i in range(0, n, bs))
    )


def evaluate_batches(engine, batches) -> AccuracyReport:
    """Streaming form of :func:`evaluate`: consume an iterator of
    ``(images, labels)`` minibatches (numpy, or tensors from
    ``runtime.prefetch.prefetch_to_device``), accumulating counts — datasets
    larger than host memory (``io.dataset.BinShardDataset.batches``)."""
    n = 0
    top1_hits = 0
    top5_hits = 0
    top_prob_sum = 0.0
    for imgs, labels in batches:
        labels = _host(labels)
        probs = _host(engine.probabilities(imgs)).astype(np.float32)[: len(labels)]
        top5_idx = np.argsort(probs, axis=-1)[:, -5:]
        top1_idx = top5_idx[:, -1]
        n += len(labels)
        top1_hits += int((top1_idx == labels).sum())
        top5_hits += int((top5_idx == labels[:, None]).any(axis=-1).sum())
        top_prob_sum += float(probs[np.arange(len(labels)), top1_idx].sum())
    if n == 0:
        raise ValueError("no batches to evaluate")
    return AccuracyReport(n=n, top1=top1_hits / n, top5=top5_hits / n,
                          mean_top_prob=top_prob_sum / n)
