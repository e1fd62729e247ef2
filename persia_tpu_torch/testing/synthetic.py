"""The seeded synthetic CTR task of the adult-income example (counterpart
of ``persia_tpu/testing/synthetic.py``): dense features and single-id
categorical slots (and optionally one sequence slot) with hidden
ground-truth weights, labels from a noisy logistic model; and the rank AUC.
For the same arguments a batch is byte for byte the reference's
(``PersiaBatch.to_bytes``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from persia_tpu_torch.data import IDTypeFeature, Label, NonIDTypeFeature, PersiaBatch


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney U), ties handled by average rank."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks over ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels > 0.5].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


class SyntheticClickDataset:
    """Adult-income-shaped task: ``num_dense`` dense features + categorical
    slots (single-id) + optional one sequence slot, labels from a hidden
    logistic model with noise."""

    def __init__(
        self,
        num_samples: int = 8192,
        num_dense: int = 5,
        vocab_sizes: Sequence[int] = (64, 32, 16, 100, 50, 8, 4, 300),
        seq_slot: Optional[Tuple[str, int, int]] = None,  # (name, vocab, max_len)
        noise: float = 1.0,
        seed: int = 42,
        task_seed: int = 1234,
    ):
        """``task_seed`` fixes the hidden ground-truth weights (shared between
        a train and a test split so generalization is measurable); ``seed``
        drives the sampling of features/labels."""
        task_rng = np.random.default_rng(task_seed)
        rng = np.random.default_rng(seed)
        self.num_dense = num_dense
        self.vocab_sizes = list(vocab_sizes)
        self.slot_names = [f"cat_{i}" for i in range(len(vocab_sizes))]
        self.seq_slot = seq_slot

        w_dense = task_rng.normal(size=num_dense)
        w_cats = [task_rng.normal(size=v) * 1.5 for v in self.vocab_sizes]
        w_seq = (
            task_rng.normal(size=seq_slot[1]) * 0.8 if seq_slot is not None else None
        )

        self.dense = rng.normal(size=(num_samples, num_dense)).astype(np.float32)
        logit = self.dense @ w_dense

        self.cat_ids = []
        for v, w_cat in zip(self.vocab_sizes, w_cats):
            ids = rng.integers(0, v, size=num_samples)
            logit = logit + w_cat[ids]
            self.cat_ids.append(ids.astype(np.uint64))

        if seq_slot is not None:
            _, vocab, max_len = seq_slot
            self.seq_ids: List[np.ndarray] = []
            for _ in range(num_samples):
                ln = rng.integers(0, max_len + 1)
                ids = rng.integers(0, vocab, size=ln)
                logit_add = w_seq[ids].sum() / max(np.sqrt(max(ln, 1)), 1.0)
                self.seq_ids.append(ids.astype(np.uint64))
                logit[len(self.seq_ids) - 1] += logit_add

        p = 1.0 / (1.0 + np.exp(-(logit / max(noise, 1e-6))))
        self.labels = (rng.random(num_samples) < p).astype(np.float32).reshape(-1, 1)
        self.num_samples = num_samples

    def batches(
        self, batch_size: int, requires_grad: bool = True, start_batch_id: int = 0
    ) -> Iterator[PersiaBatch]:
        bid = start_batch_id
        for lo in range(0, self.num_samples, batch_size):
            hi = min(lo + batch_size, self.num_samples)
            id_feats = [
                IDTypeFeature(
                    name, [self.cat_ids[k][i : i + 1] for i in range(lo, hi)]
                )
                for k, name in enumerate(self.slot_names)
            ]
            if self.seq_slot is not None:
                id_feats.append(
                    IDTypeFeature(self.seq_slot[0], self.seq_ids[lo:hi])
                )
            yield PersiaBatch(
                id_feats,
                non_id_type_features=[NonIDTypeFeature(self.dense[lo:hi])],
                labels=[Label(self.labels[lo:hi])],
                requires_grad=requires_grad,
                batch_id=bid,
            )
            bid += 1
