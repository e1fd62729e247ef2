"""Streaming synthetic datasets shaped like the BASELINE.json configs the
port trains (counterpart of ``persia_tpu/testing/datasets.py``): Criteo
Kaggle / 1TB for DLRM, Avazu for DeepFM / DCN-v2, Taobao for DIN and the
uniform 2^63 key space of the 100T capacity harness.

Each batch is generated on demand from ``(seed, batch_index)`` with a
hidden, seeded ground-truth model, so AUC is learnable and exactly
reproducible; per-id ground-truth weights come from a splitmix64 hash of
the id. For the same arguments a batch is byte for byte the reference's
(``PersiaBatch.to_bytes``).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from persia_tpu_torch.data import (
    IDTypeFeature,
    IDTypeFeatureWithSingleID,
    Label,
    NonIDTypeFeature,
    PersiaBatch,
)
from persia_tpu_torch.embedding.hashing import splitmix64


def hash_to_unit(ids: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic per-id weight in [-1, 1) — a 2^64-entry virtual weight
    table that never gets materialized."""
    with np.errstate(over="ignore"):
        h = splitmix64(np.asarray(ids, np.uint64) ^ splitmix64(np.full(1, salt, np.uint64))[0])
    return (h >> np.uint64(11)).astype(np.float64) * (2.0 / (1 << 53)) - 1.0


def hash_to_vector(ids: np.ndarray, salt: int, dim: int) -> np.ndarray:
    """Deterministic per-id unit-ish vector (dim columns, independent salts)."""
    cols = [hash_to_unit(ids, salt * 1000003 + j) for j in range(dim)]
    v = np.stack(cols, axis=-1)
    return v / np.sqrt(dim)


class _StreamingBase:
    """Shared batching loop: subclasses implement ``_make(rng, n, batch_id)``
    returning a PersiaBatch-kwargs dict."""

    num_samples: int
    seed: int

    def batches(
        self, batch_size: int, requires_grad: bool = True, start_batch_id: int = 0
    ) -> Iterator[PersiaBatch]:
        bid = start_batch_id
        produced = 0
        while produced < self.num_samples:
            n = min(batch_size, self.num_samples - produced)
            rng = np.random.default_rng((self.seed, bid))
            kw = self._make(rng, n, bid)
            yield PersiaBatch(requires_grad=requires_grad, batch_id=bid, **kw)
            produced += n
            bid += 1

    def _make(self, rng, n, batch_id):  # pragma: no cover - abstract
        raise NotImplementedError


# Approximate public cardinalities of the 26 Criteo Kaggle categorical
# fields (exact values vary by preprocessing; the *shape* — a few huge
# slots, many small ones — is what matters for the benchmark).
CRITEO_KAGGLE_VOCABS: Sequence[int] = (
    1461, 584, 10_131_227, 2_202_608, 306, 24, 12_518, 634, 4, 93_146,
    5_684, 8_351_593, 3_195, 28, 14_993, 5_461_306, 11, 5_653, 2_174, 5,
    7_046_547, 19, 16, 286_181, 106, 142_572,
)

# Criteo-1TB (Terabyte) cardinalities are ~10-40x larger on the big slots;
# approximate shape used by public DLRM configs.
CRITEO_1TB_VOCABS: Sequence[int] = (
    45_833_188, 36_746, 17_245, 7_413, 20_243, 4, 7_114, 1_441, 63,
    29_275_261, 1_572_176, 345_138, 11, 2_209, 11_267, 128, 5, 975, 15,
    48_937_457, 17_246_239, 40_094_537, 452_104, 12_606, 105, 36,
)

CRITEO_NUM_DENSE = 13


class CriteoSynthetic(_StreamingBase):
    """Criteo-shaped click log: 13 integer-ish dense features (lognormal,
    log1p-normalized as in standard Criteo preprocessing) + 26 single-id
    categorical slots. Positive rate ~25% like the real dataset."""

    def __init__(
        self,
        num_samples: int = 65_536,
        vocab_sizes: Sequence[int] = CRITEO_KAGGLE_VOCABS,
        noise: float = 1.0,
        seed: int = 42,
        task_seed: int = 7,
    ):
        self.num_samples = num_samples
        self.vocab_sizes = list(vocab_sizes)
        self.slot_names = [f"cat_{i}" for i in range(len(vocab_sizes))]
        self.noise = noise
        self.seed = seed
        self.task_seed = task_seed
        task_rng = np.random.default_rng(task_seed)
        self._w_dense = task_rng.normal(size=CRITEO_NUM_DENSE) * 0.6
        self._bias = -1.4  # pushes base rate toward Criteo's ~25% positives

    def _make(self, rng, n, batch_id):
        raw = rng.lognormal(mean=1.0, sigma=1.5, size=(n, CRITEO_NUM_DENSE))
        dense = np.log1p(raw).astype(np.float32)
        logit = (dense - dense.mean()) @ self._w_dense + self._bias

        id_feats = []
        for k, (name, v) in enumerate(zip(self.slot_names, self.vocab_sizes)):
            # Zipf-ish skew: real Criteo ids are heavily head-concentrated
            u = rng.random(n)
            ids = np.minimum((u ** 3 * v).astype(np.uint64), np.uint64(v - 1))
            logit = logit + 1.5 * hash_to_unit(ids, self.task_seed * 131 + k)
            id_feats.append(IDTypeFeatureWithSingleID(name, ids))

        p = 1.0 / (1.0 + np.exp(-logit / max(self.noise, 1e-6)))
        labels = (rng.random(n) < p).astype(np.float32).reshape(-1, 1)
        return dict(
            id_type_features=id_feats,
            non_id_type_features=[NonIDTypeFeature(dense)],
            labels=[Label(labels)],
        )


# Avazu: 21 categorical fields (site/app/device/banner/C14-C21...) + hour.
AVAZU_VOCABS: Sequence[int] = (
    7, 7, 4_737, 7_745, 26, 8_552, 559, 36, 2_686_408, 6_729_486, 8_251,
    5, 4, 2_626, 8, 9, 435, 4, 68, 172, 60,
)


class AvazuSynthetic(_StreamingBase):
    """Avazu-shaped CTR log: 21 single-id categorical slots + the hour
    field encoded as 2 cyclical dense features."""

    def __init__(
        self,
        num_samples: int = 65_536,
        vocab_sizes: Sequence[int] = AVAZU_VOCABS,
        noise: float = 1.0,
        seed: int = 42,
        task_seed: int = 11,
    ):
        self.num_samples = num_samples
        self.vocab_sizes = list(vocab_sizes)
        self.slot_names = [f"field_{i}" for i in range(len(vocab_sizes))]
        self.noise = noise
        self.seed = seed
        self.task_seed = task_seed
        self._bias = -1.8  # Avazu positive rate ~17%

    def _make(self, rng, n, batch_id):
        hour = rng.integers(0, 24, size=n)
        dense = np.stack(
            [np.sin(2 * np.pi * hour / 24), np.cos(2 * np.pi * hour / 24)], axis=1
        ).astype(np.float32)
        logit = np.full(n, self._bias) + 0.3 * np.sin(2 * np.pi * hour / 24)

        id_feats = []
        for k, (name, v) in enumerate(zip(self.slot_names, self.vocab_sizes)):
            u = rng.random(n)
            ids = np.minimum((u ** 2.5 * v).astype(np.uint64), np.uint64(v - 1))
            logit = logit + 1.3 * hash_to_unit(ids, self.task_seed * 131 + k)
            id_feats.append(IDTypeFeatureWithSingleID(name, ids))

        p = 1.0 / (1.0 + np.exp(-logit / max(self.noise, 1e-6)))
        labels = (rng.random(n) < p).astype(np.float32).reshape(-1, 1)
        return dict(
            id_type_features=id_feats,
            non_id_type_features=[NonIDTypeFeature(dense)],
            labels=[Label(labels)],
        )


class TaobaoSynthetic(_StreamingBase):
    """Taobao-shaped user-behavior data for DIN: a candidate item + its
    category (pooled slots) and the user's behavior history (raw sequence
    slots ``hist_item``/``hist_cate``).

    Ground truth rewards history relevance: with probability ``repeat_p``
    the candidate is drawn from the user's own history (repeat-interest
    click signal the attention unit can discover); the label's logit adds a
    max-similarity term between hashed item vectors of candidate and
    history, so attention-pooling beats mean-pooling.
    """

    def __init__(
        self,
        num_samples: int = 65_536,
        item_vocab: int = 4_162_024,  # Taobao UserBehavior item count (approx)
        cate_vocab: int = 9_439,
        max_hist: int = 50,
        repeat_p: float = 0.35,
        noise: float = 0.8,
        seed: int = 42,
        task_seed: int = 13,
    ):
        self.num_samples = num_samples
        self.item_vocab = item_vocab
        self.cate_vocab = cate_vocab
        self.max_hist = max_hist
        self.repeat_p = repeat_p
        self.noise = noise
        self.seed = seed
        self.task_seed = task_seed

    def _cate_of(self, items: np.ndarray) -> np.ndarray:
        # category is a deterministic function of the item, like a catalog
        with np.errstate(over="ignore"):
            return splitmix64(items) % np.uint64(self.cate_vocab)

    def _make(self, rng, n, batch_id):
        L = self.max_hist
        hist_len = rng.integers(1, L + 1, size=n)
        # each user has an interest anchor; history items cluster around it
        anchors = rng.integers(0, self.item_vocab, size=n, dtype=np.uint64)
        hist_items: List[np.ndarray] = []
        for i in range(n):
            jitter = rng.integers(0, 1000, size=hist_len[i], dtype=np.uint64)
            with np.errstate(over="ignore"):
                items = (anchors[i] + jitter * jitter) % np.uint64(self.item_vocab)
            hist_items.append(items)

        cand = rng.integers(0, self.item_vocab, size=n, dtype=np.uint64)
        from_hist = rng.random(n) < self.repeat_p
        for i in np.nonzero(from_hist)[0]:
            cand[i] = hist_items[i][rng.integers(0, len(hist_items[i]))]

        d = 8
        v_cand = hash_to_vector(cand, self.task_seed, d)
        sim = np.empty(n)
        for i in range(n):
            v_h = hash_to_vector(hist_items[i], self.task_seed, d)
            sim[i] = (v_h @ v_cand[i]).max()
        logit = (
            3.0 * sim
            + 2.0 * from_hist.astype(np.float64)
            + 0.8 * hash_to_unit(cand, self.task_seed * 17)
            - 1.0
        )
        p = 1.0 / (1.0 + np.exp(-logit / max(self.noise, 1e-6)))
        labels = (rng.random(n) < p).astype(np.float32).reshape(-1, 1)

        hist_cates = [self._cate_of(h) for h in hist_items]
        recency = (np.minimum(hist_len, L) / L).astype(np.float32).reshape(-1, 1)
        return dict(
            id_type_features=[
                IDTypeFeatureWithSingleID("item", cand),
                IDTypeFeatureWithSingleID("cate", self._cate_of(cand)),
                IDTypeFeature("hist_item", hist_items),
                IDTypeFeature("hist_cate", hist_cates),
            ],
            non_id_type_features=[NonIDTypeFeature(recency)],
            labels=[Label(labels)],
        )


class Synthetic100T(_StreamingBase):
    """Uniform-random u64 signs over a 2^63 key space — the access pattern
    of a 100-trillion-parameter regime: effectively infinite vocabulary,
    LRU working set, every batch mostly cold ids. Labels come from a hash
    rule; this feeds the capacity/throughput harness
    (``persia_tpu_torch.testing.synthetic_100t``)."""

    def __init__(
        self,
        num_samples: int = 1 << 20,
        num_slots: int = 8,
        ids_per_sample: int = 4,
        seed: int = 42,
    ):
        self.num_samples = num_samples
        self.num_slots = num_slots
        self.ids_per_sample = ids_per_sample
        self.seed = seed

    def _make(self, rng, n, batch_id):
        id_feats = []
        logit = np.zeros(n)
        for k in range(self.num_slots):
            flat = rng.integers(0, 1 << 63, size=n * self.ids_per_sample, dtype=np.uint64)
            per = np.split(flat, n)
            logit += hash_to_unit(flat, k).reshape(n, -1).mean(axis=1)
            id_feats.append(IDTypeFeature(f"slot_{k}", per))
        dense = rng.normal(size=(n, 4)).astype(np.float32)
        labels = (logit > 0).astype(np.float32).reshape(-1, 1)
        return dict(
            id_type_features=id_feats,
            non_id_type_features=[NonIDTypeFeature(dense)],
            labels=[Label(labels)],
        )
