"""The port's synthetic datasets (``persia_tpu_torch/testing``) against
``persia_tpu.testing``: for the same arguments every batch is byte for byte
the reference's (``PersiaBatch.to_bytes``), and ``roc_auc`` gives the
reference's value."""

import numpy as np
import pytest

import persia_tpu.testing as ref
import persia_tpu_torch.testing as port


@pytest.mark.parametrize("seed", [0, 42, 4242])
def test_taobao_batches_are_the_references(seed):
    kw = dict(num_samples=3 * 50 + 7, item_vocab=20_000, max_hist=12, seed=seed)
    ours = list(port.TaobaoSynthetic(**kw).batches(50, start_batch_id=2))
    theirs = list(ref.TaobaoSynthetic(**kw).batches(50, start_batch_id=2))
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a.batch_id == b.batch_id and a.to_bytes() == b.to_bytes()


def test_taobao_default_vocab_batch_is_the_references():
    """The default vocabularies (4,162,024 items, 9,439 categories) and a
    50-long history, as the chip run trains."""
    a = next(port.TaobaoSynthetic(num_samples=64).batches(64, requires_grad=False))
    b = next(ref.TaobaoSynthetic(num_samples=64).batches(64, requires_grad=False))
    assert a.to_bytes() == b.to_bytes()


@pytest.mark.parametrize("seed", [0, 42, 4242])
def test_avazu_batches_are_the_references(seed):
    assert tuple(port.AVAZU_VOCABS) == tuple(ref.AVAZU_VOCABS)
    kw = dict(num_samples=2 * 128, seed=seed)
    for a, b in zip(port.AvazuSynthetic(**kw).batches(128), ref.AvazuSynthetic(**kw).batches(128)):
        assert a.to_bytes() == b.to_bytes()


def test_roc_auc_is_the_references():
    rng = np.random.default_rng(0)
    labels = (rng.random(500) < 0.3).astype(np.float32)
    scores = np.round(rng.random(500) + 0.3 * labels, 2)  # ties included
    assert port.roc_auc(labels, scores) == ref.roc_auc(labels, scores)
    assert port.roc_auc(np.ones(4), np.arange(4.0)) == 0.5
