"""The adult-income example's data in the port
(``persia_tpu_torch.testing.synthetic``): ``SyntheticClickDataset`` gives,
for the same arguments, byte for byte the reference's batches
(``PersiaBatch.to_bytes``), with and without its sequence slot and
``requires_grad``; ``roc_auc`` gives the reference's AUC, ties included."""

import numpy as np
import pytest

import persia_tpu.testing.synthetic as ref
import persia_tpu_torch.testing as port_pkg
import persia_tpu_torch.testing.synthetic as port


@pytest.mark.parametrize("seq_slot", [None, ("hist", 64, 8)])
@pytest.mark.parametrize("requires_grad", [True, False])
@pytest.mark.parametrize("seed", [42, 43])
def test_synthetic_batches_are_the_references(seq_slot, requires_grad, seed):
    kw = dict(num_samples=300, vocab_sizes=(64, 32, 16, 100, 50, 8), seq_slot=seq_slot, seed=seed)
    mine = list(port.SyntheticClickDataset(**kw).batches(128, requires_grad=requires_grad, start_batch_id=3))
    theirs = list(ref.SyntheticClickDataset(**kw).batches(128, requires_grad=requires_grad, start_batch_id=3))
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        assert a.to_bytes() == b.to_bytes()


def test_synthetic_defaults_are_the_references():
    for a, b in zip(port.SyntheticClickDataset(num_samples=256).batches(64),
                    ref.SyntheticClickDataset(num_samples=256).batches(64)):
        assert a.to_bytes() == b.to_bytes()


def test_roc_auc_is_the_references_on_ties():
    rng = np.random.default_rng(3)
    labels = (rng.random(1000) < 0.4).astype(np.float32)
    scores = np.round(rng.random(1000) + 0.5 * labels, 1)  # many ties
    assert port.roc_auc(labels, scores) == ref.roc_auc(labels, scores)
    assert port.roc_auc(labels, np.zeros(1000)) == ref.roc_auc(labels, np.zeros(1000)) == 0.5
    assert port.roc_auc(np.zeros(4), np.arange(4.0)) == 0.5
    assert port_pkg.roc_auc is port.roc_auc and port_pkg.SyntheticClickDataset is port.SyntheticClickDataset
