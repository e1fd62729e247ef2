"""The adult-income example through the port: the reference's flagship
determinism oracle (``examples/adult_income/train.py``) with its exact
configuration — ``SyntheticClickDataset`` over VOCABS (64, 32, 16, 100, 50,
8), dim 8, ``DNN(16, 64, (64, 32))``, one parameter-server store of 2^18
rows and 4 shards with Adagrad(0.1) (seed 7), Adam(3e-3), B=128, 4 epochs
of 4096 samples, a test split of 1024.

The reference draws its dense weights from ``jax.random.PRNGKey(0)``
(``persia_tpu/ctx.py``: the first train step's ``init_state``), which no
torch generator reproduces, so the port starts from those very weights:
``adult_income_init.msgpack`` beside this module holds the reference's
initial ``params`` and ``batch_stats`` as flax writes them
(``tests/test_torch_dnn.py`` checks them against the reference and writes
the file anew when run as a script). The embedding rows start alike in
both packages (the store's seeded-by-sign init).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from persia_tpu_torch.serialization import msgpack_restore
from persia_tpu_torch.testing.synthetic import SyntheticClickDataset, roc_auc

VOCABS = (64, 32, 16, 100, 50, 8)
DIM, DENSE_DIM, EPOCHS, BATCH, TRAIN_SAMPLES, TEST_SAMPLES = 8, 5, 4, 128, 4096, 1024
DENSE_MLP, SPARSE_MLP, HIDDEN = 16, 64, (64, 32)
INIT_FILE = Path(__file__).resolve().parent / "adult_income_init.msgpack"


def reference_auc(repo_root) -> float:
    """``REPRODUCIBLE_AUC`` as the reference example pins it, read from
    ``examples/adult_income/train.py`` under ``repo_root`` (parsed, not
    imported: the example imports JAX)."""
    tree = ast.parse((Path(repo_root) / "examples" / "adult_income" / "train.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "REPRODUCIBLE_AUC" for t in node.targets):
            return float(ast.literal_eval(node.value))
    raise ValueError("examples/adult_income/train.py pins no REPRODUCIBLE_AUC")


def init_variables() -> Tuple[dict, dict]:
    """(params, batch_stats): the reference's initial DNN variables."""
    tree = msgpack_restore(INIT_FILE.read_bytes())
    return tree["params"], tree["batch_stats"]


def build_ctx(device=None):
    """The example's ``build_ctx`` through the port, on ``device`` (``cuda``
    unless given): the numpy store, bf16 compute, the weights from
    ``init_variables()``. Returns (ctx, embedding config), the ctx entered."""
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.native_store import create_store
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.weights import state_dict_from_flax

    cfg = EmbeddingConfig(slots_config={f"cat_{i}": SlotConfig(dim=DIM) for i in range(len(VOCABS))},
                          feature_index_prefix_bit=8)
    store = create_store("numpy", capacity=1 << 18, num_internal_shards=4,
                         optimizer=Adagrad(lr=0.1).config, seed=7)
    model = DNN(DENSE_DIM, [DIM] * len(VOCABS), DENSE_MLP, SPARSE_MLP, HIDDEN, torch.bfloat16, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, *init_variables()))
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), Adagrad(lr=0.1),
                   EmbeddingWorker(cfg, [store]), cfg, device=device)
    return ctx.__enter__(), cfg


def datasets():
    """(train, test) as the example makes them."""
    return (SyntheticClickDataset(num_samples=TRAIN_SAMPLES, vocab_sizes=VOCABS, seed=42),
            SyntheticClickDataset(num_samples=TEST_SAMPLES, vocab_sizes=VOCABS, seed=43))


def train(ctx, on_epoch: Optional[Callable[[int, float, float], None]] = None) -> List[Tuple[List[float], float]]:
    """The example's loop: each epoch ``train_step`` over the train split,
    then ``eval_batch`` over the test split. Returns (the epoch's losses,
    its test AUC) an epoch; ``on_epoch(epoch, mean loss, auc)`` after each."""
    train_set, test_set = datasets()
    out = []
    for epoch in range(EPOCHS):
        losses = [ctx.train_step(b)["loss"] for b in train_set.batches(batch_size=BATCH)]
        preds, labels = [], []
        for b in test_set.batches(batch_size=BATCH, requires_grad=False):
            preds.append(ctx.eval_batch(b))
            labels.append(b.labels[0].data)
        auc = roc_auc(np.concatenate(labels), np.concatenate(preds))
        out.append((losses, auc))
        if on_epoch is not None:
            on_epoch(epoch, float(np.mean(losses)), auc)
    return out
