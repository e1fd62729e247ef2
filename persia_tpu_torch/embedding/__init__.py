"""Embedding subsystem: hashing/routing, parameter store, worker tier,
sparse optimizer configs (counterpart of ``persia_tpu/embedding``)."""

from persia_tpu_torch.embedding.optim import SGD, Adagrad, Adam  # noqa: F401
from persia_tpu_torch.embedding.store import EmbeddingStore  # noqa: F401
from persia_tpu_torch.embedding.worker import EmbeddingWorker  # noqa: F401
