"""Synthetic datasets and metrics for the port's examples, checks and
tests (counterpart of ``persia_tpu/testing``)."""

from persia_tpu_torch.testing.datasets import (  # noqa: F401
    AVAZU_VOCABS,
    AvazuSynthetic,
    TaobaoSynthetic,
    roc_auc,
)
