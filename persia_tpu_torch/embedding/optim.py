"""Sparse (embedding) optimizer configs (counterpart of
``persia_tpu/embedding/optim.py``), as far as the store needs them: the
width of the optimizer state kept after each embedding (``[emb | state]``)
and its initial value. The update math comes with the training slice."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

OPTIMIZER_SGD = 0
OPTIMIZER_ADAGRAD = 1
OPTIMIZER_ADAM = 2


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer description registered to every parameter-server replica."""

    kind: int
    lr: float = 0.01
    weight_decay: float = 0.0
    # adagrad
    initialization: float = 0.01
    g_square_momentum: float = 1.0
    eps: float = 1e-10
    vectorwise_shared: bool = False
    # adam
    beta1: float = 0.9
    beta2: float = 0.999

    def state_dim(self, dim: int) -> int:
        if self.kind == OPTIMIZER_SGD:
            return 0
        if self.kind == OPTIMIZER_ADAGRAD:
            return 1 if self.vectorwise_shared else dim
        if self.kind == OPTIMIZER_ADAM:
            return 2 * dim
        raise ValueError(f"unknown optimizer kind {self.kind}")

    def init_state(self, dim: int) -> np.ndarray:
        n = self.state_dim(dim)
        if self.kind == OPTIMIZER_ADAGRAD:
            return np.full(n, self.initialization, dtype=np.float32)
        return np.zeros(n, dtype=np.float32)


class SGD:
    """User-facing sparse SGD."""

    def __init__(self, lr: float = 0.01, weight_decay: float = 0.0):
        self.config = OptimizerConfig(OPTIMIZER_SGD, lr=lr, weight_decay=weight_decay)


class Adagrad:
    """User-facing sparse Adagrad (``vectorwise_shared`` shares one
    accumulator per embedding vector)."""

    def __init__(
        self,
        lr: float = 0.01,
        weight_decay: float = 0.0,
        initialization: float = 0.01,
        g_square_momentum: float = 1.0,
        eps: float = 1e-10,
        vectorwise_shared: bool = False,
    ):
        self.config = OptimizerConfig(
            OPTIMIZER_ADAGRAD,
            lr=lr,
            weight_decay=weight_decay,
            initialization=initialization,
            g_square_momentum=g_square_momentum,
            eps=eps,
            vectorwise_shared=vectorwise_shared,
        )


class Adam:
    """User-facing sparse Adam."""

    def __init__(
        self,
        lr: float = 0.001,
        betas: Tuple[float, float] = (0.9, 0.999),
        weight_decay: float = 0.0,
        eps: float = 1e-8,
    ):
        self.config = OptimizerConfig(
            OPTIMIZER_ADAM,
            lr=lr,
            beta1=betas[0],
            beta2=betas[1],
            weight_decay=weight_decay,
            eps=eps,
        )
