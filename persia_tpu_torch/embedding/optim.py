"""Sparse (embedding) optimizers (counterpart of
``persia_tpu/embedding/optim.py``): the configs registered to every
parameter-server replica, the width and initial value of the optimizer
state kept after each embedding (``[emb | state]``), and the per-entry
update. The update is numpy in the reference's operation order, so the
entries it writes equal the reference's bit for bit."""

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

    def update_dense(
        self,
        emb: np.ndarray,
        state: np.ndarray,
        grad: np.ndarray,
        batch_state: Tuple[float, float],
    ) -> None:
        """In-place update of one entry. ``batch_state`` = accumulated
        (beta1^t, beta2^t) for Adam, kept per feature group and advanced
        once per gradient batch."""
        if self.kind == OPTIMIZER_SGD:
            if self.weight_decay:
                grad = grad + self.weight_decay * emb
            emb -= self.lr * grad
        elif self.kind == OPTIMIZER_ADAGRAD:
            if self.weight_decay:
                grad = grad + self.weight_decay * emb
            if self.vectorwise_shared:
                g2 = float(np.mean(grad * grad))
                state[0] = state[0] * self.g_square_momentum + g2
                emb -= self.lr * grad / np.sqrt(state[0] + self.eps)
            else:
                state *= self.g_square_momentum
                state += (grad * grad).astype(np.float32)
                emb -= self.lr * grad / np.sqrt(state + self.eps)
        elif self.kind == OPTIMIZER_ADAM:
            dim = emb.shape[0]
            m = state[:dim]
            v = state[dim:]
            m *= self.beta1
            m += (1.0 - self.beta1) * grad
            v *= self.beta2
            v += (1.0 - self.beta2) * grad * grad
            beta1_pow, beta2_pow = batch_state
            m_hat = m / (1.0 - beta1_pow)
            v_hat = v / (1.0 - beta2_pow)
            emb -= self.lr * m_hat / (np.sqrt(v_hat) + self.eps)
        else:
            raise ValueError(f"unknown optimizer kind {self.kind}")

    def advance_batch_state(self, prev: Tuple[float, float]) -> Tuple[float, float]:
        if self.kind != OPTIMIZER_ADAM:
            return prev
        return (prev[0] * self.beta1, prev[1] * self.beta2)

    def initial_batch_state(self) -> Tuple[float, float]:
        return (1.0, 1.0)


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
