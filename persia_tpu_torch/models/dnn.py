"""DNN, the adult-income model (counterpart of ``persia_tpu/models/dnn.py``).

The slot vectors are concatenated (a raw slot summed over its valid
positions) into the sparse branch, ``Dense_0`` → ``BatchNorm_0``; the dense
features go through ``Dense_1`` → ``BatchNorm_1``; the two are concatenated
and run through ``Dense_2 …`` with relu and an f32 head. Compute is in
``compute_dtype`` (bf16 by default) over f32 parameters, as in the
reference. The batch norms (``models.layers.BatchNorm``: K10 and K11 on the
card) are the only layers of the port's models with state besides their
parameters: flax's ``batch_stats``, the buffers ``mean`` and ``var``.
``model.train()`` normalises with the batch's statistics and moves them;
``model.eval()`` normalises with the running ones.

Unlike flax, torch fixes a layer's input width at construction, so the
constructor takes the dense feature width and the slots' dims.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.models.layers import BatchNorm, dense, dense_f32, lecun_init_, masked_sum


class DNN(nn.Module):
    def __init__(
        self,
        dense_dim: int,
        slot_dims: Sequence[int],
        dense_mlp_size: int = 16,
        sparse_mlp_size: int = 128,
        hidden_sizes: Sequence[int] = (256, 128),
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not slot_dims:
            raise ValueError("DNN needs at least one slot")
        self.compute_dtype = compute_dtype
        dev = resolve_device(device)
        # flax's creation order: Dense_0 (sparse), Dense_1 (dense), the
        # hidden layers, the head
        ins = [sum(slot_dims), dense_dim, sparse_mlp_size + dense_mlp_size, *hidden_sizes]
        outs = [sparse_mlp_size, dense_mlp_size, *hidden_sizes, 1]
        self.layers = nn.ModuleList(nn.Linear(i, o, device=dev) for i, o in zip(ins, outs))
        self.norms = nn.ModuleList([BatchNorm(sparse_mlp_size, device=dev), BatchNorm(dense_mlp_size, device=dev)])
        lecun_init_(self.layers, generator)

    def flax_modules(self):
        """(flax path, layer) in creation order: ``Dense_0``, ``BatchNorm_0``,
        ``Dense_1``, ``BatchNorm_1``, ``Dense_2 … Dense_k``."""
        out = []
        for i, norm in enumerate(self.norms):
            out += [((f"Dense_{i}",), self.layers[i]), ((f"BatchNorm_{i}",), norm)]
        return out + [((f"Dense_{i}",), layer) for i, layer in enumerate(self.layers) if i >= 2]

    def forward(self, non_id_features: List[torch.Tensor], embeddings: List) -> torch.Tensor:
        dt = self.compute_dtype
        x_dense = torch.cat([f.to(dt) for f in non_id_features], dim=1)
        sparse = torch.cat([masked_sum(e, dt) for e in embeddings], dim=1)
        sparse = self.norms[0](dense(sparse, self.layers[0], dt))
        x_dense = self.norms[1](dense(x_dense, self.layers[1], dt))
        x = torch.cat([sparse, x_dense], dim=1)
        for layer in self.layers[2:-1]:
            x = F.relu(dense(x, layer, dt))
        return dense_f32(x, self.layers[-1])
