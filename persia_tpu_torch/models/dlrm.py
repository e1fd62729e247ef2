"""DLRM (counterpart of ``persia_tpu/models/dlrm.py``).

Bottom MLP over the dense features, pairwise dot interactions between the
bottom output and the per-slot embeddings (``ops.dot_interaction``, a
kernel of this port), top MLP over ``[bottom | interactions]``, and an f32
head. Parameters are f32; the MLPs and the interaction compute in
``compute_dtype`` (bf16 by default), as in the reference.

The layers sit in one ``nn.ModuleList`` in call order — bottom, top, head —
the order of flax's ``Dense_0 … Dense_k``, which is what lets
``persia_tpu_torch.weights`` carry the reference's parameters across by
index. Unlike flax, torch fixes a layer's input width at construction, so
the constructor takes the dense feature width and the slot count.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.models.layers import dense, dense_f32, lecun_init_, slot_vector
from persia_tpu_torch.ops import dot_interaction


class DLRM(nn.Module):
    def __init__(
        self,
        dense_dim: int,
        num_slots: int,
        embedding_dim: int = 16,
        bottom_mlp: Sequence[int] = (64, 32, 16),  # last must equal embedding_dim
        top_mlp: Sequence[int] = (256, 128),
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if bottom_mlp[-1] != embedding_dim:
            raise ValueError(
                f"bottom_mlp must end at embedding_dim={embedding_dim}, got {tuple(bottom_mlp)}"
            )
        self.embedding_dim = embedding_dim
        self.compute_dtype = compute_dtype
        self.num_bottom = len(bottom_mlp)
        n = num_slots + 1  # the bottom output joins the interaction
        top_in = embedding_dim + n * (n - 1) // 2
        ins = [dense_dim, *bottom_mlp[:-1], top_in, *top_mlp]
        outs = [*bottom_mlp, *top_mlp, 1]
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            nn.Linear(i, o, device=dev) for i, o in zip(ins, outs)
        )
        lecun_init_(self.layers, generator)

    def flax_modules(self):
        """(flax path, layer) in call order: ``Dense_0 … Dense_k``."""
        return [((f"Dense_{i}",), layer) for i, layer in enumerate(self.layers)]

    def _mlp(self, x: torch.Tensor, layers: Sequence[nn.Linear]) -> torch.Tensor:
        for layer in layers:
            x = F.relu(dense(x, layer, self.compute_dtype))
        return x

    def forward(self, non_id_features: List[torch.Tensor], embeddings: List) -> torch.Tensor:
        dt = self.compute_dtype
        dense = torch.cat([f.to(dt) for f in non_id_features], dim=1)
        bottom = self._mlp(dense, self.layers[: self.num_bottom])  # (B, d)

        embs = [slot_vector(e, dt) for e in embeddings]  # a raw slot mean-pools
        feats = torch.stack([bottom, *embs], dim=1)  # (B, n, d)
        inter = dot_interaction(feats)  # (B, n(n-1)/2)
        x = self._mlp(torch.cat([bottom, inter], dim=1), self.layers[self.num_bottom : -1])
        return dense_f32(x, self.layers[-1])  # f32 head
