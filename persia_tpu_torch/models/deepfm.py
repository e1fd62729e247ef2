"""DeepFM (counterpart of ``persia_tpu/models/deepfm.py``): first-order
terms (a linear layer over the dense features and a learned scalar a
field), the FM second-order term by the square-of-sum minus sum-of-squares
identity, and a deep tower over ``[dense | flattened fields]``.

The FM term is computed in ``compute_dtype`` and cast to f32 at the end;
the first-order terms in f32, as in the reference. Unlike flax, torch fixes
a layer's input width at construction, so the constructor takes the dense
feature width and the field count.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.models.layers import dense, dense_f32, lecun_init_, slot_vector


def field_matrix(embeddings: List, dt: torch.dtype) -> torch.Tensor:
    """Stack per-slot embeddings into (B, n_fields, d); raw slots mean-pool."""
    return torch.stack([slot_vector(e, dt) for e in embeddings], dim=1)


class DeepFM(nn.Module):
    def __init__(
        self,
        dense_dim: int,
        num_fields: int,
        embedding_dim: int = 16,
        deep_mlp: Sequence[int] = (256, 128),
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        dev = resolve_device(device)
        self.dense_linear = nn.Linear(dense_dim, 1, device=dev)
        self.field_weight = nn.Parameter(torch.zeros(num_fields, device=dev))  # flax: zeros
        ins = [dense_dim + num_fields * embedding_dim, *deep_mlp[:-1]]
        self.layers = nn.ModuleList(nn.Linear(i, o, device=dev) for i, o in zip(ins, deep_mlp))
        self.deep_out = nn.Linear(deep_mlp[-1], 1, device=dev)
        lecun_init_([self.dense_linear, *self.layers, self.deep_out], generator)

    def flax_modules(self):
        """(flax path, layer or parameter) in call order."""
        return ([(("dense_linear",), self.dense_linear), (("field_weight",), self.field_weight)]
                + [((f"Dense_{i}",), layer) for i, layer in enumerate(self.layers)]
                + [(("deep_out",), self.deep_out)])

    def forward(self, non_id_features: List[torch.Tensor], embeddings: List) -> torch.Tensor:
        dt = self.compute_dtype
        x_dense = torch.cat([f.to(dt) for f in non_id_features], dim=1)
        fields = field_matrix(embeddings, dt)  # (B, n, d)

        first = dense_f32(x_dense, self.dense_linear)
        first = first + (fields.float().sum(-1) * self.field_weight).sum(dim=1, keepdim=True)

        # second-order FM: 0.5 * ((sum v)^2 - sum v^2), summed over the dim axis
        sum_v = fields.sum(dim=1)
        fm = (0.5 * (sum_v * sum_v - (fields * fields).sum(dim=1))).sum(dim=1, keepdim=True).float()

        deep = torch.cat([x_dense, fields.reshape(fields.shape[0], -1)], dim=1)
        for layer in self.layers:
            deep = F.relu(dense(deep, layer, dt))
        return first + fm + dense_f32(deep, self.deep_out)
