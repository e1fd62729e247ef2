"""DCN-v2 (counterpart of ``persia_tpu/models/dcn.py``): cross layers
``x_{l+1} = x0 * (W x_l + b) + x_l`` (optionally low-rank, ``W = U V^T``)
beside a deep tower over the same ``x0 = [dense | flattened fields]``,
concatenated into an f32 head. The constructor takes the dense feature
width and the field count (torch fixes input widths at construction).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.models.deepfm import field_matrix
from persia_tpu_torch.models.layers import dense, dense_f32, lecun_init_


class CrossLayerV2(nn.Module):
    """One cross layer; ``rank`` enables the low-rank factorisation (its
    first layer has no bias, as in the reference)."""

    def __init__(self, width: int, rank: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        if rank is None:
            layers = [nn.Linear(width, width, device=device)]
        else:
            layers = [nn.Linear(width, rank, bias=False, device=device), nn.Linear(rank, width, device=device)]
        self.layers = nn.ModuleList(layers)

    def forward(self, x0: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
        wx = xl
        for layer in self.layers:
            wx = dense(wx, layer, self.compute_dtype)
        return x0 * wx + xl


class DCNv2(nn.Module):
    def __init__(
        self,
        dense_dim: int,
        num_fields: int,
        embedding_dim: int = 16,
        num_cross_layers: int = 3,
        cross_rank: Optional[int] = None,
        deep_mlp: Sequence[int] = (256, 128),
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        dev = resolve_device(device)
        width = dense_dim + num_fields * embedding_dim
        self.cross = nn.ModuleList(
            CrossLayerV2(width, cross_rank, compute_dtype, dev) for _ in range(num_cross_layers)
        )
        ins = [width, *deep_mlp[:-1], width + deep_mlp[-1]]
        self.layers = nn.ModuleList(nn.Linear(i, o, device=dev) for i, o in zip(ins, [*deep_mlp, 1]))
        lecun_init_([*(l for c in self.cross for l in c.layers), *self.layers], generator)

    def flax_modules(self):
        """(flax path, layer) in call order: ``CrossLayerV2_i/Dense_j``, then
        the deep tower's and the head's ``Dense_0 … Dense_k``."""
        out = [((f"CrossLayerV2_{i}", f"Dense_{j}"), layer)
               for i, c in enumerate(self.cross) for j, layer in enumerate(c.layers)]
        return out + [((f"Dense_{i}",), layer) for i, layer in enumerate(self.layers)]

    def forward(self, non_id_features: List[torch.Tensor], embeddings: List) -> torch.Tensor:
        dt = self.compute_dtype
        x_dense = torch.cat([f.to(dt) for f in non_id_features], dim=1)
        fields = field_matrix(embeddings, dt)
        x0 = torch.cat([x_dense, fields.reshape(fields.shape[0], -1)], dim=1)
        xl = x0
        for layer in self.cross:
            xl = layer(x0, xl)
        deep = x0
        for layer in self.layers[:-1]:
            deep = F.relu(dense(deep, layer, dt))
        return dense_f32(torch.cat([xl, deep], dim=1), self.layers[-1])
