"""DIN, the deep interest network (counterpart of
``persia_tpu/models/din.py``).

Pooled slots are field embeddings; the ``target_slot``-th pooled slot is
the candidate item. Every raw slot (the user's behaviour history) is scored
against it by an attention unit, an MLP over ``[item, target, item - target,
item * target]`` in ``compute_dtype``, and pooled with the masked softmax of
those scores (``ops.attention_pool``, a kernel of this port). The unit's
layers and the top MLP stay ``F.linear`` (cuBLAS), as the reference leaves
them to XLA.

The constructor takes the dense feature width and the pooled and raw slot
counts: torch fixes the top MLP's input width, dense + d * (pooled + raw),
at construction.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.models.layers import dense, dense_f32, lecun_init_, sigmoid_gate
from persia_tpu_torch.ops import attention_pool


class AttentionUnit(nn.Module):
    """The activation unit: one f32 logit per history position."""

    def __init__(self, embedding_dim: int, hidden: Sequence[int] = (36,),
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        ins = [4 * embedding_dim, *hidden]
        self.layers = nn.ModuleList(nn.Linear(i, o, device=device) for i, o in zip(ins, [*hidden, 1]))

    def forward(self, items: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        # items (B, L, d), target (B, d), both in compute_dtype
        t = target[:, None, :].expand_as(items)
        x = torch.cat([items, t, items - t, items * t], dim=-1)
        for layer in self.layers[:-1]:
            x = sigmoid_gate(dense(x, layer, self.compute_dtype))
        return dense_f32(x, self.layers[-1])[..., 0]  # (B, L)


class DIN(nn.Module):
    def __init__(
        self,
        dense_dim: int,
        num_pooled: int,
        num_raw: int,
        embedding_dim: int = 16,
        attention_hidden: Sequence[int] = (36,),
        top_mlp: Sequence[int] = (200, 80),
        target_slot: int = 0,
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if num_pooled < 1:
            raise ValueError("DIN needs at least one pooled slot as the target item")
        self.compute_dtype = compute_dtype
        self.target_slot = target_slot
        dev = resolve_device(device)
        self.att = nn.ModuleList(
            AttentionUnit(embedding_dim, attention_hidden, compute_dtype, dev) for _ in range(num_raw)
        )
        top_in = dense_dim + embedding_dim * (num_pooled + num_raw)
        ins = [top_in, *top_mlp]
        self.layers = nn.ModuleList(nn.Linear(i, o, device=dev) for i, o in zip(ins, [*top_mlp, 1]))
        lecun_init_([*(l for a in self.att for l in a.layers), *self.layers], generator)

    def flax_modules(self):
        """(flax path, layer) in call order: ``att_i/Dense_j``, then the top
        MLP's and the head's ``Dense_0 … Dense_k``."""
        out = [((f"att_{i}", f"Dense_{j}"), layer)
               for i, a in enumerate(self.att) for j, layer in enumerate(a.layers)]
        return out + [((f"Dense_{i}",), layer) for i, layer in enumerate(self.layers)]

    def forward(self, non_id_features: List[torch.Tensor], embeddings: List) -> torch.Tensor:
        dt = self.compute_dtype
        x_dense = torch.cat([f.to(dt) for f in non_id_features], dim=1)
        pooled = [e.to(dt) for e in embeddings if not isinstance(e, tuple)]
        raws = [e for e in embeddings if isinstance(e, tuple)]
        if not pooled:
            raise ValueError("DIN needs at least one pooled slot as the target item")
        if len(raws) != len(self.att):
            raise ValueError(f"DIN was built for {len(self.att)} raw slots, got {len(raws)}")
        target = pooled[self.target_slot]
        interests = []
        for unit, (hist, mask) in zip(self.att, raws):
            hist = hist.to(dt)
            interests.append(attention_pool(unit(hist, target), mask, hist))
        x = torch.cat([x_dense, *pooled, *interests], dim=1)
        for layer in self.layers[:-1]:
            x = sigmoid_gate(dense(x, layer, dt))
        return dense_f32(x, self.layers[-1])
