"""The eval step and the embedding inputs of a model (counterpart of
``persia_tpu/parallel/train_step.py``; the train step comes with the
training slice).

Batch convention (built by ``persia_tpu_torch.ctx.EmbeddingCtx.prepare_features``,
every leaf a tensor on the ctx's device):

    batch = {
      "dense":  [ (B, F) f32 ... ],
      "labels": [ (B, 1) f32 ... ],
      "emb":    [ {"pooled": (B, D)}                                   # host-pooled slot
                | {"distinct": (P, D), "pool_index": (B, L) i32,
                   ["pool_counts": (B, 1) i32]}                        # device-pooled slot
                | {"distinct": (P, D), "index": (B, L) i32,
                   "mask": (B, L) bool} ... ],                         # raw slot
    }
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def _embedding_model_inputs(emb_diff: List, emb_static: List) -> List:
    """Rebuild per-slot model inputs from (differentiable, static) halves."""
    out = []
    for diff, static in zip(emb_diff, emb_static):
        if static is None:  # pooled slot: diff IS the (B, dim) tensor
            out.append(diff)
        elif len(static) == 3:  # ("pool", index, counts): device-pooled sum slot
            _, index, pool_counts = static
            # accumulate in f32 even on a bf16 wire; index pads point at the
            # zero rows past D; (B, L, dim) → (B, dim)
            pooled = diff[index.long()].float().sum(dim=1)
            if pool_counts is not None:
                scale = torch.rsqrt(torch.clamp(pool_counts[:, 0], min=1).float())
                pooled = pooled * scale[:, None]
            out.append(pooled)
        else:  # raw slot: (gathered (B, L, dim), mask)
            index, mask = static
            out.append((diff[index.long()], mask))
    return out


def _split_emb(emb: List[Dict]) -> Tuple[List, List]:
    diff, static = [], []
    for e in emb:
        if "pooled" in e:
            diff.append(e["pooled"])
            static.append(None)
        elif "pool_index" in e:
            diff.append(e["distinct"])
            static.append(("pool", e["pool_index"], e.get("pool_counts")))
        else:
            diff.append(e["distinct"])
            static.append((e["index"], e["mask"]))
    return diff, static


def build_eval_step(model: torch.nn.Module) -> Callable[[Dict], torch.Tensor]:
    """Returns ``eval_step(batch) -> preds``: sigmoid of the model's logits,
    computed under ``torch.inference_mode``. The parameters are the
    module's own."""

    @torch.inference_mode()
    def eval_step(batch: Dict) -> torch.Tensor:
        model_emb = _embedding_model_inputs(*_split_emb(batch["emb"]))
        return torch.sigmoid(model(batch["dense"], model_emb))

    return eval_step
