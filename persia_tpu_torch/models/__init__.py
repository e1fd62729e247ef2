"""Dense models (counterpart of ``persia_tpu/models``). A model takes the
framework's standard inputs, ``model(non_id_features, embeddings)``: a list
of (B, F) dense tensors, and one entry per slot — a (B, dim) tensor for a
pooled slot, a ``(gathered (B, L, dim), mask (B, L))`` pair for a raw one —
and returns logits (B, 1)."""

from persia_tpu_torch.models.dlrm import DLRM  # noqa: F401
