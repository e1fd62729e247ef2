"""Dense models (counterpart of ``persia_tpu/models``). A model takes the
framework's standard inputs, ``model(non_id_features, embeddings)``: a list
of (B, F) dense tensors, and one entry per slot — a (B, dim) tensor for a
pooled slot, a ``(gathered (B, L, dim), mask (B, L))`` pair for a raw one —
and returns logits (B, 1). Each lists its layers under flax's names in
``flax_modules()``, which ``persia_tpu_torch.weights`` reads."""

from persia_tpu_torch.models.dcn import DCNv2  # noqa: F401
from persia_tpu_torch.models.deepfm import DeepFM  # noqa: F401
from persia_tpu_torch.models.din import DIN  # noqa: F401
from persia_tpu_torch.models.dlrm import DLRM  # noqa: F401
