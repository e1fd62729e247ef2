"""Configuration layer (counterpart of ``persia_tpu/config.py``), trimmed to
the fields the serving and training slices read: the per-slot embedding
schema, the feature groups and their prefixes, and the embedding
hyperparameters."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MAX_BATCH_SIZE = 65535  # u16 sample indices on the wire


@dataclass(frozen=True)
class HashStackConfig:
    """Multi-round hashing vocabulary compression: each id is hashed
    ``hash_stack_rounds`` times into ``[round * embedding_size, (round+1) *
    embedding_size)`` and the rows are summed."""

    hash_stack_rounds: int = 0
    embedding_size: int = 0

    @property
    def enabled(self) -> bool:
        return self.hash_stack_rounds > 0 and self.embedding_size > 0


@dataclass(frozen=True)
class SlotConfig:
    """Per-feature-slot embedding schema.

    - ``embedding_summation``: True → sum-pool ids per sample into one (dim,)
      vector; False → "raw" slot returning distinct-id rows plus an index
      layout (sequence features).
    - ``sample_fixed_size``: raw slots pad/truncate each sample's id list to
      this length.
    - ``sqrt_scaling``: scale pooled output by 1/sqrt(n_ids).
    - ``index_prefix``: per-slot prefix OR-ed into the top bits of every sign.
    """

    dim: int
    name: str = ""
    embedding_summation: bool = True
    sqrt_scaling: bool = False
    sample_fixed_size: int = 10
    hash_stack_config: HashStackConfig = field(default_factory=HashStackConfig)
    index_prefix: int = 0


@dataclass(frozen=True)
class EmbeddingConfig:
    """Embedding schema: slot map + feature groups + prefix assignment.

    Slots not mentioned in any group form singleton groups, in slot order;
    each group gets a distinct prefix in the top ``feature_index_prefix_bit``
    bits of the u64 sign (the same assignment as ``persia_tpu.config``, so
    both packages route a sign to the same key).
    """

    slots_config: Dict[str, SlotConfig] = field(default_factory=dict)
    feature_index_prefix_bit: int = 0
    feature_groups: Dict[str, List[str]] = field(default_factory=dict)

    def __post_init__(self):
        slots = {}
        for name, slot in self.slots_config.items():
            if slot.name != name:
                slot = dataclasses.replace(slot, name=name)
            slots[name] = slot

        groups = dict(self.feature_groups)
        grouped: set = set()
        for members in groups.values():
            for member in members:
                if member not in slots:
                    raise ValueError(f"feature group member {member!r} not a slot")
                if member in grouped:
                    raise ValueError(
                        f"slot {member!r} appears in multiple feature groups; "
                        f"groups must partition the slots"
                    )
                grouped.add(member)
        for name in slots:
            if name not in grouped:
                if name in groups:
                    raise ValueError(
                        f"slot {name!r} collides with a feature group of the same "
                        f"name but is not a member of it"
                    )
                groups[name] = [name]

        if self.feature_index_prefix_bit > 0:
            shift = 64 - self.feature_index_prefix_bit
            if len(groups) >= (1 << self.feature_index_prefix_bit):
                raise ValueError(
                    f"{len(groups)} feature groups do not fit in "
                    f"{self.feature_index_prefix_bit} prefix bits"
                )
            for group_idx, members in enumerate(groups.values()):
                prefix = (group_idx + 1) << shift
                for member in members:
                    if slots[member].index_prefix == 0:
                        slots[member] = dataclasses.replace(slots[member], index_prefix=prefix)

        object.__setattr__(self, "slots_config", slots)
        object.__setattr__(self, "feature_groups", groups)

    def slot(self, name: str) -> SlotConfig:
        return self.slots_config[name]

    def group_of(self, slot_name: str) -> int:
        """Index of the slot's feature group: the optimizer group whose Adam
        beta powers its gradients advance."""
        for idx, members in enumerate(self.feature_groups.values()):
            if slot_name in members:
                return idx
        raise KeyError(slot_name)


INIT_UNIFORM = "uniform"
INIT_GAMMA = "gamma"
INIT_POISSON = "poisson"
INIT_NORMAL = "normal"
INIT_INVERSE_SQRT = "inverse_sqrt"
_INIT_KINDS = (INIT_UNIFORM, INIT_GAMMA, INIT_POISSON, INIT_NORMAL, INIT_INVERSE_SQRT)


@dataclass(frozen=True)
class InitializationMethod:
    """Seeded-by-sign embedding init distribution. ``p0``/``p1`` per kind:
    uniform → (lower, upper); gamma → (shape, scale); poisson → (lambda,
    unused); normal → (mean, stddev); inverse_sqrt ignores both and draws
    uniform in ±1/sqrt(dim)."""

    kind: str = INIT_UNIFORM
    p0: float = -0.01
    p1: float = 0.01

    def __post_init__(self):
        if self.kind not in _INIT_KINDS:
            raise ValueError(f"unknown initialization kind: {self.kind!r}")


@dataclass(frozen=True)
class HyperParameters:
    """Embedding hyperparameters pushed to the parameter-server replicas."""

    emb_initialization: Tuple[float, float] = (-0.01, 0.01)
    admit_probability: float = 1.0
    weight_bound: float = 10.0
    # None → bounded uniform over emb_initialization
    initialization_method: Optional[InitializationMethod] = None

    def resolved_init_method(self) -> InitializationMethod:
        if self.initialization_method is not None:
            return self.initialization_method
        lo, hi = self.emb_initialization
        return InitializationMethod(INIT_UNIFORM, lo, hi)
