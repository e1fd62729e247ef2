"""The write-back cache tier (counterpart of
``persia_tpu/embedding/hbm_cache``): the parameter servers keep the
unbounded vocabulary, the card keeps the working set as a fixed pool of
rows and trains it in place.

- a hit never crosses between host and card: the step receives int32 cache
  rows, gathers and pools them on the card (K13) and applies the sparse
  optimizer there (K5);
- a miss checks its whole entry ``[emb | optimizer state]`` out of the
  servers (or, for a sign they lack, births its row on the host with their
  seeded init) and the aux program (K12) writes it into the pool;
- an eviction (LRU, the native directory ``native/cache.cpp``) reads the
  victim's entry back out (K12's payload) and writes it to the servers
  after the next step is dispatched;
- a miss on a sign whose write-back is still in flight (the stream) is
  restored on the card from the group's eviction ring (K12, in the step's
  one launch); at ``pipeline_depth > 1`` the stream hoists a step's feed
  (K12) above earlier steps' dense stages where their rows are disjoint;
- slots the cache does not hold (``ps_slots``, hash-stacked slots) are
  looked up through the worker and return their gradients to the servers,
  in f32, bf16 or int8 with error feedback (K15), the mixed tier.

Entry point: ``CachedTrainCtx`` (``train_step``, ``train_stream``,
``eval_batch``, ``flush``, ``publish`` and checkpoints).
"""

from persia_tpu_torch.embedding.hbm_cache.ctx import CachedTrainCtx  # noqa: F401
from persia_tpu_torch.embedding.hbm_cache.directory import (  # noqa: F401
    CacheDirectory,
    PendingSignMap,
    _BufRing,
    build_native,
    group_salt,
    native_init_rows,
    native_uniform_init,
)
from persia_tpu_torch.embedding.hbm_cache.groups import (  # noqa: F401
    CachedTrainState,
    CacheGroup,
    CacheLayout,
    init_cached_tables,
    make_cache_groups,
)
from persia_tpu_torch.embedding.hbm_cache.step import build_cached_eval_step, build_cached_train_step  # noqa: F401
from persia_tpu_torch.embedding.hbm_cache.tier import CachedEmbeddingTier  # noqa: F401
