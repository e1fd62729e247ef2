"""Device kernels written by hand for Hopper (CUDA C++ in
``persia_tpu_torch/csrc``), each beside its plain PyTorch version. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel, and each
wrapper counts its launches in ``<wrapper>.launches`` (flash attention also
per route, in ``flash_attention.launches_by_route``; its f32 route's
pre-pass in ``tf32_split_planes.launches``). ``dot_interaction`` and
``embedding_pool`` are differentiable: their backward passes launch
``dot_interaction_bwd`` and ``gather_pool_bwd``. The fused tier's
``fused_gather`` (K4, which also routes the step's update ids),
``update_keys`` (that routing without a gather) and ``sparse_update`` (K5)
update nothing through autograd: the gathered rows are the step's
differentiated leaves. The raw-slot path's
``raw_gather`` (K6, backward K7) and DIN's ``attention_pool`` (K8,
backward K9) are differentiable too, as is DNN's ``batch_norm`` (K10
``batch_norm_fwd``, counted also by mode in ``launches_by_route``; backward
K11 ``batch_norm_bwd``). The cache tier's ``cache_aux`` (K12, which also
writes the stream's restores from the eviction ring; ``gather_entry_rows``
its payload read alone) and ``cached_gather`` (K13, whose ``PooledRows``
backward hands the step per-position gradients) update nothing through
autograd either, nor does ``quantize_int8_ef`` (K15), the int8 error-feedback
wire of the cache tier's parameter-server gradients, with its shared-scale
modes ``segment_absmax`` and ``quantize_int8_ef_shared`` (the dense
bytegrad all-reduce), nor the dense ring's ``block_quantize_int8`` (K16),
``block_dequantize_int8`` (K17) and their fold at a ring hop,
``block_requantize_int8``, nor ``lp_ring_mix`` (K18), the mix of
LowPrecisionDecentralized's ring sync."""

from persia_tpu_torch.ops.attention_pool import (  # noqa: F401
    attention_pool,
    attention_pool_bwd,
    attention_pool_fwd,
)
from persia_tpu_torch.ops.batch_norm import batch_norm, batch_norm_bwd, batch_norm_fwd  # noqa: F401
from persia_tpu_torch.ops.block_int8 import (  # noqa: F401
    block_dequantize_int8,
    block_quantize_int8,
    block_requantize_int8,
)
from persia_tpu_torch.ops.cache_aux import cache_aux, gather_entry_rows  # noqa: F401
from persia_tpu_torch.ops.cached_gather import cached_gather  # noqa: F401
from persia_tpu_torch.ops.dot_interaction import dot_interaction, dot_interaction_bwd  # noqa: F401
from persia_tpu_torch.ops.embedding_pool import (  # noqa: F401
    PoolSlot,
    embedding_pool,
    gather_pool_bwd,
    gather_pool_fwd,
)
from persia_tpu_torch.ops.flash_attention import flash_attention, tf32_split_planes  # noqa: F401
from persia_tpu_torch.ops.fused_gather import fused_gather  # noqa: F401
from persia_tpu_torch.ops.lp_ring import lp_ring_mix  # noqa: F401
from persia_tpu_torch.ops.quantize_int8 import (  # noqa: F401
    quantize_int8_ef,
    quantize_int8_ef_shared,
    segment_absmax,
)
from persia_tpu_torch.ops.raw_gather import RawSlot, raw_csr, raw_gather, raw_gather_bwd, raw_gather_fwd  # noqa: F401
from persia_tpu_torch.ops.sparse_update import sparse_update, update_keys  # noqa: F401

KERNEL_WRAPPERS = (
    dot_interaction, dot_interaction_bwd, gather_pool_fwd, gather_pool_bwd,
    flash_attention, tf32_split_planes, fused_gather, update_keys, sparse_update,
    raw_gather_fwd, raw_gather_bwd, attention_pool_fwd, attention_pool_bwd, batch_norm_fwd, batch_norm_bwd,
    cache_aux, gather_entry_rows, cached_gather, quantize_int8_ef, segment_absmax, quantize_int8_ef_shared,
    block_quantize_int8, block_dequantize_int8, block_requantize_int8, lp_ring_mix,
)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0
