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
K11 ``batch_norm_bwd``)."""

from persia_tpu_torch.ops.attention_pool import (  # noqa: F401
    attention_pool,
    attention_pool_bwd,
    attention_pool_fwd,
)
from persia_tpu_torch.ops.batch_norm import batch_norm, batch_norm_bwd, batch_norm_fwd  # noqa: F401
from persia_tpu_torch.ops.dot_interaction import dot_interaction, dot_interaction_bwd  # noqa: F401
from persia_tpu_torch.ops.embedding_pool import (  # noqa: F401
    PoolSlot,
    embedding_pool,
    gather_pool_bwd,
    gather_pool_fwd,
)
from persia_tpu_torch.ops.flash_attention import flash_attention, tf32_split_planes  # noqa: F401
from persia_tpu_torch.ops.fused_gather import fused_gather  # noqa: F401
from persia_tpu_torch.ops.raw_gather import RawSlot, raw_csr, raw_gather, raw_gather_bwd, raw_gather_fwd  # noqa: F401
from persia_tpu_torch.ops.sparse_update import sparse_update, update_keys  # noqa: F401

KERNEL_WRAPPERS = (
    dot_interaction, dot_interaction_bwd, gather_pool_fwd, gather_pool_bwd,
    flash_attention, tf32_split_planes, fused_gather, update_keys, sparse_update,
    raw_gather_fwd, raw_gather_bwd, attention_pool_fwd, attention_pool_bwd, batch_norm_fwd, batch_norm_bwd,
)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0
