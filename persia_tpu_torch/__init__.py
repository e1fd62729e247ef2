"""persia_tpu_torch — the PyTorch/CUDA port of persia_tpu.

The port mirrors ``persia_tpu``'s layout, module for module, and imports
nothing of it (nor JAX): the host plane it needs (batch wire format,
hashing, store, worker) is its own copy. Device code is PyTorch, and every
device kernel is written by hand for Hopper (``persia_tpu_torch/csrc``),
built with ``nvcc`` at first use and bound with ``ctypes``.

The port covers the serving path and synchronous hybrid training:

  serving     persia_tpu_torch.serving.engine.InferenceEngine
  user API    persia_tpu_torch.ctx.InferCtx (predict / predict_from_bytes),
              persia_tpu_torch.ctx.TrainCtx (train_step / eval_batch)
  emb worker  persia_tpu_torch.embedding.worker (dedup, routing, pooling,
              gradient return)
  param srv   persia_tpu_torch.embedding.store (numpy; lookup and the
              sparse optimizers of embedding.optim)
  dense       persia_tpu_torch.parallel.train_step (train and eval steps) +
              models.DLRM; host<->device bf16 wire in persia_tpu_torch.wire
  kernels     persia_tpu_torch.ops (dot_interaction and its backward, the
              grouped gather-pool forward and backward, flash_attention)
  cache tier  persia_tpu_torch.embedding.hbm_cache.CachedTrainCtx (the
              write-back cache of embedding rows on the card over the
              parameter servers; train_step and train_stream)
  job state   persia_tpu_torch.jobstate (manifests, journal ids, resume),
              persia_tpu_torch.checkpoint (per-shard checkpoint files),
              persia_tpu_torch.serialization (flax's msgpack bytes);
              TrainCtx.snapshot_job / resume

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``persia_tpu_torch.device.resolve_device``).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
