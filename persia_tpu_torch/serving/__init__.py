"""Serving plane (counterpart of ``persia_tpu/serving``): the inference
engine. The HTTP server, batcher, cache and rollover come in later slices."""
