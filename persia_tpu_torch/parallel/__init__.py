"""Dense-side steps (counterpart of ``persia_tpu/parallel``)."""
