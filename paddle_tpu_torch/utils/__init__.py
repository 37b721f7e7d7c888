"""Host-side utilities (counterpart of ``paddle_tpu/utils``)."""
