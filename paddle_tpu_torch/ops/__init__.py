"""Operators with hand-written CUDA kernels (counterparts of the Pallas
kernels in ``paddle_tpu/ops``): ``ops.flash_attention`` and
``ops.paged_attention``, each module holding its kernel's wrapper and
plain version. The kernels build on first launch, never at import."""
