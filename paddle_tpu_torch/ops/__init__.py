"""Operators with hand-written CUDA kernels (counterparts of the Pallas
kernels in ``paddle_tpu/ops``): ``ops.flash_attention``,
``ops.paged_attention`` and ``ops.custom`` (greedy NMS), each module
holding its kernel's wrapper and plain version, ``ops.detection`` built
on the NMS kernel, and ``ops.math`` (``matmul``). The kernels build on
first launch, never at import. Ops bound with ``ops.custom.register_op``
land in this namespace."""
