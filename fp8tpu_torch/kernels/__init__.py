"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, launch
counts and plain torch versions: K1 ``cast_kernel``, K2 and K3 ``qmatmul``
(fused fake-quant GEMM, serving dequant-GEMM), K4 ``paged_attention``, K5
``int4_matmul``, K6 ``inplace``, the convert studies T1 ``kexp_convert``
and T2 ``fp8_linear_study``, and the port's own P1 / P2 (``qmatmul``,
W8A8) and P3 ``adam8`` (the 8-bit AdamW update).  Nothing is built or
loaded at import; a kernel is built at its first launch."""

from .cast_kernel import cuda_qdq
from .qmatmul import dequant_matmul, qdq_matmul, quantize_weights

__all__ = ["cuda_qdq", "dequant_matmul", "qdq_matmul", "quantize_weights"]
