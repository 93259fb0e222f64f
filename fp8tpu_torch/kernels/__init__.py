"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, launch
counts and plain torch versions: K1 ``cast_kernel``, K2 and K3 ``qmatmul``
(fused fake-quant GEMM, serving dequant-GEMM), K5 ``int4_matmul`` and K6
``inplace``.  Nothing is built or loaded at import; a kernel is built at
its first launch."""
