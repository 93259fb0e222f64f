"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, launch
counts and plain torch versions: K1 ``cast_kernel`` and K2 ``qmatmul``.
Nothing is built or loaded at import; a kernel is built at its first
launch."""
