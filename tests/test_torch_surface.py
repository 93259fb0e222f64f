"""The port's package surface against the JAX package's: every public
name that ``fp8tpu``, ``fp8tpu.numerics`` and ``fp8tpu.kernels`` export,
``fp8tpu_torch`` and its counterparts export too."""

import types

import pytest

import fp8tpu
import fp8tpu.kernels
import fp8tpu.numerics
import fp8tpu_torch
import fp8tpu_torch.kernels
import fp8tpu_torch.numerics

# JAX names that the port exports under another name, and why.
# ``pallas_qdq(x, fmt, mode, scale, daz, seed, block_size, interpret)``
# draws SR bits from the TPU's PRNG by ``seed`` and runs Pallas's
# interpreter on request; K1's entry point takes explicit bits or a salt
# and raises on a CPU tensor, so a ``pallas_qdq`` alias would accept the
# JAX call and mean something else.  It is exported as ``cuda_qdq``.
RENAMED = {"pallas_qdq": "cuda_qdq"}


def public_names(module) -> set:
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in vars(module) if not n.startswith("_")]
    return {n for n in names
            if not isinstance(getattr(module, n), types.ModuleType)}


@pytest.mark.parametrize("jax_mod,torch_mod", [
    (fp8tpu, fp8tpu_torch),
    (fp8tpu.numerics, fp8tpu_torch.numerics),
    (fp8tpu.kernels, fp8tpu_torch.kernels),
], ids=["package", "numerics", "kernels"])
def test_port_exports_the_jax_names(jax_mod, torch_mod):
    want = {RENAMED.get(n, n) for n in public_names(jax_mod)}
    missing = sorted(want - public_names(torch_mod))
    assert not missing, f"{torch_mod.__name__} lacks {missing}"
    for name in want:
        assert getattr(torch_mod, name) is not None


def test_exported_values_agree():
    assert fp8tpu_torch.__version__ == fp8tpu.__version__
    assert fp8tpu_torch.numerics.FP8_FORMATS == fp8tpu.numerics.FP8_FORMATS
    assert [f.name for f in fp8tpu_torch.FORMATS.values()] \
        == [f.name for f in fp8tpu.FORMATS.values()]
    assert fp8tpu_torch.FPFormat.__name__ == fp8tpu.FPFormat.__name__
