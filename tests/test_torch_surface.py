"""The port's package surface against the JAX package's: every public
name that ``fp8tpu``, ``fp8tpu.numerics``, ``fp8tpu.kernels``,
``fp8tpu.quant``, ``fp8tpu.training``, ``fp8tpu.models``, ``fp8tpu.serve``,
``fp8tpu.parallel``, ``fp8tpu.utils``, ``fp8tpu.data`` and
``fp8tpu.sparse`` export,
``fp8tpu_torch`` and its counterparts export too, except the names of
modules still to be ported, which are listed here and must be exactly the
missing ones."""

import types

import pytest

import fp8tpu
import fp8tpu.data
import fp8tpu.kernels
import fp8tpu.models
import fp8tpu.numerics
import fp8tpu.parallel
import fp8tpu.quant
import fp8tpu.serve
import fp8tpu.sparse
import fp8tpu.training
import fp8tpu.utils
import fp8tpu_torch
import fp8tpu_torch.data
import fp8tpu_torch.kernels
import fp8tpu_torch.models
import fp8tpu_torch.numerics
import fp8tpu_torch.parallel
import fp8tpu_torch.quant
import fp8tpu_torch.serve
import fp8tpu_torch.sparse
import fp8tpu_torch.training
import fp8tpu_torch.utils

# JAX names that the port exports under another name, and why.
# ``pallas_qdq(x, fmt, mode, scale, daz, seed, block_size, interpret)``
# draws SR bits from the TPU's PRNG by ``seed`` and runs Pallas's
# interpreter on request; K1's entry point takes explicit bits or a salt
# and raises on a CPU tensor, so a ``pallas_qdq`` alias would accept the
# JAX call and mean something else.  It is exported as ``cuda_qdq``.
RENAMED = {"pallas_qdq": "cuda_qdq"}

# Names of modules not ported yet (ROADMAP §1): each slice that ports one
# removes its names here, and the test fails while this set and the missing
# names differ in either direction.
NOT_YET_PORTED = {
    "models": set(),
    "training": set(),
    "quant": set(),
    "utils": set(),
    "data": set(),
    "parallel": set(),
}


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
    (fp8tpu.quant, fp8tpu_torch.quant),
    (fp8tpu.training, fp8tpu_torch.training),
    (fp8tpu.models, fp8tpu_torch.models),
    (fp8tpu.serve, fp8tpu_torch.serve),
    (fp8tpu.parallel, fp8tpu_torch.parallel),
    (fp8tpu.utils, fp8tpu_torch.utils),
    (fp8tpu.data, fp8tpu_torch.data),
    (fp8tpu.sparse, fp8tpu_torch.sparse),
], ids=["package", "numerics", "kernels", "quant", "training", "models",
        "serve", "parallel", "utils", "data", "sparse"])
def test_port_exports_the_jax_names(jax_mod, torch_mod):
    later = NOT_YET_PORTED.get(jax_mod.__name__.rpartition(".")[2], set())
    want = {RENAMED.get(n, n) for n in public_names(jax_mod)}
    missing = want - public_names(torch_mod)
    assert missing == later, (
        f"{torch_mod.__name__} lacks {sorted(missing - later)}; listed as "
        f"not yet ported but exported: {sorted(later - missing)}")
    for name in want - later:
        assert getattr(torch_mod, name) is not None


def test_exported_values_agree():
    assert fp8tpu_torch.__version__ == fp8tpu.__version__
    assert fp8tpu_torch.numerics.FP8_FORMATS == fp8tpu.numerics.FP8_FORMATS
    assert [f.name for f in fp8tpu_torch.FORMATS.values()] \
        == [f.name for f in fp8tpu.FORMATS.values()]
    assert fp8tpu_torch.FPFormat.__name__ == fp8tpu.FPFormat.__name__
