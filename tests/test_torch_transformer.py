"""Port parity for the emulation-form decoder: fp8tpu_torch.models.Decoder
against the Flax Decoder on the same variables (carried across by
variables_from_flax) and tokens."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.models import Decoder as JDecoder
from fp8tpu.models.transformer import apply_rope as j_apply_rope
from fp8tpu.models.transformer import rope_freqs as j_rope_freqs
from fp8tpu.models.transformer import tiny_config as j_tiny_config
from fp8tpu_torch.models import (Decoder, apply_rope, decoder, rope_freqs,
                                 tiny_config, variables_from_flax)

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, max_seq_len=32)
BF16_ULP = 2.0 ** -7


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    jcfg = j_tiny_config(dtype=dtype, **TINY)
    jm = JDecoder(jcfg)
    tokens = np.random.default_rng(0).integers(0, 128, (2, 12)).astype(
        np.int32)
    v = jm.init(jax.random.key(0), jnp.asarray(tokens))
    tm = Decoder(tiny_config(dtype=dtype, **TINY))
    tm.load_state_dict(variables_from_flax(jax.tree.map(np.asarray, v)))
    return jm, v, tm, tokens


@pytest.mark.parametrize("dtype,tol", [
    # f32: the same arithmetic in another summation order
    ("float32", 1e-4),
    # bf16: every contraction and elementwise op rounds to bf16; XLA fuses
    # some of those roundings away, so single bf16 steps differ
    ("bfloat16", 2 * BF16_ULP),
])
def test_decoder_logits_match_flax(dtype, tol):
    jm, v, tm, tokens = _pair(dtype)
    want = np.asarray(jm.apply(v, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape == (2, 12, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_decoder_positions_argument():
    jm, v, tm, tokens = _pair("float32")
    pos = np.broadcast_to(np.arange(3, 15, dtype=np.int32), (2, 12)).copy()
    want = np.asarray(jm.apply(v, jnp.asarray(tokens), jnp.asarray(pos)))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_variables_from_flax_names_and_layouts():
    _, v, tm, _ = _pair("float32")
    sd = variables_from_flax(jax.tree.map(np.asarray, v))
    assert set(sd) == set(tm.state_dict())
    k = np.asarray(v["params"]["layer_1"]["attn"]["k_proj"]["kernel"])
    np.testing.assert_array_equal(sd["layer_1.attn.k_proj.weight"].numpy(),
                                  k.T)
    assert sd["embed.embedding"].shape == (128, 64)


def test_rope_matches():
    jcfg, tcfg = j_tiny_config(**TINY), tiny_config(**TINY)
    ji, ti = j_rope_freqs(jcfg), rope_freqs(tcfg)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6, atol=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 32, (2, 5)).astype(np.int32)
    want = np.asarray(j_apply_rope(jnp.asarray(x), jnp.asarray(pos), ji))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), ti).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_moe_decoder_waits_and_device_defaults_to_cuda(monkeypatch):
    """An MoE Decoder (which raised before MoE was ported) builds MoEMLP
    layers and runs; the device rules hold."""
    from fp8tpu_torch.models import MoEMLP, moe_aux_loss
    moe = decoder(tiny_config(n_experts=4, **TINY), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    assert isinstance(moe.layer_0.moe, MoEMLP)
    with torch.no_grad():
        out = moe(torch.zeros(1, 4, dtype=torch.int64))
    assert out.shape == (1, 4, 128) and bool(torch.isfinite(out).all())
    assert float(moe_aux_loss(moe)) > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decoder(tiny_config(**TINY))
    m = decoder(tiny_config(**TINY), device="cpu",
                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = m(torch.zeros(1, 4, dtype=torch.int64))
    assert out.shape == (1, 4, 128) and bool(torch.isfinite(out).all())
