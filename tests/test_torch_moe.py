"""Port parity for the mixture-of-experts layers: fp8tpu_torch.parallel.moe
and the decoder's MoEMLP against fp8tpu.parallel.moe and the Flax MoEMLP,
from the same numpy inputs and the same Flax variables.

Tolerances: routing decisions (dispatch) are exact; the combine weights
and the aux loss are softmax probabilities, equal to 1 ulp of f32 (the
two libraries' exp differ by an ulp at most) and held to 1e-6.  Whole
f32 forwards differ only in summation order (1e-4 of max|logit|); bf16
forwards also round activations to bf16 at the same places, where a
reordered f32 sum can move one bf16 step (4e-2 of max|logit|, as the
serving tests hold bf16 paths).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.models import Decoder as JDecoder
from fp8tpu.models.transformer import moe_aux_loss as j_moe_aux_loss
from fp8tpu.models.transformer import tiny_config as j_tiny_config
from fp8tpu.parallel import moe as jmoe
from fp8tpu_torch.models import (Decoder, MoEMLP, decoder, moe_aux_loss,
                                 tiny_config, variables_from_flax)
from fp8tpu_torch.parallel import moe as tmoe

MOE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab_size=128, max_seq_len=32, n_experts=4, moe_top_k=2)


def raw(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


# -- routing ---------------------------------------------------------------------

@pytest.mark.parametrize("T,E,k,capacity", [(12, 4, 2, 12), (24, 4, 2, 5),
                                            (16, 8, 1, 2), (9, 3, 3, 4)],
                         ids=["no-drop", "drops", "top1-drops", "top3"])
def test_top_k_routing_matches_jax(rng, T, E, k, capacity):
    logits = (rng.standard_normal((T, E)) * 2).astype(np.float32)
    jd, jc, ja = jmoe.top_k_routing(jnp.asarray(logits), k, capacity)
    td, tc, ta = tmoe.top_k_routing(torch.from_numpy(logits), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    if capacity < T * k / E:        # the case drops tokens, as it means to
        assert td.sum() < T * k


def test_top_k_routing_ties_go_to_the_lower_expert():
    """A uniform row (a zero router) picks experts 0 .. k-1 on both sides."""
    logits = np.zeros((3, 4), np.float32)
    jd, _, _ = jmoe.top_k_routing(jnp.asarray(logits), 2, 6)
    td, _, _ = tmoe.top_k_routing(torch.from_numpy(logits), 2, 6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td.sum(-1).sum(0).tolist() == [3.0, 3.0, 0.0, 0.0]


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "int8"])
def test_quantize_expert_weights_bit_equal(rng, fmt):
    w = (rng.standard_normal((3, 16, 24)) * 0.1).astype(np.float32)
    w[1] *= 40.0                        # experts at other scales
    jp, js = jmoe.quantize_expert_weights(jnp.asarray(w), fmt)
    tp, ts = tmoe.quantize_expert_weights(torch.from_numpy(w), fmt)
    assert tuple(tp.shape) == jp.shape and tuple(ts.shape) == js.shape \
        == (3, 1, 24)
    np.testing.assert_array_equal(raw(tp), raw(jp))
    np.testing.assert_array_equal(raw(ts), raw(js))


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_ffn_matches_jax(rng, capacity_factor):
    T, D, F, E = 10, 32, 48, 4
    x = rng.standard_normal((T, D)).astype(np.float32)
    gate = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    up = (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32)
    down = (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32)
    j_up, j_down = (jmoe.quantize_expert_weights(jnp.asarray(a))
                    for a in (up, down))
    t_up, t_down = (tmoe.quantize_expert_weights(torch.from_numpy(a))
                    for a in (up, down))
    jy, ja = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(gate), *j_up, *j_down,
                          top_k=2, capacity_factor=capacity_factor)
    ty, ta = tmoe.moe_ffn(torch.from_numpy(x), torch.from_numpy(gate),
                          *t_up, *t_down, top_k=2,
                          capacity_factor=capacity_factor)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == (T, D)
    jy = np.asarray(jy)
    assert np.abs(ty.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    # over a mesh (expert parallelism): tests/test_torch_parallel.py


# -- the decoder's MoEMLP ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _variables(capacity_factor):
    cfg = j_tiny_config(**MOE, moe_capacity_factor=capacity_factor)
    v = JDecoder(cfg).init(jax.random.key(0), jnp.arange(16)[None] % 128)
    return jax.tree.map(np.asarray, v)


def test_variables_from_flax_maps_the_moe_names():
    v = _variables(1.25)
    sd = variables_from_flax(v)
    lp = v["params"]["layer_0"]["moe"]
    np.testing.assert_array_equal(sd["layer_0.moe.router.weight"].numpy(),
                                  lp["router"]["kernel"].T)
    np.testing.assert_array_equal(sd["layer_0.moe.up"].numpy(), lp["up"])
    np.testing.assert_array_equal(sd["layer_0.moe.down"].numpy(), lp["down"])
    m = Decoder(tiny_config(**MOE))
    assert set(sd) == set(m.state_dict())
    assert all(tuple(sd[k].shape) == tuple(t.shape)
               for k, t in m.state_dict().items())
    assert isinstance(m.layer_1.moe, MoEMLP) and not hasattr(m.layer_1, "mlp")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 4e-2)])
@pytest.mark.parametrize("capacity_factor", [1.25, 4.0],
                         ids=["drops", "no-drop"])
def test_moe_decoder_matches_flax(rng, dtype, tol, capacity_factor):
    """Logits and the collected aux loss of an MoE Decoder against the Flax
    model on the same variables; capacity 1.25 drops tokens."""
    jcfg = j_tiny_config(**MOE, moe_capacity_factor=capacity_factor,
                         dtype=dtype)
    tcfg = tiny_config(**MOE, moe_capacity_factor=capacity_factor,
                       dtype=dtype)
    v = _variables(capacity_factor)
    toks = rng.integers(0, 128, (2, 12)).astype(np.int32)
    jl, inter = JDecoder(jcfg).apply(v, jnp.asarray(toks),
                                     mutable=["intermediates"])
    m = Decoder(tcfg)
    m.load_state_dict(variables_from_flax(v))
    with torch.no_grad():
        tl = m(torch.from_numpy(toks).long())
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (2, 12, 128)
    assert np.abs(tl.numpy() - jl).max() <= tol * np.abs(jl).max()
    want = float(j_moe_aux_loss(inter))
    assert abs(float(moe_aux_loss(m)) - want) <= 1e-6 * abs(want)
    got = [float(getattr(m, f"layer_{i}").moe.aux_loss) for i in range(2)]
    leaves = inter["intermediates"]
    np.testing.assert_allclose(
        got, [float(leaves[f"layer_{i}"]["moe"]["moe_aux_loss"][0])
              for i in range(2)], rtol=1e-6)


def test_moe_aux_loss_of_a_dense_model_is_zero_and_decoder_redraws_experts():
    assert float(moe_aux_loss(Decoder(tiny_config()))) == 0.0
    cfg = tiny_config(**MOE)
    a = decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    b = decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k])
               for k in a.state_dict())
    up = a.layer_0.moe.up
    assert abs(float(up.detach().std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    # before a forward no layer has recorded a loss
    assert float(moe_aux_loss(a)) == 0.0
    with torch.no_grad():
        a(torch.zeros(1, 4, dtype=torch.int64))
    assert float(moe_aux_loss(a)) > 0.0
