"""AWQ equalization (fp8tpu_torch/quant/awq.py) against the JAX package's
(fp8tpu/quant/awq.py), on the setup of tests/test_awq.py: the tiny f32
decoder (2 layers) and 8 x 32 calibration tokens, the same variables on
both sides (variables_from_flax).

One difference is not the port's to remove: ``a ** alpha`` (the candidate
scales) is XLA's pow on the JAX side and torch's on the port's, and the
two differ in the last bit for a few channels (1-3 of 128 here).  A scale
one ulp off can move a weight across a rounding boundary of the grid, and
that site's MSE by up to ~1e-3 relative; so per-alpha errors are held to
1e-4 where the two scales agree bit for bit, and to 1e-2 where they do
not (counted)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu.models import Decoder as JDecoder
from fp8tpu.models import tiny_config as j_tiny_config
from fp8tpu.quant import awq as jawq
from fp8tpu.serve import ServeConfig as JServeConfig
from fp8tpu.serve import convert_decoder_params as j_convert
from fp8tpu.serve.model import full_logits as j_full_logits
from fp8tpu_torch.models import Decoder, tiny_config, variables_from_flax
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.quant import awq
from fp8tpu_torch.serve import ServeConfig, convert_decoder_params
from fp8tpu_torch.serve import full_logits

ERR_RTOL = 1e-4          # per-alpha MSE where both sides' scales agree
POW_RTOL = 1e-2          # where torch's and XLA's a ** alpha differ
ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0)


@functools.lru_cache(maxsize=None)
def _setup(n_experts=0):
    kw = dict(dtype="float32", n_layers=2 if not n_experts else 1,
              n_experts=n_experts)
    jcfg, tcfg = j_tiny_config(**kw), tiny_config(**kw)
    jm = JDecoder(jcfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                              jcfg.vocab_size)
    v = jm.init(jax.random.PRNGKey(0), toks[:1])
    tm = Decoder(tcfg)
    sd = variables_from_flax(jax.tree.map(np.asarray, v))
    tm.load_state_dict(sd)
    return jcfg, tcfg, jm, v, tm, sd, np.asarray(toks)


@functools.lru_cache(maxsize=None)
def _stats():
    jcfg, tcfg, jm, v, tm, sd, toks = _setup()
    js = jawq.collect_awq_stats(jm, v, [toks[:4], toks[4:8]], n_sample=64)
    ts = awq.collect_awq_stats(tm, sd, [torch.from_numpy(toks[:4]),
                                        torch.from_numpy(toks[4:8])],
                               n_sample=64)
    return js, ts


def _to_torch(js):
    return {li: {s: {k: torch.from_numpy(np.asarray(x)) for k, x in d.items()}
                 for s, d in st.items()} for li, st in js.items()}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def test_sample_indices_are_jax_choice():
    """The row sample of each site: ``choice(split(key)[1], rows, n,
    replace=False)`` along the JAX package's key chain (layers in order,
    sites sorted), bit-equal indices."""
    kj, kt = jax.random.PRNGKey(0), prng.key(0)
    for _ in range(6):                       # 2 layers x 3 sites
        kj, subj = jax.random.split(kj)
        kt, subt = prng.split(kt)
        want = np.asarray(jax.random.choice(subj, 128, (64,), replace=False))
        np.testing.assert_array_equal(prng.choice(subt, 128, 64).numpy(),
                                      want)


def test_collect_stats_match_jax():
    """Per-site amax over both batches and the sampled rows (the same rows:
    every sampled row within f32 summation order of JAX's)."""
    js, ts = _stats()
    assert set(ts) == set(js) == {0, 1}
    for li in js:
        assert set(ts[li]) == set(js[li]) == {"qkv", "gateup", "down"}
        for site, rec in js[li].items():
            for key in ("amax", "x"):
                want = np.asarray(rec[key])
                got = ts[li][site][key].numpy()
                assert got.shape == want.shape
                assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("fmt,group", [("e4m3", 128), ("int8", 128),
                                       ("int4", None), ("int4", 32)])
def test_site_errors_and_alpha_match_jax(fmt, group):
    """_search_site_scale on the same (JAX) stats and weights: per-alpha
    errors within ERR_RTOL where both sides' scales agree bit for bit
    (POW_RTOL elsewhere, counted), the chosen alpha equal wherever JAX's
    best two errors differ by more than ERR_RTOL, and never worse than
    identity."""
    jcfg, tcfg, jm, v, tm, sd, toks = _setup()
    js, _ = _stats()
    p = v["params"]
    sites = []
    for li in js:
        lp = p[f"layer_{li}"]
        sites += [(li, "qkv", [lp["attn"][n]["kernel"] for n in
                               ("q_proj", "k_proj", "v_proj")]),
                  (li, "gateup", [lp["mlp"][n]["kernel"] for n in
                                  ("gate_proj", "up_proj")]),
                  (li, "down", [lp["mlp"]["down_proj"]["kernel"]])]
    pow_differs = ties = 0
    for li, site, ws in sites:
        st = js[li][site]
        _, jinfo = jawq._search_site_scale(ws, st["amax"], st["x"], fmt,
                                           group, ALPHAS)
        ts, tinfo = awq._search_site_scale(
            [torch.from_numpy(np.asarray(w)) for w in ws],
            torch.from_numpy(np.asarray(st["amax"])),
            torch.from_numpy(np.asarray(st["x"])), fmt, group, ALPHAS)
        amax = jnp.asarray(st["amax"])
        a = jnp.where(amax > 0, amax, jnp.mean(jnp.where(amax > 0, amax, 1.)))
        a = a / jnp.mean(a)
        at = torch.from_numpy(np.asarray(a))
        for al in ALPHAS:
            same = np.array_equal(
                np.asarray(jnp.clip(a ** al, 1e-3, 1e3)),
                torch.clip(at ** al, 1e-3, 1e3).numpy())
            pow_differs += not same
            rel = abs(tinfo["errs"][al] - jinfo["errs"][al]) \
                / jinfo["errs"][al]
            assert rel <= (ERR_RTOL if same else POW_RTOL), (li, site, al, rel)
        errs = sorted(jinfo["errs"].values())
        if errs[1] - errs[0] > ERR_RTOL * errs[0]:
            assert tinfo["alpha"] == jinfo["alpha"], (li, site)
        else:
            ties += 1
            assert tinfo["errs"][tinfo["alpha"]] <= errs[0] * (1 + ERR_RTOL)
        assert tinfo["err"] <= tinfo["err_identity"]
    assert pow_differs <= len(sites) * len(ALPHAS) // 2 and ties <= 2


# The folded tensors of a site, and the axis of each that runs over the
# site's input channels (a state_dict weight is (out, in)).
FOLDS = {"qkv": [("attn_norm.scale", 0), ("attn.q_proj.weight", 1),
                 ("attn.k_proj.weight", 1), ("attn.v_proj.weight", 1)],
         "gateup": [("mlp_norm.scale", 0), ("mlp.gate_proj.weight", 1)],
         "down": [("mlp.down_proj.weight", 1), ("mlp.up_proj.weight", 0)]}


@pytest.mark.parametrize("fmt,group", [("e4m3", 128), ("int4", 32)])
def test_equalize_from_jax_stats_matches_jax(fmt, group):
    """awq_equalize fed the JAX stats: the alphas equal, each site's scale
    within 2 f32 ulps of JAX's (``mean(a)`` sums in another order, and
    ``a ** alpha`` is another pow), and every folded tensor bit-equal to
    the JAX equalized variables on the channels whose scale is bit-equal
    (counted: most of them), within 3 ulps on the others."""
    jcfg, tcfg, jm, v, tm, sd, toks = _setup()
    js, _ = _stats()
    jv, jinfo = jawq.awq_equalize(v, jcfg, js, fmt=fmt, int4_group=group)
    tv, tinfo = awq.awq_equalize(dict(sd), tcfg, _to_torch(js), fmt=fmt,
                                 int4_group=group)
    want = variables_from_flax(jax.tree.map(np.asarray, jv))
    assert set(tv) == set(want)
    for name in want:
        assert _ulps(tv[name], want[name]) <= 3, name
    p = v["params"]
    agree = {}
    for layer, sites in jinfo.items():
        lp = p[layer]
        for site, rec in sites.items():
            assert tinfo[layer][site]["alpha"] == rec["alpha"]
            ws = {"qkv": [lp["attn"][n]["kernel"] for n in
                          ("q_proj", "k_proj", "v_proj")],
                  "gateup": [lp["mlp"][n]["kernel"] for n in
                             ("gate_proj", "up_proj")],
                  "down": [lp["mlp"]["down_proj"]["kernel"]]}[site]
            st = js[int(layer.split("_")[1])][site]
            sj, _ = jawq._search_site_scale(ws, st["amax"], st["x"], fmt,
                                            group, ALPHAS)
            s_t, _ = awq._search_site_scale(
                [torch.from_numpy(np.asarray(w)) for w in ws],
                torch.from_numpy(np.asarray(st["amax"])),
                torch.from_numpy(np.asarray(st["x"])), fmt, group, ALPHAS)
            sj = torch.from_numpy(np.asarray(sj))
            assert _ulps(s_t, sj) <= 2
            agree[layer, site] = s_t == sj
    equal = total = 0
    for (layer, site), ok in agree.items():
        for leaf, axis in FOLDS[site]:
            key = f"{layer}.{leaf}"
            mask = ok
            if leaf == "mlp.up_proj.weight":      # folded by gateup too
                g, w = tv[key][ok][:, agree[layer, "gateup"]], \
                    want[key][ok][:, agree[layer, "gateup"]]
            elif axis == 1:
                g, w = tv[key][:, mask], want[key][:, mask]
            else:
                g, w = tv[key][mask], want[key][mask]
            assert torch.equal(g, w), key
        equal += int(ok.sum())
        total += ok.numel()
    assert equal >= 0.75 * total, (equal, total)   # measured 0.82-1.0


@pytest.mark.parametrize("fmt,group", [("e4m3", 128), ("int4", None)])
def test_calibrate_is_output_invariant_and_never_regresses(fmt, group):
    """tests/test_awq.py::test_fold_is_output_invariant and
    ::test_objective_never_regresses on the port."""
    jcfg, tcfg, jm, v, tm, sd, toks = _setup()
    t = torch.from_numpy(toks).long()
    eq, info = awq.awq_calibrate_decoder(tm, sd, tcfg, t, fmt=fmt,
                                         int4_group=group, batch=4,
                                         n_batches=2)
    with torch.no_grad():
        base = tm(t)
        got = torch.func.functional_call(tm, eq, (t,))
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert set(info) == {"layer_0", "layer_1"}
    assert set(info["layer_0"]) == {"qkv", "gateup", "down"}
    for linfo in info.values():
        for rec in linfo.values():
            assert rec["err"] <= rec["err_identity"] * (1 + 1e-6)


@pytest.mark.parametrize("fmt,group", [("e4m3", 128), ("int4", 32)])
def test_awq_artifacts_match_jax(fmt, group):
    """The whole path on both sides (calibrate, convert): payload bytes
    equal on at least 0.99 of the bytes, and each side's serving logits
    within the serving tolerance of the other's."""
    jcfg, tcfg, jm, v, tm, sd, toks = _setup()
    jv, _ = jawq.awq_calibrate_decoder(jm, v, jcfg, toks, fmt=fmt,
                                       int4_group=group, batch=4,
                                       n_batches=2)
    tv, _ = awq.awq_calibrate_decoder(tm, sd, tcfg, torch.from_numpy(toks),
                                      fmt=fmt, int4_group=group, batch=4,
                                      n_batches=2)
    jp = j_convert(jv, jcfg, fmt, int4_group=group)
    tp = convert_decoder_params(tv, tcfg, fmt, int4_group=group)
    for key in ("q8", "gate8", "down8"):
        a = tp[key].contiguous().view(torch.uint8).numpy()
        b = np.ascontiguousarray(np.asarray(jp[key])).view(np.uint8)
        assert (a == b).mean() >= 0.99, key
    seq = toks[0]
    kw = dict(weight_fmt=fmt, kv_fmt="bf16", int4_group=group)
    jcfg_bf16 = jcfg.__class__(**{**jcfg.__dict__, "dtype": "bfloat16"})
    want = np.asarray(j_full_logits(jp, jnp.asarray(seq),
                                    JServeConfig(model=jcfg_bf16, **kw)))
    tcfg_bf16 = tcfg.__class__(**{**tcfg.__dict__, "dtype": "bfloat16"})
    got = full_logits(tp, torch.from_numpy(seq), ServeConfig(
        model=tcfg_bf16, **kw)).numpy()
    assert np.abs(got - want).max() <= 4e-2 * np.abs(want).max()


def test_moe_layers_equalize_attention_only():
    jcfg, tcfg, jm, v, tm, sd, toks = _setup(n_experts=4)
    t = torch.from_numpy(toks[:4]).long()
    eq, info = awq.awq_calibrate_decoder(tm, sd, tcfg, t, fmt="e4m3",
                                         batch=4, n_batches=1)
    assert set(info["layer_0"]) == {"qkv"}
    with torch.no_grad():
        np.testing.assert_allclose(
            torch.func.functional_call(tm, eq, (t,)).numpy(),
            tm(t).numpy(), rtol=2e-4, atol=2e-4)
    assert eq["layer_0.moe.up"] is sd["layer_0.moe.up"]
