"""Decoder FP8 training in the port against the JAX package, as
examples/train_fp8.py runs it: three train steps of a tiny decoder
through ``make_train_step`` in both packages (JAX jitted on the CPU, the
port on the CPU through the plain versions), the weights carried across by
``variables_from_flax``, the 8-bit AdamW's moments compared in the JAX
package's layout.

Tolerances, each measured on these runs:

- hybrid-gemm (fp8 on the Dense streams only), f32 compute: the training
  gate of tests/test_torch_training.py (losses 1e-5 relative, parameters
  2e-3, the loss-scale trajectory equal) and 99% of the moment payload
  bytes equal (measured: losses 1.1e-7, parameters 1.2e-4, every byte).
  The three steps' updates (parameters after less before) within 5e-3
  relative L2 and 99.9% of their signs equal (measured 3.0e-4, 99.99%).
- hybrid with hw patching (the whole whitelist: attention BatchMatmuls
  through K2's plain version, every Dense output cast to e4m3 with a
  per-tensor scale), optax.adamw against torch.optim.AdamW.  A one-ulp
  difference of summation order moves a per-tensor amax by an ulp, which
  carries an exact e4m3 tie (a sum of a few products of e4m3 values) to
  the other side: a step of 6-12% of that element.  The SR gradient casts
  then draw other bits for the changed cotangents, so the free-running
  runs part from the first forward (measured: losses 4.9e-4 relative at
  the first step, 1.2e-2 at the third; updates 0.12 relative L2 apart,
  98.6% of their signs equal).  Held to 2e-2 (losses), 1e-2 (parameters),
  0.25 (updates) and 97% (signs).  What this leaves unheld is held by
  ``test_first_step_forced_against_jax``: every Dense, BatchMatmul and
  Embed call of the port is fed the JAX run's own arguments, and then each
  call's output, the loss and every gradient agree to 1e-6 (measured:
  calls 8.2e-8, loss 9.7e-8, gradients 1.5e-7, the weights' bit for
  bit).
- bf16 compute (trap 15: XLA elides bf16 roundings under jit; the
  backward rounds to bf16 after other ops in each framework, and the SR
  casts amplify those one-ulp differences): measured losses 1.4e-3
  relative, parameters 6.1e-3, updates 0.18 relative L2 apart, 98.0% of
  their signs equal; held to 1e-2, 1.5e-2, 0.35 and 96%.  The forced
  first step of the bfloat16 recipe holds its calls bit for bit, its
  loss to 1e-4 and its gradients to 2e-2 (measured 3.7e-5 and 1.0e-2).

A check that a broken port passes holds nothing, so each of these is
shown to fail on a planted fault: no update at all, the gradient casts
dropped, the wtgrad casts dropped, the hw-patched BatchMatmul uncast, and
a BatchMatmul's cotangent cast as an NCHW activation (the port did that
until this check found it: the SR bits then land on other elements).
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from fp8tpu.models.transformer import Decoder as JDecoder
from fp8tpu.models.transformer import DecoderConfig as JConfig
from fp8tpu.models.transformer import moe_aux_loss as j_moe_aux_loss
from fp8tpu.training import mpt as jmpt
from fp8tpu.training import opt8 as jopt8
from fp8tpu_torch import linen
from fp8tpu_torch.models import variables_from_flax, variables_to_flax
from fp8tpu_torch.models.transformer import Decoder as TDecoder
from fp8tpu_torch.models.transformer import DecoderConfig as TConfig
from fp8tpu_torch.models.transformer import moe_aux_loss
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.quant import hw_patch
from fp8tpu_torch.quant import interceptor as interceptor_mod
from fp8tpu_torch.training import adamw_8bit, mpt as tmpt
from fp8tpu_torch.training import opt8 as opt8_mod
from fp8tpu_torch.training.opt8 import _flax_name

STEPS = 3
LR = 1e-3
VOCAB = 64
TIGHT = dict(loss=1e-5, param=2e-3, payload=0.99, update=5e-3, sign=0.999)
WHOLE = dict(loss=2e-2, param=1e-2, payload=None, update=0.25, sign=0.97)
BF16 = dict(loss=1e-2, param=1.5e-2, payload=None, update=0.35, sign=0.96)


def _cfg(dtype="float32", n_experts=0, remat=False):
    return dict(vocab_size=VOCAB, d_model=32, n_layers=1, n_heads=4,
                n_kv_heads=2, d_ff=64, max_seq_len=16, dtype=dtype,
                n_experts=n_experts, remat=remat)


def _tokens():
    return np.random.default_rng(0).integers(0, VOCAB, (2, 9)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(algo, opt8, emb, hw, dtype, moe):
    """Three jitted JAX train steps: (variables before, after, losses,
    loss scales, the optimizer's inner state)."""
    toks = _tokens()
    jm = JDecoder(JConfig(**_cfg(dtype, 4 if moe else 0)))
    v = jm.init(jax.random.key(0), toks[:, :-1])
    emu = jmpt.initialize(jm, v, (toks[:, :-1],), training_algo=algo,
                          emb_fmt=emb)
    if hw:
        emu = dataclasses.replace(emu, policy=emu.policy.with_hw_patching())
    opt = jopt8.adamw_8bit(LR) if opt8 else optax.adamw(LR)

    def loss_fn(apply_fn, params, batch):
        if moe:
            logits, inter = apply_fn(params, batch[:, :-1],
                                     mutable=["intermediates"])
            aux = 0.01 * j_moe_aux_loss(inter)
        else:
            logits, aux = apply_fn(params, batch[:, :-1]), 0.0
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[:, 1:]).mean() + aux

    step = jax.jit(jmpt.make_train_step(emu, opt, loss_fn))
    state = jmpt.init_train_state(opt, v)
    p, losses, scales = v, [], []
    for i in range(STEPS):
        p, state, loss = step(p, state, jnp.asarray(toks),
                              jax.random.fold_in(jax.random.key(1), i))
        losses.append(float(loss))
        scales.append((float(state[1].scale), int(state[1].good_steps)))
    return (jax.tree.map(np.asarray, v), jax.tree.map(np.asarray, p),
            losses, scales, jax.tree.map(np.asarray, state[0]))


def _torch_xent(model, moe):
    def loss_fn(apply_fn, params, batch):
        logits = apply_fn(params, batch[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, VOCAB),
                               batch[:, 1:].reshape(-1))
        return loss + 0.01 * moe_aux_loss(model) if moe else loss
    return loss_fn


def _torch_run(v, algo, opt8, emb, hw, dtype, moe, remat=False):
    tm = TDecoder(TConfig(**_cfg(dtype, 4 if moe else 0, remat)))
    tm.load_state_dict(variables_from_flax(v))
    emu = tmpt.initialize(tm, training_algo=algo, emb_fmt=emb, device="cpu")
    if hw:
        emu = dataclasses.replace(emu, policy=emu.policy.with_hw_patching())
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in tm.named_parameters()}
    opt = (adamw_8bit(params, LR, module_table=emu.module_table) if opt8
           else torch.optim.AdamW(params.values(), lr=LR, weight_decay=1e-4))
    step = tmpt.make_train_step(emu, _torch_xent(tm, moe))
    state = tmpt.init_train_state(opt)
    toks = torch.from_numpy(_tokens()).long()
    losses, scales = [], []
    for i in range(STEPS):
        params, state, loss = step(params, state, toks,
                                   prng.fold_in(prng.key(1), i))
        losses.append(float(loss))
        scales.append((state[1].scale, state[1].good_steps))
    return params, losses, scales, opt


def _update_errors(v0, jp, tparams):
    """(relative L2 distance of the port's updates from the JAX run's,
    share of elements whose update has the same sign) over all leaves."""
    before, want = variables_from_flax(v0), variables_from_flax(jp)
    num = den = 0.0
    same = total = 0
    for k, p0 in before.items():
        dj = (want[k] - p0).double()
        dt = (tparams[k].detach() - p0).double()
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
        same += int((torch.sign(dt) == torch.sign(dj)).sum())
        total += dj.numel()
    return (num / den) ** 0.5, same / total


def _check(jrun, trun, tol):
    v0, jp, jlosses, jscales, jinner = jrun
    tparams, tlosses, tscales, opt = trun
    assert tscales == jscales
    np.testing.assert_allclose(tlosses, jlosses, rtol=tol["loss"])
    want = variables_from_flax(jp)
    assert want.keys() == tparams.keys()
    for k in want:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   want[k].numpy(), rtol=0,
                                   atol=tol["param"], err_msg=k)
    update, sign = _update_errors(v0, jp, tparams)
    assert update <= tol["update"], update
    assert sign >= tol["sign"], sign
    if tol["payload"] is None:
        return
    same = total = 0
    for n, p in tparams.items():
        for which in ("m", "v"):
            node = getattr(jinner[0], which)["params"]
            for part in _flax_name(n, opt.kinds[n]).split("/"):
                node = node[part]
            a = np.asarray(node.payload).view(np.uint8)
            b = opt.state[p][which].payload.view(torch.uint8).numpy()
            same += int((a == b).sum())
            total += a.size
    assert same / total >= tol["payload"], same / total


RUNS = {
    "hybrid-gemm-opt8": ("hybrid-gemm", True, None, False, "float32", False,
                         TIGHT),
    "hybrid-gemm-opt8-emb-e4m3": ("hybrid-gemm", True, "e4m3", False,
                                  "float32", False, TIGHT),
    "hybrid-gemm-opt8-moe": ("hybrid-gemm", True, None, False, "float32",
                             True, TIGHT),
    "hybrid-hw-adamw": ("hybrid", False, None, True, "float32", False,
                        WHOLE),
    "hybrid-gemm-opt8-bf16": ("hybrid-gemm", True, None, False, "bfloat16",
                              False, BF16),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_decoder_train_steps_against_jax(name, monkeypatch):
    *run, tol = RUNS[name]
    algo, opt8, emb, hw, dtype, moe = run
    jrun = _jax_run(*run)
    engine = []
    qdq = hw_patch.qdq_matmul
    monkeypatch.setattr(hw_patch, "qdq_matmul", lambda *a, **kw: (
        engine.append(1), qdq(*a, **kw))[1])
    trun = _torch_run(jrun[0], *run)
    # hw patching: the 2 x 4 (batch x head) slices of both attention
    # BatchMatmuls, one engine GEMM a slice forward and two backward
    assert len(engine) == (STEPS * 3 * 2 * 8 if hw else 0)
    _check(jrun, trun, tol)



@pytest.mark.parametrize("name", ["hybrid-hw-adamw", "hybrid-gemm-opt8-bf16"])
def test_update_checks_fail_without_an_update(name, monkeypatch):
    """The loose recipes' parameters lie within their atol of the JAX
    run's even with no update at all; their update checks do not."""
    *run, tol = RUNS[name]
    jrun = _jax_run(*run)
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    monkeypatch.setattr(opt8_mod.Adam8W, "step",
                        lambda self, closure=None: None)
    trun = _torch_run(jrun[0], *run)
    update, sign = _update_errors(jrun[0], jrun[1], trun[0])
    assert update > tol["update"] and sign < tol["sign"], (update, sign)


# -- the first step with every quantized call fed the JAX run's arguments --

FORCED_MODULES = ("Dense", "BatchMatmul", "Embed")
SCALE = 2.0 ** 12
# case: (training_algo, hw patching, dtype, limits)
FORCED = {
    "hybrid-hw": ("hybrid", True, "float32",
                  dict(loss=1e-6, call=1e-6, grad=1e-6)),
    "bfloat16": ("bfloat16", False, "bfloat16",
                 dict(loss=1e-4, call=0.0, grad=2e-2)),
}


@contextlib.contextmanager
def _jax_recording(paths, calls):
    """Within, the JAX package's quant interceptor appends the path of
    every Dense / BatchMatmul / Embed call to ``paths`` and its arguments
    and output to ``calls`` (under jit, as traced values)."""
    make = jmpt.make_quant_interceptor

    def recording(policy, key=None, **kw):
        quant = make(policy, key=key, **kw)

        def interceptor(next_fun, args, kwargs, context):
            out = quant(next_fun, args, kwargs, context)
            m = context.module
            if (context.method_name == "__call__"
                    and type(m).__name__ in FORCED_MODULES):
                paths.append("/".join(m.path))
                calls.append((args, out))
            return out
        return interceptor

    jmpt.make_quant_interceptor = recording
    try:
        yield
    finally:
        jmpt.make_quant_interceptor = make


@contextlib.contextmanager
def _fed_jax_calls(queue, call_err=None):
    """Within, each Dense / BatchMatmul / Embed call of the port takes the
    arguments of the next (path, args, output) record of the JAX run in
    ``queue`` and passes on that record's output; the port's own output
    keeps the gradient.  ``call_err``, a one-element list, takes the worst
    relative gap between the two outputs."""
    make = tmpt.make_quant_interceptor

    def like(x, t):
        return torch.from_numpy(np.array(x, np.float32)).to(t.dtype)

    def forcing(policy, key=None, **kw):
        quant = make(policy, key=key, **kw)

        def interceptor(next_fun, args, kwargs, context):
            if type(context.module).__name__ not in FORCED_MODULES:
                return quant(next_fun, args, kwargs, context)
            path, jargs, jout = queue.pop(0)
            assert path == context.path
            args = tuple(a + (like(j, a) - a).detach()
                         if a.is_floating_point() else a
                         for a, j in zip(args, jargs))
            out = quant(next_fun, args, kwargs, context)
            want = like(jout, out)
            if call_err is not None:
                call_err[0] = max(call_err[0], float(
                    (out.detach().float() - want.float()).abs().max()
                    / want.float().abs().max()))
            return out + (want - out).detach()
        return interceptor

    tmpt.make_quant_interceptor = forcing
    try:
        yield
    finally:
        tmpt.make_quant_interceptor = make
    assert not queue


@functools.lru_cache(maxsize=None)
def _jax_first_step(algo, hw, dtype):
    """The gradient half of the JAX package's first train step, jitted:
    (variables, loss, gradients by the port's names, and the arguments and
    output of every Dense / BatchMatmul / Embed call through the quant
    interceptor, in call order)."""
    toks = _tokens()
    jm = JDecoder(JConfig(**_cfg(dtype)))
    v = jm.init(jax.random.key(0), toks[:, :-1])
    emu = jmpt.initialize(jm, v, (toks[:, :-1],), training_algo=algo)
    if hw:
        emu = dataclasses.replace(emu, policy=emu.policy.with_hw_patching())
    paths, calls = [], []

    def grads_of(params, batch, key):
        kf, kg, _ = jax.random.split(key, 3)

        def loss_of(p):
            calls.clear()
            logits = emu.apply_quantized(p, batch[:, :-1], key=kf)
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, batch[:, 1:]).mean()
            return loss * SCALE, list(calls)

        (loss, rec), grads = jax.value_and_grad(loss_of, has_aux=True)(
            params)
        grads = emu.quantize_grads(grads, kg)
        return loss / SCALE, jax.tree.map(
            lambda g: (g / SCALE).astype(g.dtype), grads), rec

    with _jax_recording(paths, calls):
        loss, grads, rec = jax.jit(grads_of)(
            v, jnp.asarray(toks), jax.random.fold_in(jax.random.key(1), 0))
    rec = [(path, jax.tree.map(np.asarray, a), np.asarray(o))
           for path, (a, o) in zip(paths[-len(rec):], rec)]
    return (jax.tree.map(np.asarray, v), float(loss),
            variables_from_flax(jax.tree.map(np.asarray, grads)), rec)


def _forced_errors(case):
    """The port's first step with each Dense / BatchMatmul / Embed call
    given the JAX call's arguments and passing on the JAX call's output
    (the port's own output keeps the gradient): (loss, worst call output,
    worst gradient leaf), each relative."""
    algo, hw, dtype, _ = FORCED[case]
    v, jloss, jgrads, rec = _jax_first_step(algo, hw, dtype)
    tm = TDecoder(TConfig(**_cfg(dtype)))
    tm.load_state_dict(variables_from_flax(v))
    emu = tmpt.initialize(tm, training_algo=algo, device="cpu")
    if hw:
        emu = dataclasses.replace(emu, policy=emu.policy.with_hw_patching())
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in tm.named_parameters()}
    call_err = [0.0]
    with _fed_jax_calls(list(rec), call_err):
        loss, grads = tmpt.step_grads(
            emu, _torch_xent(tm, False), params,
            torch.from_numpy(_tokens()).long(),
            prng.fold_in(prng.key(1), 0), SCALE)
    grad_err = max(float((grads[k].float() - g.float()).norm()
                         / g.float().norm()) for k, g in jgrads.items())
    return abs(float(loss) - jloss) / jloss, call_err[0], grad_err


@pytest.mark.parametrize("case", list(FORCED))
def test_first_step_forced_against_jax(case):
    """Fed the JAX run's arguments at every Dense, BatchMatmul and Embed
    call, the port's calls, loss and gradients (SR casts, hw patching and
    the wtgrad casts included) agree with the JAX package's: the free
    running gap of the whole-whitelist recipe is the propagation of
    one-ulp differences, not a different function."""
    lim = FORCED[case][3]
    loss, call, grad = _forced_errors(case)
    assert loss <= lim["loss"], loss
    assert call <= lim["call"], call
    assert grad <= lim["grad"], grad


PLANTED = {
    "gradient-casts-dropped": (interceptor_mod, "grad_cast",
                               lambda x, cfg, key, nchw=True, shard=None: x),
    "wtgrad-casts-dropped": (tmpt, "quantize_wtgrads",
                             lambda grads, *a: grads),
    "engine-uncast": (hw_patch, "patched_matmul",
                      lambda a, b, cfg, seed=0, shard=None, shard_b=None:
                      a @ b),
    "bmm-cotangent-as-nchw": (
        interceptor_mod, "_in_jax_layout",
        lambda fn, a, cfg, nchw=True, _f=interceptor_mod._in_jax_layout:
        _f(fn, a, cfg, True)),
}


@pytest.mark.parametrize("fault", list(PLANTED))
def test_forced_check_fails_on_planted_fault(fault, monkeypatch):
    monkeypatch.setattr(*PLANTED[fault])
    lim = FORCED["hybrid-hw"][3]
    loss, call, grad = _forced_errors("hybrid-hw")
    assert (loss > lim["loss"] or call > lim["call"]
            or grad > lim["grad"]), (loss, call, grad)


EMB_CFG = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4,
               n_kv_heads=2, d_ff=128, max_seq_len=32, dtype="float32")


def _emb_setup(draw):
    """The 4-layer decoder of the e4m3-embedding tests, its Dense weights
    drawn by ``linen.init_params`` from a generator seeded with ``draw``
    (not the global RNG: the draw must not depend on which tests ran
    before in the process), its embedding at the large preset's init
    scale: (tokens, port emulator, port params, JAX variables, JAX
    emulator, both packages' e4m3-requantized params)."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 33)).astype(np.int32)
    tm = linen.init_params(TDecoder(TConfig(**EMB_CFG)),
                           torch.Generator().manual_seed(draw))
    with torch.no_grad():
        tm.embed.embedding.copy_(torch.from_numpy(
            rng.standard_normal((256, 64)).astype(np.float32) * 768 ** -0.5))
    temu = tmpt.initialize(tm, training_algo="hybrid-gemm", device="cpu")
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    v = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                     variables_to_flax(params, temu.module_table))
    jm = JDecoder(JConfig(**EMB_CFG))
    emu = jmpt.initialize(jm, v, (toks[:, :-1],), training_algo="hybrid-gemm")
    vq = jax.jit(lambda p: jmpt.master_requant(
        p, emu.module_table, jax.random.key(3), "fp16", "e4m3"))(v)
    pq = tmpt.master_requant(params, temu.module_table, prng.key(3),
                             "fp16", "e4m3")
    return toks, temu, params, v, emu, vq, pq


def _emb_jgrad(emu, toks, record=None):
    """The JAX package's jitted embedding gradient of the loss; with
    ``record``, a list, also the (path, arguments, output) of every Dense
    / BatchMatmul / Embed call, appended to it in call order."""
    paths, calls = [], []

    def loss_of(p):
        calls.clear()
        logits = emu.apply_quantized(p, toks[:, :-1], key=jax.random.key(2))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, toks[:, 1:]).mean(), list(calls)

    @jax.jit
    def jgrad(params):
        (_, rec), g = jax.value_and_grad(loss_of, has_aux=True)(params)
        return g["params"]["embed"]["embedding"], rec

    def run(params):
        with _jax_recording(paths, calls):
            g, rec = jgrad(params)
        if record is not None:
            record.extend((path, jax.tree.map(np.asarray, a), np.asarray(o))
                          for path, (a, o) in zip(paths[-len(rec):], rec))
        return np.asarray(g)
    return run


def _emb_tgrad(temu, toks, params, forced=None):
    """The port's embedding gradient of the loss; with ``forced``, a JAX
    record of ``_emb_jgrad``, fed the JAX calls (``_fed_jax_calls``)."""
    p = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    with (_fed_jax_calls(list(forced)) if forced is not None
          else contextlib.nullcontext()):
        loss = F.cross_entropy(
            temu.apply_quantized(p, torch.from_numpy(toks[:, :-1]).long(),
                                 key=prng.key(2)).reshape(-1, 256),
            torch.from_numpy(toks[:, 1:]).long().reshape(-1))
        return torch.autograd.grad(loss, p["embed.embedding"])[0].numpy()


def test_e4m3_embedding_requant_explodes_its_gradient_in_both_packages():
    """Why the large decoder's 8-bit AdamW takes NaN codes at its second
    step on the card (ROADMAP trap 67): ``emb_fmt="e4m3"``'s row-wise
    block-norm requant (scale 2^floor(log2 amax) / 4, multiplied in)
    puts an embedding of the large preset's init scale (std 768^-0.5)
    into e4m3's flush range, zeroing most rows, and each RMSNorm then
    divides those tokens' gradients by their tiny norms, layer after
    layer.  The JAX package does the same: at 4 layers the embedding's
    largest gradient grows 2.2e10-fold in both packages, to the same
    value (measured 0.2321 to 5.1128e9 in both; printed with -s); at 12
    layers its square overflows f32.  "The same value" holds free-running
    for this draw of the Dense weights (draw 0), not for every draw: see
    ``test_e4m3_embedding_gradient_fed_the_jax_calls_is_jax_s``."""
    toks, temu, params, v, emu, vq, pq = _emb_setup(0)
    emb = pq["embed.embedding"]
    np.testing.assert_array_equal(
        emb.numpy(), np.asarray(vq["params"]["embed"]["embedding"]))
    assert int((emb.abs().amax(1) == 0).sum()) >= 128

    jgrad = _emb_jgrad(emu, toks)
    before = (float(np.abs(jgrad(v)).max()),
              float(np.abs(_emb_tgrad(temu, toks, params)).max()))
    after = (float(np.abs(jgrad(vq)).max()),
             float(np.abs(_emb_tgrad(temu, toks, pq)).max()))
    print(f"largest embedding gradient (JAX, port): before {before}, "
          f"after {after}")
    assert after[0] > 1e8 * before[0] and after[1] > 1e8 * before[1]
    assert abs(after[1] - after[0]) <= 1e-3 * after[0], (before, after)


def test_e4m3_embedding_gradient_fed_the_jax_calls_is_jax_s():
    """The exploded embedding gradient is the same function of the same
    casts in both packages, also for the one draw of the Dense weights in
    200 where the free-running runs part: fed the JAX run's arguments and
    outputs at every Dense, BatchMatmul and Embed call, the port's
    gradient for draw 55 equals the JAX package's up to summation order
    (measured 2.4e-8 relative L2; held to 1e-6).  Free-running, draw 0
    agrees to 1e-7 (the test above), and so do 199 of draws 0-199 to 3e-5;
    draw 55 does not (6.5% on the largest element, 0.148 relative L2;
    printed with -s).  There a one-ulp difference of summation order puts
    one element of layer 2's down_proj input at 7.7500005 of its e4m3
    grid in the port and at 7.749995 in the JAX package, one either side
    of the tie between 7.5 and 8; that one code, 6.5% of its element, is
    then divided by the tiny norms of the backward like every other
    (ROADMAP trap 82)."""
    toks, temu, _, _, emu, vq, pq = _emb_setup(55)
    record = []
    jg = _emb_jgrad(emu, toks, record)(vq)
    free = _emb_tgrad(temu, toks, pq)
    forced = _emb_tgrad(temu, toks, pq, forced=record)
    rel = [float(np.linalg.norm(t - jg) / np.linalg.norm(jg))
           for t in (free, forced)]
    gap = abs(float(np.abs(free).max()) / float(np.abs(jg).max()) - 1)
    print(f"draw 55: largest embedding gradient {np.abs(jg).max():.6g}"
          f" (JAX); free-running {gap:.3g} apart, relative L2 {rel[0]:.3g};"
          f" fed the JAX calls {rel[1]:.3g}")
    assert float(np.abs(jg).max()) > 1e9
    assert rel[1] <= 1e-6, rel


def test_remat_is_bit_equal_and_needs_the_interceptor(monkeypatch):
    """remat=True (torch.utils.checkpoint per layer) trains bit for bit
    like remat=False under the whole-whitelist hybrid recipe, SR gradient
    casts included.  The recompute runs during the backward, after the
    interceptor's context has exited; with the interceptors not handed
    back to it (the mutation below) the parameters come out different."""
    v = _jax_run("hybrid-gemm", True, None, False, "float32", False)[0]
    cfg = dict(opt8=True, emb=None, hw=False, dtype="float32", moe=False)
    base = _torch_run(v, "hybrid", **cfg)[0]
    rem = _torch_run(v, "hybrid", **cfg, remat=True)[0]
    for k in base:
        assert torch.equal(base[k], rem[k]), k
    monkeypatch.setattr(linen, "_interceptors",
                        lambda state: linen.contextlib.nullcontext())
    broken = _torch_run(v, "hybrid", **cfg, remat=True)[0]
    assert not all(torch.equal(base[k], broken[k]) for k in base)


def test_overflow_is_a_true_skip_with_the_8bit_optimizer():
    """A non-finite loss: parameters, both moments (payloads and scales)
    and the optimizer's count stay bit-identical, and the scale halves."""
    v = _jax_run("hybrid-gemm", True, None, False, "float32", False)[0]
    tm = TDecoder(TConfig(**_cfg()))
    tm.load_state_dict(variables_from_flax(v))
    emu = tmpt.initialize(tm, training_algo="hybrid-gemm", device="cpu")
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in tm.named_parameters()}
    opt = adamw_8bit(params, LR, module_table=emu.module_table)
    xent = _torch_xent(tm, False)

    def loss_fn(apply_fn, params, batch):
        toks, poison = batch
        return xent(apply_fn, params, toks) * poison

    step = tmpt.make_train_step(emu, loss_fn)
    state = tmpt.init_train_state(opt)
    toks = torch.from_numpy(_tokens()).long()
    params, state, _ = step(params, state, (toks, torch.tensor(1.0)),
                            prng.key(0))
    before = {k: p.detach().clone() for k, p in params.items()}
    moments = {k: [t.clone() for w in ("m", "v") for t in opt.state[p][w]]
               for k, p in params.items()}
    params, state, loss = step(params, state,
                               (toks, torch.tensor(float("nan"))),
                               prng.key(1))
    assert not np.isfinite(float(loss))
    assert state[1] == tmpt.LossScaleState(2.0 ** 11, 0)
    assert opt.count == 1
    for k, p in params.items():
        assert torch.equal(p, before[k]), k
        now = [t for w in ("m", "v") for t in opt.state[p][w]]
        for a, b in zip(now, moments[k]):
            assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                               else a, b.view(torch.uint8)
                               if b.element_size() == 1 else b), k
