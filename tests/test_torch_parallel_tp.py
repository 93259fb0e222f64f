"""Tensor parallelism inside the port's decoder against the JAX package,
on the CPU: the TP-sharded PTQ forward (``quantized_apply(mesh=)`` on
``models.Decoder(cfg, mesh=)``), the TP-sharded serving engine, ring and
self-draft speculative paged (``ServingEngine(mesh=)``), and the
model-parallel training step with sequence parallelism
(``initialize(mesh=)``, ``make_train_step``).

Everything that issues collectives runs in one world of eight gloo ranks,
spawned once for this file as ``tests/test_torch_parallel.py`` spawns its
own: each rank is this file run as a script (torch and the port only,
never JAX), every collective has a 60 s process-group timeout, and each
rank writes its results to an npz.  The single-process references and
the JAX package's runs (on the conftest's eight virtual CPU devices)
happen in the pytest process meanwhile.
Parameters and tokens come from numpy seeds; the configurations are the
JAX tests' own (``tests/test_parallel.py``'s decoder, ``tests/
test_engine_sharded.py``'s engine).

Limits (PERF.md §2, the TP rows):

- 7a, data 2 x model 4, e4m3 PTQ: each rank's quantized weight shards
  bit-equal to its slices of the JAX package's quantized weights; the
  logits against JAX's sharded and unsharded forward by the JAX test's
  gates (correlation > 0.998, argmax agreement > 0.95) on the JAX test's
  tokens (all ones), and on drawn tokens (where JAX's own sharded forward
  reads 0.99772 / 0.906 against its unsharded one, trap 66) no farther
  from JAX than JAX's sharded forward is; against the
  port's single-process forward within 2e-3 of max|logit| (measured: bit
  for bit, 0.0; a row-parallel sum rounded another way could carry an
  e4m3 tie, trap 66, so the limit is the call-by-call one); call by call
  (every Dense / BatchMatmul / Embed call fed the rank's shard of the
  single-process call's arguments) the quantized inputs and weights bit
  for bit and the outputs within 2e-3 of max|out|; a rank-local amax on a
  row-parallel input and a rank-local per-row scale on a column-parallel
  kernel each fail that check.
- 7b: the ring engine over data 2 x model 4 and the self-draft paged
  engine over model 8 (k_spec 3; the ring view on the JAX test's random
  artifact, K4's page walk on the drawn model) give the
  port's single-process engines' tokens, greedy and sampled, on every
  rank alike, with the single-process engine's speculation counts
  (``spec_accepted == spec_drafted`` on the JAX test's own random
  artifact), and JAX's
  single-device engines' tokens by the margin rule (where they part, the
  top-2 margin of the port's teacher-forced logits is within twice 4e-2
  of max|logit|, as ``tests/test_torch_engine.py``); ``decode_step`` over
  data 2 x model 2 (the decoder config, two hosts of it) and data 2 x
  model 4 (the engine config) within 4e-3 of max|logit| of the unsharded
  step (trap 15's un-jitted limit; measured: bit for bit).
- 7c, the model-parallel training step over data 2 x seq 2 x model 2 (the
  JAX test's mesh; 15 positions in chunks of 8 and 7): the SR casts of a
  split tensor bit-equal to the single-process cast and to JAX's (both
  streams, both impls); the JAX test's hybrid SGD step by its gates
  against JAX's replicated and GSPMD steps (loss 1%, q_proj correlation
  0.9999, atol 2e-3), on drawn tokens within twice JAX's own GSPMD
  distance; against the port's single-process step: uncast f32 within
  1e-5, free running (hybrid, hybrid-gemm, bfloat16, and hybrid with hw
  patching) losses 1e-5 relative and parameters 2e-3, call by call every
  cast bit-equal to the block of the single call's output and its own
  input within 2e-2 of max|input|, each of three planted faults failing
  that; an overflow on one rank skips the step on every rank; the 8-bit
  AdamW on split leaves, and checkpoints both ways, byte for byte;
  ``train_fp8`` over data 4 x model 2 against the single-process script,
  losses 1e-2 relative (bf16 compute).
- The casts of a split tensor (every scaling kind; rows over data, columns
  over model, or both): the whole tensor's cast, bit for bit, on a 1/8 grid
  where every sum is exact; fine-grained, per-block and integer scaling of
  a model-split tensor raise.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

WORLD = 8
TIMEOUT = 240          # seconds for the whole world, start to finish
PG_TIMEOUT = 60        # seconds for any one collective
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# tests/test_parallel.py's decoder and tests/test_engine_sharded.py's engine
DEC = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab_size=256, max_seq_len=32)
ENG = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
           vocab_size=128, max_seq_len=96)
DATA, MODEL = 2, 4               # 7a's mesh and the ring engine's
LOGIT_TOL = 2e-3                 # of max|logit| / max|out|
STEP_TOL = 4e-3                  # decode_step, of max|logit|
MARGIN_TOL = 4e-2                # the margin rule's logit tolerance
N_REQ, NEW, TEMP = 3, 6, 0.8
TOKENS = ("ones", "draw")
PLANTS = ("row-input-local-amax", "column-kernel-local-row-scale")
# the casts of a split tensor: (8, 64) on a 1/8 grid (every sum exact),
# its rows over the data group, its columns over the model group, or both
CASTS = {"per-tensor": dict(scaling="per-tensor"),
         "per-tensor-mean": dict(scaling="per-tensor-mean"),
         "per-channel-rows": dict(scaling="per-channel"),
         "per-channel-cols": dict(scaling="per-channel", channel_axis=1),
         "per-channel-mean": dict(scaling="per-channel-mean"),
         "int8": dict(dtype="int8"),
         "fine-grained": dict(scaling="fine-grained", group_size=4),
         "per-block": dict(scaling="per-block", block_size=32)}
SPLITS = ("batch-shard", "data", "model", "data-and-model")
RAISES_MODEL_SPLIT = ("int8", "fine-grained", "per-block")
STEP_MESHES = {"data2-model2": (DEC, dict(hosts=2, data=2, model=2)),
               "data2-model4": (ENG, dict(data=2, model=4))}


# -- inputs, the same in the workers and the parent -------------------------

def flax_vars(kw, seed):
    """A Flax decoder's variables (``params`` only) drawn with numpy: Dense
    kernels (in, out) at 1/sqrt(in), the embedding at 1/sqrt(d_model), the
    norms' scales about 1."""
    rng = np.random.default_rng(seed)
    dm, ff, V = kw["d_model"], kw["d_ff"], kw["vocab_size"]
    D = dm // kw["n_heads"]
    hd, kvd = kw["n_heads"] * D, kw["n_kv_heads"] * D

    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    def scale():
        return (1 + 0.1 * rng.standard_normal(dm)).astype(np.float32)

    p = {"embed": {"embedding": (rng.standard_normal((V, dm))
                                 / np.sqrt(dm)).astype(np.float32)}}
    for i in range(kw["n_layers"]):
        p[f"layer_{i}"] = {
            "attn_norm": {"scale": scale()},
            "attn": {"q_proj": {"kernel": w(dm, hd)},
                     "k_proj": {"kernel": w(dm, kvd)},
                     "v_proj": {"kernel": w(dm, kvd)},
                     "o_proj": {"kernel": w(hd, dm)}},
            "mlp_norm": {"scale": scale()},
            "mlp": {"gate_proj": {"kernel": w(dm, ff)},
                    "up_proj": {"kernel": w(dm, ff)},
                    "down_proj": {"kernel": w(ff, dm)}}}
    p["final_norm"] = {"scale": scale()}
    return {"params": p}


def dec_tokens(which="draw"):
    """tests/test_parallel.py's tokens (all ones), or a draw."""
    if which == "ones":
        return np.ones((4, 16), np.int32)
    return np.random.default_rng(7).integers(
        0, DEC["vocab_size"], (4, 16)).astype(np.int32)


def requests(temperature=0.0):
    """tests/test_engine_sharded.py's requests (greedy, or sampled)."""
    from fp8tpu_torch.serve import Request
    return [Request(uid=i, prompt=[2 + i, 7, 11], max_new_tokens=NEW,
                    temperature=temperature) for i in range(N_REQ)]


def torch_cfg(kw):
    from fp8tpu_torch.models import tiny_config
    return tiny_config(**kw)


def serve_params(kw, seed):
    """The port's e4m3 serving artifact of ``flax_vars(kw, seed)``."""
    from fp8tpu_torch.models import variables_from_flax
    from fp8tpu_torch.serve import convert_decoder_params
    return convert_decoder_params(variables_from_flax(flax_vars(kw, seed)),
                                  torch_cfg(kw))


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _tokens(out):
    return np.array([out[i] for i in range(N_REQ)], np.int64)


# -- the worker: 7a ---------------------------------------------------------

def _records(model, params, toks, mesh, feed=None):
    """Every Dense / BatchMatmul / Embed call of a quantized forward of
    ``model`` (e4m3 PTQ, the weights in ``params`` already quantized): its
    path, arguments, quantized inputs (what the module body received), the
    module's weight as bound, and its output.  ``feed(path, args)`` may
    replace a call's arguments before the casts."""
    from torch.func import functional_call
    from fp8tpu_torch import linen
    from fp8tpu_torch.quant.interceptor import (classify_module,
                                                make_quant_interceptor)
    from fp8tpu_torch.quant.policy import LayerKind, e4m3_inference_policy
    quant = make_quant_interceptor(e4m3_inference_policy(), mesh=mesh)
    kinds = (LayerKind.DENSE, LayerKind.BATCH_MATMUL, LayerKind.EMBED)
    calls = []

    def outer(next_fun, args, kwargs, ctx):
        if classify_module(ctx.module) not in kinds:
            return quant(next_fun, args, kwargs, ctx)
        if feed is not None:
            args = feed(ctx, args)
        rec = {"path": ctx.path, "module": ctx.module, "args": args}

        def body(*a, **kw):
            rec["q"] = list(a)
            w = getattr(ctx.module, "weight", None)
            if w is not None:
                rec["q"].append(w.detach().clone())
            return next_fun(*a, **kw)

        rec["out"] = quant(body, args, kwargs, ctx)
        calls.append(rec)
        return rec["out"]

    with torch.no_grad(), linen.intercept_methods(outer, model):
        logits = functional_call(model, params, (toks,))
    return calls, logits


def _shard_of(t, module, which, d, b, m, T):
    """The rank's block of a single-process tensor of a call: its rows of
    the batch, and its block of the dimension ``module`` says is split over
    the model group (``which``: "in", "out" or "weight", the torch weight's
    split dimension)."""
    if which == "weight":
        dim = getattr(module, "tp_weight", None)
        if dim is None:
            return t
        dim = 1 - dim                 # the Flax dimension -> the torch one
    else:
        if t.dtype.is_floating_point or t.ndim:
            t = t[d * b:(d + 1) * b]
        dim = getattr(module, "tp_" + which, None)
        if dim is None:
            return t
    n = t.shape[dim] // T
    return t.narrow(dim, m * n, n)


def _bits_differ(a, b) -> int:
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    if a.dtype.is_floating_point:
        a, b = a.float(), b.float()
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return int((a != b).sum())


def _call_check(single, sp, fed, T, d, b, m):
    """(differing bits of the quantized inputs and weights, the worst
    output error over LOGIT_TOL * max|out|) of the fed TP calls against
    the rank's shards of the single-process calls."""
    assert [c["path"] for c in fed] == [c["path"] for c in single]
    bad, worst = 0, 0.0
    for c, s in zip(fed, single):
        mod = c["module"]
        for i, (got, want) in enumerate(zip(c["q"], s["q"])):
            which = "weight" if i == len(c["q"]) - 1 and \
                hasattr(mod, "weight") else "in"
            if want.dtype == torch.int64 or not want.is_floating_point():
                which = "in"
            bad += _bits_differ(got, _shard_of(want, mod, which, d, b, m, T))
        want = _shard_of(s["out"], mod, "out", d, b, m, T).float()
        err = float((c["out"].float() - want).abs().max())
        worst = max(worst, err / (LOGIT_TOL * float(want.abs().max())))
    return bad, worst


def _worker_7a(rank, res):
    from fp8tpu_torch.models import variables_from_flax
    from fp8tpu_torch.models.transformer import Decoder
    from fp8tpu_torch.parallel import (DECODER_PARAM_RULES, local_shards,
                                       make_mesh)
    from fp8tpu_torch.parallel.data import TensorShard
    from fp8tpu_torch.quant import interceptor as icp
    from fp8tpu_torch.quant.policy import e4m3_inference_policy
    cfg = torch_cfg(DEC)
    pol = e4m3_inference_policy()
    sd = variables_from_flax(flax_vars(DEC, 0))
    toks = torch.from_numpy(dec_tokens()).to(torch.int64)
    mesh = make_mesh(data=DATA, model=MODEL)
    d, m = mesh.index("data"), mesh.index("model")
    b = toks.shape[0] // DATA

    full = Decoder(cfg)
    table = icp.build_module_table(full)
    tpm = Decoder(cfg, mesh=mesh)
    local = local_shards(sd, mesh, DECODER_PARAM_RULES, table)
    shards = icp.weight_shards(tpm, mesh)
    wq = icp.quantize_params(local, pol, table, None, shards)
    for name, t in wq.items():
        res[f"7a/wq/{name}"] = _np(t)
    for which in TOKENS:
        t = torch.from_numpy(dec_tokens(which)).to(torch.int64)
        with torch.no_grad():
            res[f"7a/logits/{which}"] = _np(icp.quantized_apply(
                tpm, pol, t[d * b:(d + 1) * b], params=local, mesh=mesh))
            if rank == 0:
                res[f"7a/single/{which}"] = _np(icp.quantized_apply(
                    full, pol, t, params=sd))

    # call by call: each TP call fed the rank's shard of the single call's
    # arguments
    single, _ = _records(full, icp.quantize_params(sd, pol, table), toks,
                         None)
    by_path = {c["path"]: c for c in single}

    def feed(ctx, args):
        s = by_path[ctx.path]
        return tuple(_shard_of(a, ctx.module, "in", d, b, m, MODEL)
                     for a in s["args"])

    fed, _ = _records(tpm, wq, toks[d * b:(d + 1) * b], mesh, feed)
    res["7a/calls"] = np.array(_call_check(single, sd, fed, MODEL, d, b, m))
    res["7a/ncalls"] = np.array(len(fed))

    # the planted faults, each through the same check
    real = icp.fake_quant

    def row_local(t, cfg_, key=None, shard=None):
        if isinstance(shard, TensorShard) and shard.model_dim == -1:
            shard = TensorShard(shard.data, None)
        return real(t, cfg_, key, shard)

    icp.fake_quant = row_local
    try:
        fed, _ = _records(tpm, wq, toks[d * b:(d + 1) * b], mesh, feed)
    finally:
        icp.fake_quant = real
    res["7a/plant/row-input-local-amax"] = np.array(
        _call_check(single, sd, fed, MODEL, d, b, m))
    cols = {n: s for n, s in shards.items() if s.model_dim != 1}
    wq_bad = icp.quantize_params(local, pol, table, None, cols)
    fed, _ = _records(tpm, wq_bad, toks[d * b:(d + 1) * b], mesh, feed)
    res["7a/plant/column-kernel-local-row-scale"] = np.array(
        _call_check(single, sd, fed, MODEL, d, b, m))

    # GSPMD's cut of a bf16 Dense: bf16 partials, summed and rounded again
    from fp8tpu_torch.models import transformer
    from fp8tpu_torch._device import full_fp32

    def bf16_partials(self, x):
        with full_fp32():
            part = torch.nn.functional.linear(x.to(self.dtype),
                                              self.weight.to(self.dtype))
        return self.tp.sum(part, part.dtype)

    real_fwd = transformer.RowDense.forward
    transformer.RowDense.forward = bf16_partials
    try:
        t = torch.from_numpy(dec_tokens()).to(torch.int64)
        with torch.no_grad():
            res["7a/logits/bf16-partials"] = _np(icp.quantized_apply(
                tpm, pol, t[d * b:(d + 1) * b], params=local, mesh=mesh))
    finally:
        transformer.RowDense.forward = real_fwd


# -- the worker: 7b ---------------------------------------------------------

def _engine(params, scfg, mesh=None, **kw):
    from fp8tpu_torch.serve import ServingEngine
    return ServingEngine(params, scfg, n_slots=2, max_seq=96, device="cpu",
                         mesh=mesh, **kw)


def _spec_kw(params, scfg):
    return dict(use_paged=True, page_size=8, draft_params=params,
                draft_cfg=scfg, k_spec=3)


def engine_runs(res, ring_mesh=None, spec_mesh=None):
    """The 7b engines' tokens (and speculation counts) into ``res``: the
    ring engine greedy and sampled; the self-draft paged engine on the JAX
    test's random artifact and, with K4's page walk, on the drawn model,
    greedy and sampled.  Over the meshes in the world, in one process in
    the parent (the references)."""
    import dataclasses
    from fp8tpu_torch.serve import ServeConfig, random_serve_params
    params = serve_params(ENG, 1)
    scfg = ServeConfig(model=torch_cfg(ENG))
    for temp in (0.0, TEMP):
        res[f"7b/ring/{temp}"] = _tokens(_engine(
            params, scfg, ring_mesh, chunk_size=8).run(requests(temp)))
    # tests/test_engine_sharded.py's artifact: random payloads at 0.02
    # (every token the same, so a self-draft accepts every draft)
    rand = random_serve_params(scfg.model, "e4m3", device="cpu")
    eng = _engine(rand, scfg, spec_mesh, **_spec_kw(rand, scfg))
    res["7b/spec/random"] = _tokens(eng.run(requests()))
    res["7b/spec/random/counts"] = np.array([eng.spec_accepted,
                                             eng.spec_drafted])
    if spec_mesh is None:
        res["7b/paged/random"] = _tokens(_engine(
            rand, scfg, use_paged=True, page_size=8, chunk_size=8).run(
            requests()))
    c = dataclasses.replace(scfg, paged_decode_impl="kernel")
    for temp in (0.0, TEMP):
        eng = _engine(params, c, spec_mesh, **_spec_kw(params, c))
        res[f"7b/spec/{temp}"] = _tokens(eng.run(requests(temp)))
        res[f"7b/spec/{temp}/counts"] = np.array([eng.spec_accepted,
                                                 eng.spec_drafted])


def _worker_7b(rank, res):
    from fp8tpu_torch.parallel import make_mesh
    engine_runs(res, make_mesh(data=DATA, model=MODEL),
                make_mesh(model=WORLD))


def _worker_step(rank, res):
    """decode_step over a mesh against the unsharded step, from a ring that
    four slots' prompts were prefilled into."""
    from fp8tpu_torch.parallel import make_mesh
    from fp8tpu_torch.serve import (ServeConfig, decode_step, full_logits,
                                    prefill, shard_serve_params)
    from fp8tpu_torch.serve.kv_cache import RingKVCache
    from fp8tpu_torch.serve.model import local_heads
    for case, (kw, shape) in STEP_MESHES.items():
        cfg = torch_cfg(kw)
        scfg = ServeConfig(model=cfg)
        params = serve_params(kw, 2)
        mesh = make_mesh(**shape)
        sp = shard_serve_params(params, scfg, mesh)
        prompts = np.random.default_rng(3).integers(
            0, kw["vocab_size"], (4, 5)).astype(np.int32)
        logits = []
        for p in (params, sp):
            ring = RingKVCache.create(cfg.n_layers, 4, 32,
                                      local_heads(p, cfg)[1], cfg.head_dim,
                                      "e4m3", device="cpu")
            for s in range(4):
                _, ring = prefill(p, ring, torch.from_numpy(prompts[s]), s,
                                  5 - s % 2, scfg)
            toks = torch.from_numpy(prompts[:, -1].copy())
            pos = torch.tensor([5 - s % 2 for s in range(4)],
                               dtype=torch.int32)
            out, _ = decode_step(p, ring, toks, pos, scfg)
            logits.append(_np(out))
        res[f"step/{case}"] = np.stack(logits)
        seq = torch.from_numpy(prompts[0].copy())
        res[f"full/{case}"] = np.stack([_np(full_logits(p, seq, scfg))
                                        for p in (params, sp)])


def _worker_casts(rank, res):
    """Each CASTS config on the rank's block of a split tensor, against the
    block of the whole tensor's cast: differing elements, or -1 where the
    cast raises NotImplementedError."""
    from fp8tpu_torch.parallel import make_mesh
    from fp8tpu_torch.parallel.data import BatchShard, TensorShard
    from fp8tpu_torch.quant.config import TensorQuantConfig
    from fp8tpu_torch.quant.fakequant import fake_quant
    mesh = make_mesh(data=DATA, model=MODEL)
    d, m = mesh.index("data"), mesh.index("model")
    data = BatchShard.of(mesh.group("data"))
    model = BatchShard.of(mesh.group("model"))
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -64, 65, (8, 64)).astype(np.float32) / 8)
    rows, cols = slice(d * 4, d * 4 + 4), slice(m * 16, m * 16 + 16)
    for name, kw in CASTS.items():
        cfg = TensorQuantConfig(**{"dtype": "e4m3", **kw})
        want = fake_quant(x, cfg)
        for split in SPLITS:
            r = slice(None) if split == "model" else rows
            c = cols if "model" in split else slice(None)
            shard = data if split == "batch-shard" else TensorShard(
                None if split == "model" else data,
                model if "model" in split else None, 1, mesh=mesh)
            try:
                got = fake_quant(x[r, c].contiguous(), cfg, None, shard)
                res[f"cast/{name}/{split}"] = np.array(
                    _bits_differ(got, want[r, c].contiguous()))
            except NotImplementedError:
                res[f"cast/{name}/{split}"] = np.array(-1)


# -- the worker: 7c, the model-parallel training step ------------------------

SEQ_MESH = dict(data=2, seq=2, model=2)      # the JAX test's step's mesh
SR_X = (16, 64)                              # tests/test_parallel.py:44-63
SR_X3 = (4, 16, 64)                          # data x seq x model
SR_STREAMS = ("hash", "threefry")
SR_IMPLS = ("bitexact", "hw")
CALL_ALGOS = ("hybrid", "hybrid-gemm", "bfloat16")
TRAIN_PLANTS = ("sr-contiguous-offset", "column-igrad-before-sum",
                "ograd-local-amax")
PLANT_ALGO = {"sr-contiguous-offset": "hybrid",
              "column-igrad-before-sum": "hybrid",
              "ograd-local-amax": "hybrid-gemm"}
IN_TOL = 2e-2          # a fed cast's own input against the single call's
NOCAST_TOL = 1e-5      # the step without casts, f32, relative
# free running against the port's single-process step (PERF.md §2's
# decoder-training row): losses relative, parameters max |difference|
FREE = {a: dict(loss=1e-5, param=2e-3) for a in ("none",) + CALL_ALGOS}
HW_ALGOS = ("hybrid", "hybrid-gemm")
OPT8_STEPS = 2
SCRIPT_TP = ["--steps", "3", "--d-model", "64", "--n-layers", "1",
             "--batch-size", "4", "--seq-len", "9", "--device", "cpu",
             "--opt8", "--emb-fmt", "e4m3"]
SCRIPT_LOSS = 1e-2     # bf16 compute, 8-bit AdamW: the bf16 training row


def sr_inputs():
    """tests/test_parallel.py's (16, 64) (its ``rng`` fixture's first
    draw) and a (4, 16, 64) draw."""
    return (np.random.default_rng(0).standard_normal(SR_X).astype(
        np.float32), np.random.default_rng(11).standard_normal(
        SR_X3).astype(np.float32))


def sr_cfg(impl):
    from fp8tpu_torch.quant.config import TensorQuantConfig
    return TensorQuantConfig("e4m3", "stochastic", cast_impl=impl)


def _sr_stream(stream):
    from fp8tpu_torch.numerics import cast
    cast.SR_BITS_IMPL = stream


def _worker_sr(rank, res):
    """The SR casts of a tensor split over data x model (2 x 4) and over
    data x seq x model (2 x 2 x 2): each rank's block of the cast."""
    from fp8tpu_torch.numerics.prng import key
    from fp8tpu_torch.parallel import BatchShard, TensorShard, make_mesh
    from fp8tpu_torch.quant.fakequant import fake_quant
    x2, x3 = (torch.from_numpy(a) for a in sr_inputs())
    m2 = make_mesh(data=2, model=4)
    m3 = make_mesh(**SEQ_MESH)
    d, m = m2.index("data"), m2.index("model")
    sh2 = TensorShard(BatchShard.of(m2.group("data")),
                      BatchShard.of(m2.group("model")), 1, mesh=m2)
    b2 = x2[d * 8:(d + 1) * 8, m * 16:(m + 1) * 16].contiguous()
    d3, s3, m3i = (m3.index(a) for a in ("data", "seq", "model"))
    sh3 = TensorShard(BatchShard.of(m3.group("data")),
                      BatchShard.of(m3.group("model")), 2,
                      BatchShard.of(m3.group("seq")), 1, 16, mesh=m3)
    b3 = x3[d3 * 2:(d3 + 1) * 2, s3 * 8:(s3 + 1) * 8,
            m3i * 32:(m3i + 1) * 32].contiguous()
    try:
        for stream in SR_STREAMS:
            _sr_stream(stream)
            for impl in SR_IMPLS:
                res[f"sr/2/{stream}/{impl}"] = _np(fake_quant(
                    b2, sr_cfg(impl), key(7), sh2))
                res[f"sr/3/{stream}/{impl}"] = _np(fake_quant(
                    b3, sr_cfg(impl), key(7), sh3))
    finally:
        _sr_stream("hash")
    # a stochastic engine operand split over data x model (its rows and
    # columns) against the whole operand through the engine: the rank's
    # block of the cast operand (K2's SR stream at the global indices),
    # multiplied by an identity, on the bit pipeline and the hw route
    from fp8tpu_torch.quant.config import ModuleQuantConfig
    from fp8tpu_torch.quant.hw_patch import engine_matmul
    differ = 0
    for impl in SR_IMPLS:
        mq = ModuleQuantConfig(iact=sr_cfg(impl))
        got = engine_matmul(b2, torch.eye(16), mq, key(9),
                            shards=(sh2, None))
        want = engine_matmul(x2, torch.eye(64), mq, key(9))[
            d * 8:(d + 1) * 8, m * 16:(m + 1) * 16]
        differ += _bits_differ(got, want)
    res["sr/engine"] = np.array(differ)


def _train_setup(algo, mesh=None, dtype="bfloat16", opt="sgd", hw=False):
    """The JAX test's decoder from ``flax_vars(DEC, 0)``: its TP form over
    ``mesh`` (this rank's shards) or the whole model, ``initialize`` with
    ``algo`` ("none": no casts, f32 master), SGD 0.01 (``optax.sgd``) or
    the 8-bit AdamW, and a step with loss scale 2^12 on ``lm_loss``.
    Returns (emulator, params, optimizer, step, state)."""
    import dataclasses
    from fp8tpu_torch.models import variables_from_flax
    from fp8tpu_torch.models.transformer import Decoder
    from fp8tpu_torch.parallel import DECODER_PARAM_RULES, local_shards
    from fp8tpu_torch.quant.config import ModuleQuantConfig
    from fp8tpu_torch.quant.interceptor import build_module_table
    from fp8tpu_torch.quant.policy import QuantPolicy
    from fp8tpu_torch.training import (adamw_8bit, init_train_state,
                                       initialize, make_train_step)
    from fp8tpu_torch.training.mpt import lm_loss
    cfg = dataclasses.replace(torch_cfg(DEC), dtype=dtype)
    sd = variables_from_flax(flax_vars(DEC, 0))
    model = Decoder(cfg, mesh=mesh)
    if mesh is not None:
        sd = local_shards(sd, mesh, DECODER_PARAM_RULES,
                          build_module_table(Decoder(cfg)))
    model.load_state_dict(sd)
    nocast = algo == "none"
    emu = initialize(model, training_algo="hybrid" if nocast else algo,
                     master_fmt="fp32" if nocast else "fp16", device="cpu",
                     mesh=mesh)
    if nocast:
        emu = dataclasses.replace(emu, policy=QuantPolicy(
            default=ModuleQuantConfig(), whitelist=()))
    if hw:
        emu = dataclasses.replace(emu, policy=emu.policy.with_hw_patching())
    params = dict(model.named_parameters())
    if opt == "opt8":
        optimizer = adamw_8bit(params, 1e-3, module_table=emu.module_table,
                               shards=emu.shards)
    else:
        optimizer = torch.optim.SGD(params.values(), lr=0.01)
    return (emu, params, optimizer, make_train_step(emu, lm_loss),
            init_train_state(optimizer))


def _flax_block(t, name, emu, full=None):
    """``t`` (a torch-layout leaf) in the Flax layout; with ``full`` the
    rank's block of it instead, as the emulator's shards say."""
    from fp8tpu_torch.quant.interceptor import to_flax_layout
    from fp8tpu_torch.utils import local_params
    kind = emu.module_table.get(name.rpartition(".")[0].replace(".", "/"))
    if full is not None:
        t = local_params({name: full}, emu.shards or {},
                         emu.module_table)[name]
    return to_flax_layout(t.detach(), kind)


def _run_step(algo, mesh, toks, key_seed=3, **kw):
    """One step: (loss, scale after, {name: the rank's leaf})."""
    from fp8tpu_torch.numerics.prng import key
    from fp8tpu_torch.training.mpt import lm_batch
    emu, params, opt, step, state = _train_setup(algo, mesh, **kw)
    params, state, loss = step(params, state, lm_batch(toks, mesh),
                               key(key_seed))
    return float(loss), state[1], {n: p.detach().clone()
                                   for n, p in params.items()}, emu


class _Feed:
    """Every cast of a step, recorded (``mode`` "record", the
    single-process step) or fed (``mode`` "feed", a rank's TP step): a
    fed cast takes the rank's block of the recorded call's input, its
    output must be the block of the recorded output bit for bit, and its
    own input (what the TP step handed it, everything upstream fed) must
    lie within ``IN_TOL`` of max|input| of that block.  Calls are matched
    by (role, key, global shape).  The casts: forward (``icp.fake_quant``:
    iact, oact, weights), igrad / ograd (``icp.quantize_grad``), wtgrad
    and master requant (``mpt.fake_quant``)."""

    def __init__(self, mode, records=None):
        self.mode, self.records = mode, records if records is not None \
            else {}
        self.bad = self.calls = 0
        self.worst_in = 0.0
        self.roles = set()

    def _wrap(self, role, real):
        def cast(x, cfg, key=None, shard=None):
            if cfg is None:
                return real(x, cfg, key, shard)
            if self.mode == "record":
                y = real(x, cfg, key, shard)
                self.records.setdefault((role, key, tuple(x.shape)), []
                                        ).append((x.detach().clone(),
                                                  y.detach().clone()))
                return y
            blk = None if shard is None else shard.block(x.shape)
            gshape = tuple(x.shape) if blk is None else blk.shape
            xs, ys = self.records[(role, key, gshape)].pop(0)
            if blk is not None:
                for d, (st, n) in enumerate(zip(blk.start, x.shape)):
                    xs, ys = xs.narrow(d, st, n), ys.narrow(d, st, n)
            want_in = xs.to(x.dtype).contiguous()
            scale = float(want_in.float().abs().max()) or 1.0
            self.worst_in = max(self.worst_in, float(
                (x.detach().float() - want_in.float()).abs().max()) / scale)
            y = real(want_in, cfg, key, shard).detach()
            self.bad += _bits_differ(y, ys.to(y.dtype))
            self.calls += 1
            self.roles.add(role)
            if role == "fwd" and x.requires_grad:
                # straight through, as the cast's own backward: the
                # gradient reaches x
                return y + (x - x.detach())
            return y
        return cast

    def __enter__(self):
        from fp8tpu_torch.quant import interceptor as icp
        from fp8tpu_torch.training import mpt
        self._saved = (icp.fake_quant, icp.quantize_grad, mpt.fake_quant)
        icp.fake_quant = self._wrap("fwd", icp.fake_quant)
        icp.quantize_grad = self._wrap("grad", icp.quantize_grad)
        mpt.fake_quant = self._wrap("param", mpt.fake_quant)
        return self

    def __exit__(self, *exc):
        from fp8tpu_torch.quant import interceptor as icp
        from fp8tpu_torch.training import mpt
        icp.fake_quant, icp.quantize_grad, mpt.fake_quant = self._saved


class _LocalMax:
    """A shard whose MAX stays on the rank (a planted fault)."""

    def __init__(self, shard):
        self.shard = shard

    def __getattr__(self, name):
        return getattr(self.shard, name)

    def max(self, a):
        return a


def _plant(name):
    """Install a planted fault; returns its undo."""
    from fp8tpu_torch.models import transformer
    from fp8tpu_torch.parallel import collectives as coll
    from fp8tpu_torch.parallel import data
    from fp8tpu_torch.quant import interceptor as icp
    if name == "sr-contiguous-offset":
        real = data.Block.contiguous_offset

        def first(self, shape):
            off = 0
            for _, g, st in self.segments(shape):
                off = off * g + st
            return off

        data.Block.contiguous_offset = first
        return lambda: setattr(data.Block, "contiguous_offset", real)
    if name == "column-igrad-before-sum":
        # the sum moves above the interceptor: the igrad cast sees one
        # rank's partial gradient, the sum comes after it
        real_ci = transformer.TPLayout.column_input
        real_make = icp.make_quant_interceptor
        transformer.TPLayout.column_input = \
            lambda self, x: x.to(torch.float32)

        def make(*a, **kw):
            inner = real_make(*a, **kw)

            def outer(next_fun, args, kwargs, ctx):
                if isinstance(ctx.module, transformer.ColumnDense):
                    g = ctx.module.tp.group
                    args = tuple(coll.column_input(x, g).to(x.dtype)
                                 for x in args)
                return inner(next_fun, args, kwargs, ctx)
            return outer

        icp.make_quant_interceptor = make
        from fp8tpu_torch.training import mpt
        real_mpt = mpt.make_quant_interceptor
        mpt.make_quant_interceptor = make

        def undo():
            transformer.TPLayout.column_input = real_ci
            icp.make_quant_interceptor = real_make
            mpt.make_quant_interceptor = real_mpt
        return undo
    real_gc = icp.grad_cast

    def local(x, cfg, key, nchw=True, shard=None):
        return real_gc(x, cfg, key, nchw,
                       None if shard is None else _LocalMax(shard))

    icp.grad_cast = local
    return lambda: setattr(icp, "grad_cast", real_gc)


def _fed_step(algo, mesh, toks, records):
    """A rank's TP step with every cast fed the single-process step's
    (``records``): (differing bits, worst own-input error, calls)."""
    with _Feed("feed", {k: list(v) for k, v in records.items()}) as f:
        _run_step(algo, mesh, toks)
    return np.array([f.bad, f.worst_in, f.calls, len(f.roles)])


def _opt8_case(rank, res, mesh):
    """The 8-bit AdamW over the rank's shards, OPT8_STEPS steps fed the
    single step's gradients, against the single-process optimizer: the
    rank's codes and every block's scale (bytes differing), then the
    checkpoint round trips both ways (returns both optimizers)."""
    from fp8tpu_torch.quant.interceptor import from_flax_layout
    emu_t, p_t, o_t, _, _ = _train_setup("hybrid-gemm", mesh,
                                         dtype="float32", opt="opt8")
    emu_s, p_s, o_s, _, _ = _train_setup("hybrid-gemm", None,
                                         dtype="float32", opt="opt8")
    rng = np.random.default_rng(5)
    for _ in range(OPT8_STEPS):
        for n, p in p_s.items():
            g = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
                np.float32)) * 1e-2
            p.grad = g
            kind = emu_s.module_table.get(n.rpartition(".")[0].replace(
                ".", "/"))
            p_t[n].grad = from_flax_layout(
                _flax_block(None, n, emu_t, g).contiguous(), kind) \
                if n in (emu_t.shards or {}) else g.clone()
        o_s.step()
        o_t.step()
    bad = crossing = 0
    for n, p in p_t.items():
        want_p = _flax_block(None, n, emu_t, p_s[n].detach())
        bad += _bits_differ(_flax_block(p, n, emu_t).contiguous(),
                            want_p.contiguous())
        blk, crosses = o_t.blocks.get(n, (None, False))
        crossing += crosses
        for which in ("m", "v"):
            (qs, ss), (qt, st) = o_s.state[p_s[n]][which], \
                o_t.state[p][which]
            if crosses:
                idx = blk.index(_flax_block(p, n, emu_t).shape)
                qs = qs.reshape(-1)[idx]
            elif blk is not None:
                b0 = blk.contiguous_offset(
                    _flax_block(p, n, emu_t).shape) // 256
                qs, ss = qs[b0:b0 + qt.shape[0]], ss[b0:b0 + qt.shape[0]]
            bad += int((qs.reshape(-1).view(torch.uint8)
                        != qt.reshape(-1).view(torch.uint8)).sum())
            bad += _bits_differ(ss, st)
    res["7c/opt8"] = np.array([bad, crossing, o_t.count])
    return emu_t, p_t, o_t, emu_s, p_s, o_s


def _checkpoints(rank, res, out, opt8_state):
    """Sharded -> single-process and single-process -> sharded: the
    global tree a sharded run saves restores into a single-process run
    byte for byte, and a single-process checkpoint into the shards."""
    import torch.distributed as dist
    from fp8tpu_torch.models import variables_from_flax, variables_to_flax
    from fp8tpu_torch.training import LossScaleState
    from fp8tpu_torch.utils import (global_params, local_params,
                                    restore_checkpoint, save_checkpoint)
    emu_t, p_t, o_t, emu_s, p_s, o_s = opt8_state
    ls = LossScaleState(2.0 ** 11, 3)
    table = emu_s.module_table
    a, b = os.path.join(out, "ck_sharded"), os.path.join(out, "ck_single")
    tree = global_params(p_t, emu_t.shards, table)
    chain = o_t.global_chain_state()
    if rank == 0:
        save_checkpoint(a, 2, variables_to_flax(tree, table), (chain, ls))
        save_checkpoint(b, 2, variables_to_flax(p_s, table), (o_s, ls))
    dist.barrier()
    # into a fresh single-process run
    _, f_p, f_o, _, _ = _train_setup("hybrid-gemm", None, dtype="float32",
                                      opt="opt8")
    got = restore_checkpoint(a, 2, {"params": variables_to_flax(f_p, table),
                                    "opt_state": (f_o, LossScaleState(1.0))})
    bad = sum(_bits_differ(t, p_s[n].detach()) for n, t in
              variables_from_flax(got["state"]["params"]).items())
    for n, p in f_p.items():
        for which in ("m", "v"):
            for x, y in zip(f_o.state[p][which], o_s.state[p_s[n]][which]):
                bad += int((x.reshape(-1).view(torch.uint8)
                            != y.reshape(-1).view(torch.uint8)).sum())
    bad += int(got["state"]["opt_state"][1] != ls) + int(f_o.count
                                                         != o_s.count)
    # into fresh shards
    e_t, g_p, g_o, _, _ = _train_setup("hybrid-gemm", SEQ_MESH_OBJ[0],
                                       dtype="float32", opt="opt8")
    got = restore_checkpoint(b, 2, {
        "params": variables_to_flax(global_params(g_p, e_t.shards, table),
                                    table),
        "opt_state": (g_o.global_chain_state(), LossScaleState(1.0))})
    full = local_params(variables_from_flax(got["state"]["params"]),
                        e_t.shards, table)
    bad2 = sum(_bits_differ(full[n], p.detach()) for n, p in p_t.items())
    g_o.load_global_chain_state(got["state"]["opt_state"][0])
    for n, p in g_p.items():
        for which in ("m", "v"):
            for x, y in zip(g_o.state[p][which], o_t.state[p_t[n]][which]):
                bad2 += int((x.reshape(-1).view(torch.uint8)
                             != y.reshape(-1).view(torch.uint8)).sum())
    res["7c/checkpoint"] = np.array([bad, bad2])


SEQ_MESH_OBJ = []


def _worker_7c(rank, res, out):
    from fp8tpu_torch.parallel import make_mesh
    from fp8tpu_torch.training import mpt
    mesh = make_mesh(**SEQ_MESH)
    SEQ_MESH_OBJ[:] = [mesh]
    res["7c/coords"] = np.array([mesh.index(a) for a in SEQ_MESH])
    for which in TOKENS:
        toks = torch.from_numpy(dec_tokens(which)).long()
        loss, ls, params, emu = _run_step("hybrid", mesh, toks)
        res[f"7c/jax-step/{which}/loss"] = np.array(loss)
        res[f"7c/jax-step/{which}/q"] = _np(_flax_block(
            params["layer_0.attn.q_proj.weight"],
            "layer_0.attn.q_proj.weight", emu))
    toks = torch.from_numpy(dec_tokens("draw")).long()
    # without casts, in f32, and free running, against the single step
    for algo in ("none",) + CALL_ALGOS:
        dtype = "float32" if algo == "none" else "bfloat16"
        one = _run_step(algo, None, toks, dtype=dtype)
        tp = _run_step(algo, mesh, toks, dtype=dtype)
        worst = max(float((_flax_block(tp[2][n], n, tp[3])
                           - _flax_block(None, n, tp[3], one[2][n])
                           ).abs().max()) for n in tp[2])
        rel = max(float((_flax_block(tp[2][n], n, tp[3])
                         - _flax_block(None, n, tp[3], one[2][n])).abs().max()
                        / _flax_block(None, n, tp[3], one[2][n]).abs().max())
                  for n in tp[2])
        res[f"7c/free/{algo}"] = np.array(
            [abs(tp[0] - one[0]) / abs(one[0]), worst, rel,
             float(tp[1].scale == one[1].scale
                   and tp[1].good_steps == one[1].good_steps)])
    # model 4 splits the 2 KV heads: k / v gathered for the rank's query
    # heads, each rank's part of the gradient summed in the backward
    one = _run_step("none", None, toks, dtype="float32")
    tp = _run_step("none", make_mesh(data=2, model=4), toks,
                   dtype="float32")
    res["7c/free-model4/none"] = np.array([
        abs(tp[0] - one[0]) / abs(one[0]),
        max(float((_flax_block(tp[2][n], n, tp[3])
                   - _flax_block(None, n, tp[3], one[2][n])).abs().max()
                  / _flax_block(None, n, tp[3], one[2][n]).abs().max())
            for n in tp[2])])
    # a calibration sweep: every module's min, max and absmax of the whole
    # tensors, against the single-process sweep's
    from fp8tpu_torch.models import variables_from_flax
    from fp8tpu_torch.models.transformer import Decoder
    from fp8tpu_torch.parallel import DECODER_PARAM_RULES, local_shards
    from fp8tpu_torch.quant.calibrate import collect_stats_fn
    from fp8tpu_torch.quant.interceptor import build_module_table
    sd = variables_from_flax(flax_vars(DEC, 0))
    whole = Decoder(torch_cfg(DEC))
    tpm = Decoder(torch_cfg(DEC), mesh=mesh)
    b = mpt.lm_batch(toks, mesh)
    with torch.no_grad():
        _, got = collect_stats_fn(tpm, mesh=mesh)(
            local_shards(sd, mesh, DECODER_PARAM_RULES,
                         build_module_table(whole)), b.inputs,
            seq_len=b.length)
        _, want = collect_stats_fn(whole)(sd, toks[:, :-1])
    res["7c/stats"] = np.array([len(got), len(want), sum(
        int(float(got[p][k]) != float(v)) for p, rec in want.items()
        for k, v in rec.items())])
    # hw patching: the attention BatchMatmuls on the engine, each slice's
    # rows over the seq group
    for algo in HW_ALGOS:
        one = _run_step(algo, None, toks, hw=True)
        tp = _run_step(algo, mesh, toks, hw=True)
        worst = max(float((_flax_block(tp[2][n], n, tp[3])
                           - _flax_block(None, n, tp[3], one[2][n])
                           ).abs().max()) for n in tp[2])
        res[f"7c/hw/{algo}"] = np.array([abs(tp[0] - one[0]) / abs(one[0]),
                                         worst])
    # call by call, and the planted faults
    records = {}
    for algo in CALL_ALGOS:
        with _Feed("record") as f:
            _run_step(algo, None, toks)
        records[algo] = f.records
        res[f"7c/calls/{algo}"] = _fed_step(algo, mesh, toks, f.records)
    for plant in TRAIN_PLANTS:
        undo = _plant(plant)
        try:
            res[f"7c/plant/{plant}"] = _fed_step(
                PLANT_ALGO[plant], mesh, toks, records[PLANT_ALGO[plant]])
        finally:
            undo()
    # an overflow in one rank's shard: every rank skips the step
    emu, params, opt, step, state = _train_setup("hybrid", mesh)
    before = {n: p.detach().clone() for n, p in params.items()}
    real = emu.quantize_grads

    def poisoned(grads, k):
        grads = real(grads, k)
        if rank == 5:
            grads["layer_0.attn.q_proj.weight"][0, 0] = float("inf")
        return grads

    emu.quantize_grads = poisoned
    from fp8tpu_torch.numerics.prng import key
    params, state, _ = step(params, state, mpt.lm_batch(toks, mesh), key(3))
    moved = sum(_bits_differ(p.detach(), before[n])
                for n, p in params.items())
    res["7c/overflow"] = np.array([moved, state[1].scale,
                                   state[1].good_steps])
    _checkpoints(rank, res, out, _opt8_case(rank, res, mesh))


def _worker_script(rank, res):
    """``train_fp8.main`` over data 4 x model 2 (8-bit AdamW, e4m3
    embedding, remat)."""
    from fp8tpu_torch.examples import train_fp8
    got = train_fp8.main(SCRIPT_TP + ["--data-parallel", "4",
                                      "--model-parallel", "2", "--remat"])
    res["script/losses"] = np.array(got["losses"])
    res["script/scale"] = np.array([got["loss_scale"].scale,
                                    got["loss_scale"].good_steps])


def _worker(rank, world, port, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from fp8tpu_torch.parallel import init_world
    init_world("cpu", rank, world, f"tcp://localhost:{port}",
               timeout=PG_TIMEOUT)
    res = {}
    for part in (_worker_casts, _worker_7a, _worker_7b, _worker_step,
                 _worker_sr):
        part(rank, res)
    _worker_7c(rank, res, out)
    _worker_script(rank, res)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


# -- the world ------------------------------------------------------------------

class World:
    """``WORLD`` ranks of this file run as a script, started at once;
    ``results()`` waits for them (``TIMEOUT`` seconds from the start, then
    every rank is killed and the test fails) and loads their npz files."""

    def __init__(self, out):
        from fp8tpu_torch.parallel.mesh import free_port
        self.out, self.t0 = str(out), time.monotonic()
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
             str(port), self.out], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        self._res = None

    def results(self):
        if self._res is None:
            logs = []
            for p in self.procs:
                left = TIMEOUT - (time.monotonic() - self.t0)
                try:
                    logs.append(p.communicate(timeout=max(left, 1))[0])
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"the world of {WORLD} ranks ran past "
                                f"{TIMEOUT} s")
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
            self._res = [dict(np.load(os.path.join(self.out,
                                                   f"rank{r}.npz")))
                         for r in range(WORLD)]
        return self._res

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Started before the file's first test; the single-process engines'
    references (``refs``) and the JAX package's 7a and 7c references are
    made here while the ranks run."""
    w = World(tmp_path_factory.mktemp("world"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w.refs = {}
        engine_runs(w.refs)
    finally:
        torch.set_num_threads(threads)
    jax_7a()
    jax_7c()
    yield w
    w.kill()


# -- the JAX side ----------------------------------------------------------------

def _jax_tree(v):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, v)


_JAX = {}


def jax_7a():
    """The JAX package's quantized weights and its sharded (data 2 x model
    4, GSPMD) and unsharded forwards of tests/test_parallel.py."""
    if not _JAX:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from fp8tpu.models import Decoder, tiny_config
        from fp8tpu.parallel import (DECODER_PARAM_RULES, make_mesh,
                                     shard_params)
        from fp8tpu.quant.interceptor import (build_module_table,
                                              quantize_params,
                                              quantized_apply)
        from fp8tpu.quant.policy import e4m3_inference_policy
        m = Decoder(tiny_config(**DEC))
        v = _jax_tree(flax_vars(DEC, 0))
        pol = e4m3_inference_policy()
        table = build_module_table(m, v, jax.numpy.asarray(dec_tokens()))
        _JAX["wq"] = jax.tree.map(np.asarray,
                                  quantize_params(v, pol, table, None))

        @jax.jit
        def f(vv, t):
            return quantized_apply(m, pol, vv, t, module_table=table)

        mesh = make_mesh(data=DATA, model=MODEL)
        for which in TOKENS:
            toks = jax.numpy.asarray(dec_tokens(which))
            with mesh:
                _JAX[f"sharded/{which}"] = np.asarray(f(
                    shard_params(v, mesh, DECODER_PARAM_RULES),
                    jax.device_put(toks, NamedSharding(mesh,
                                                       P("data", None)))))
            _JAX[f"unsharded/{which}"] = np.asarray(f(v, toks))
    return _JAX


def _jax_engine_tokens(paged: bool):
    """tests/test_engine_sharded.py's single-device engine on the same
    artifact (the JAX package's own conversion of the same draw)."""
    key = f"engine/{paged}"
    if key not in _JAX:
        from fp8tpu.models import tiny_config
        from fp8tpu.serve import Request, ServeConfig, ServingEngine
        from fp8tpu.serve import convert_decoder_params
        cfg = tiny_config(**ENG)
        params = convert_decoder_params(_jax_tree(flax_vars(ENG, 1)), cfg)
        kw = dict(use_paged=True, page_size=8) if paged else {}
        out = ServingEngine(params, ServeConfig(model=cfg), n_slots=2,
                            max_seq=96, chunk_size=8, **kw).run(
            [Request(uid=i, prompt=[2 + i, 7, 11], max_new_tokens=NEW)
             for i in range(N_REQ)])
        _JAX[key] = _tokens(out)
    return _JAX[key]


# -- 7a: the TP-sharded PTQ forward --------------------------------------------

def _coords(r):
    return r // MODEL, r % MODEL


def test_7a_weight_shards_bit_equal_to_jax(world):
    """Each rank's quantized weights (column shards scaled per input row
    with the model group's MAX) are its slices of the JAX package's."""
    from fp8tpu_torch.models import variables_from_flax
    from fp8tpu_torch.models.transformer import Decoder
    from fp8tpu_torch.parallel import (DECODER_PARAM_RULES, make_mesh,
                                       shard_tree)
    from fp8tpu_torch.quant.interceptor import build_module_table
    res = world.results()
    want = variables_from_flax(jax_7a()["wq"])
    specs = shard_tree(want, make_mesh(data=DATA, model=MODEL),
                       DECODER_PARAM_RULES,
                       build_module_table(Decoder(torch_cfg(DEC))))
    split = 0
    for r in range(WORLD):
        _, m = _coords(r)
        for name, full in want.items():
            t = full.numpy()
            for dim, part in enumerate(specs[name].spec):
                if part == "model":
                    n = t.shape[dim] // MODEL
                    t = np.take(t, range(m * n, (m + 1) * n), axis=dim)
                    split += r == 0
            got = res[r][f"7a/wq/{name}"]
            assert got.shape == t.shape, name
            np.testing.assert_array_equal(got.view(np.int32),
                                          t.view(np.int32), err_msg=name)
    assert split == 1 + 2 * 7      # the embedding, 7 kernels a layer


def _tp_logits(res, which):
    """The ranks' rows of the batch, from model index 0 of each data group;
    every rank of a model group must hold the same logits."""
    key = f"7a/logits/{which}"
    for r in range(WORLD):
        d, _ = _coords(r)
        np.testing.assert_array_equal(res[r][key], res[d * MODEL][key])
    return np.concatenate([res[d * MODEL][key] for d in range(DATA)])


def _gates(o, r):
    return (float(np.corrcoef(o.ravel(), r.ravel())[0, 1]),
            float((o.argmax(-1) == r.argmax(-1)).mean()))


@pytest.mark.parametrize("which", ["sharded", "unsharded"])
def test_7a_logits_meet_the_jax_gates(world, which):
    """tests/test_parallel.py's tokens: the JAX test's own gates."""
    corr, agree = _gates(_tp_logits(world.results(), "ones"),
                         jax_7a()[f"{which}/ones"])
    print(f"7a against JAX's {which} forward: corr {corr:.6f}, argmax "
          f"agreement {agree:.4f}")
    assert corr > 0.998, corr
    assert agree > 0.95, agree


@pytest.mark.parametrize("which", ["sharded", "unsharded"])
def test_7a_logits_within_the_jax_package_s_own_spread(world, which):
    """Drawn tokens, where per-tensor e4m3 casts of bf16 activations
    amplify summation order (trap 66): JAX's own GSPMD forward reads
    correlation 0.99772 and argmax agreement 0.906 against its unsharded
    forward here, below the JAX test's gates.  The port may lie no farther
    from JAX's forward than that: correlation within 1e-3 of JAX's own
    sharded-against-unsharded reading, argmax agreement within 1/16."""
    j = jax_7a()
    corr, agree = _gates(_tp_logits(world.results(), "draw"),
                         j[f"{which}/draw"])
    own_corr, own_agree = _gates(j["sharded/draw"], j["unsharded/draw"])
    print(f"7a (drawn tokens) against JAX's {which} forward: corr "
          f"{corr:.6f}, argmax agreement {agree:.4f}; JAX's sharded "
          f"against its unsharded forward {own_corr:.6f} / {own_agree:.4f}")
    assert corr >= own_corr - 1e-3, (corr, own_corr)
    assert agree >= own_agree - 1 / 16, (agree, own_agree)


def test_7a_bf16_partials_part_from_the_single_process_forward(world):
    """Trap 88: the row-parallel products as bf16 partials (GSPMD's cut of a
    bf16 dot), summed and rounded again, leave the single-process forward
    by far more than the f32 partials the port sums (bit-equal above)."""
    res = world.results()
    o = _tp_logits(res, "bf16-partials")
    r = res[0]["7a/single/draw"]
    rel = float(np.abs(o - r).max() / np.abs(r).max())
    print(f"bf16 partials against the single-process forward: {rel:.3e} of "
          f"max|logit|, argmax agreement {_gates(o, r)[1]:.4f}")
    assert rel > 10 * LOGIT_TOL


@pytest.mark.parametrize("which", TOKENS)
def test_7a_logits_against_the_single_process_forward(world, which):
    res = world.results()
    o, r = _tp_logits(res, which), res[0][f"7a/single/{which}"]
    rel = float(np.abs(o - r).max() / np.abs(r).max())
    print(f"7a against the port's single-process forward: {rel:.3e} of "
          f"max|logit| (limit {LOGIT_TOL}), {int((o != r).sum())} of "
          f"{o.size} logits differ")
    assert rel <= LOGIT_TOL


def test_7a_call_by_call(world):
    """Every Dense / BatchMatmul / Embed call fed the rank's shard of the
    single-process call's arguments: quantized inputs and weights bit for
    bit, outputs within 2e-3 of max|out|."""
    for r, res in enumerate(world.results()):
        bad, worst = res["7a/calls"]
        print(f"rank {r}: {int(res['7a/ncalls'])} calls, {int(bad)} bits "
              f"of quantized inputs differ, worst output error "
              f"{worst:.3e} of the limit")
        assert int(res["7a/ncalls"]) == 1 + DEC["n_layers"] * 9
        assert bad == 0, (r, bad)
        assert worst <= 1.0, (r, worst)


@pytest.mark.parametrize("plant", PLANTS)
def test_7a_planted_fault_fails_the_call_check(world, plant):
    """A rank-local amax on a row-parallel input, or a rank-local per-row
    scale on a column-parallel kernel: the call-by-call check fails."""
    failed = [r for r, res in enumerate(world.results())
              if res[f"7a/plant/{plant}"][0] > 0
              or res[f"7a/plant/{plant}"][1] > 1.0]
    print(f"{plant}: the call check fails on ranks {failed}; bits "
          f"differing / worst output over its limit: "
          + ", ".join(f"{int(r[f'7a/plant/{plant}'][0])} / "
                      f"{r[f'7a/plant/{plant}'][1]:.2f}"
                      for r in world.results()))
    assert failed


# -- 7b: the TP-sharded serving engine ---------------------------------------

def _same_on_every_rank(res, key):
    for r in range(1, WORLD):
        np.testing.assert_array_equal(res[r][key], res[0][key], err_msg=key)
    return res[0][key]


@pytest.mark.parametrize("temp", [0.0, TEMP])
def test_7b_ring_engine_matches_the_single_process_engine(world, temp):
    got = _same_on_every_rank(world.results(), f"7b/ring/{temp}")
    np.testing.assert_array_equal(got, world.refs[f"7b/ring/{temp}"])


def test_7b_spec_engine_over_model_8_on_the_jax_test_s_artifact(world):
    """tests/test_engine_sharded.py's case: random payloads, self-draft over
    eight ranks against the plain paged engine, every draft accepted."""
    res = world.results()
    got = _same_on_every_rank(res, "7b/spec/random")
    np.testing.assert_array_equal(got, world.refs["7b/paged/random"])
    acc, drafted = _same_on_every_rank(res, "7b/spec/random/counts")
    assert drafted > 0 and acc == drafted


@pytest.mark.parametrize("temp", [0.0, TEMP])
def test_7b_spec_engine_over_model_8(world, temp):
    """Self-draft speculation with target and draft both sharded over eight
    ranks (KV heads 4: the caches hold every head, q / k / v gathered), K4's
    page walk, on the drawn model: the single-process spec engine's tokens
    and counts.  A verify pass and a decode chunk round near ties apart
    (trap 44), so on this model a greedy self-draft accepts 15 of 18
    drafts in both."""
    res = world.results()
    key = f"7b/spec/{temp}"
    got = _same_on_every_rank(res, key)
    np.testing.assert_array_equal(got, world.refs[key])
    acc, drafted = _same_on_every_rank(res, key + "/counts")
    print(f"spec at temperature {temp}: {acc} of {drafted} drafts accepted "
          f"over model 8, {list(world.refs[key + '/counts'])} in one "
          f"process")
    assert drafted > 0
    np.testing.assert_array_equal([acc, drafted], world.refs[key + "/counts"])


def _margin_rule(got, want, kw, seed):
    """Where the port's tokens part from JAX's, the step is a near tie of
    the port's teacher-forced logits."""
    from fp8tpu_torch.serve import ServeConfig, full_logits
    params = serve_params(kw, seed)
    scfg = ServeConfig(model=torch_cfg(kw))
    exact = 0
    for i in range(N_REQ):
        g, w = list(got[i]), list(want[i])
        if g == w:
            exact += 1
            continue
        j = next(k for k in range(NEW) if g[k] != w[k])
        seq = torch.tensor([2 + i, 7, 11] + w[:j], dtype=torch.int32)
        logits = full_logits(params, seq, scfg)[-1]
        top2 = logits.topk(2).values
        assert float(top2[0] - top2[1]) <= \
            2 * MARGIN_TOL * float(logits.abs().max()), (i, j)
    return exact


@pytest.mark.parametrize("which", ["ring", "spec"])
def test_7b_engines_match_jax_by_the_margin_rule(world, which):
    res = world.results()
    key = "7b/ring/0.0" if which == "ring" else "7b/spec/0.0"
    got = _same_on_every_rank(res, key)
    want = _jax_engine_tokens(paged=which == "spec")
    exact = _margin_rule(got, want, ENG, 1)
    print(f"7b {which}: {exact} of {N_REQ} requests equal to JAX's engine")
    assert exact >= 1


@pytest.mark.parametrize("fn", ["step", "full"])
@pytest.mark.parametrize("case", list(STEP_MESHES))
def test_7b_decode_step_over_a_mesh(world, case, fn):
    """decode_step from a prefilled ring, and full_logits (the dense causal
    forward over the quantized k / v), over the mesh against unsharded."""
    res = world.results()
    plain, sharded = _same_on_every_rank(res, f"{fn}/{case}")
    rel = float(np.abs(sharded - plain).max() / np.abs(plain).max())
    print(f"{fn} over {case}: {rel:.3e} of max|logit| (limit {STEP_TOL})")
    assert rel <= STEP_TOL


# -- the casts of a split tensor -------------------------------------------------

@pytest.mark.parametrize("name", list(CASTS))
def test_casts_of_a_split_tensor_are_the_whole_tensor_s(world, name):
    """A rank's block of a tensor split over the data group (a BatchShard,
    or a TensorShard), the model group or both, cast with its shard: the
    block of the whole tensor's cast, bit for bit.  Fine-grained, per-block
    and integer scaling of a model-split tensor raise."""
    for r, res in enumerate(world.results()):
        for split in SPLITS:
            got = int(res[f"cast/{name}/{split}"])
            if "model" in split and name in RAISES_MODEL_SPLIT:
                assert got == -1, (r, split)
            else:
                assert got == 0, (r, split, got)


# -- 7c: the model-parallel training step -------------------------------------

def jax_7c():
    """The JAX package's side of 7c: the SR casts of tests/test_parallel.py
    (the (16, 64) tensor over P("data", "model"), data 2 x model 4) and of
    a (4, 16, 64) tensor over P("data", "seq", "model"), data 2 x seq 2 x
    model 2, single-device and GSPMD, each stream and impl; and the JAX
    test's hybrid step (``optax.sgd(0.01)``, ``key(3)``) replicated and
    over data 2 x model 2 x seq 2 on each of ``TOKENS``: its loss and
    ``layer_0/attn/q_proj/kernel``."""
    if "7c" not in _JAX:
        import jax
        import jax.numpy as jnp
        import optax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from fp8tpu.models import Decoder, tiny_config
        from fp8tpu.numerics import cast as jcast
        from fp8tpu.parallel import (DECODER_PARAM_RULES, make_mesh,
                                     shard_params)
        from fp8tpu.quant.config import TensorQuantConfig
        from fp8tpu.quant.fakequant import fake_quant
        from fp8tpu.training import (init_train_state, initialize,
                                     make_train_step)
        out = {}
        x2, x3 = sr_inputs()
        meshes = {"2": (make_mesh(data=2, model=4), P("data", "model"), x2),
                  "3": (make_mesh(**SEQ_MESH), P("data", "seq", "model"),
                        x3)}
        saved = jcast.SR_BITS_IMPL
        try:
            for stream in SR_STREAMS:
                jcast.SR_BITS_IMPL = stream
                for impl in SR_IMPLS:
                    cfg = TensorQuantConfig("e4m3", "stochastic",
                                            cast_impl=impl)
                    for lay, (mesh, spec, x) in meshes.items():
                        k = jax.random.key(7)
                        xs = jnp.asarray(x)
                        out[f"sr/{lay}/{stream}/{impl}/single"] = np.asarray(
                            fake_quant(xs, cfg, k))
                        with mesh:
                            out[f"sr/{lay}/{stream}/{impl}/sharded"] = \
                                np.asarray(jax.jit(
                                    lambda a, kk: fake_quant(a, cfg, kk))(
                                    jax.device_put(xs, NamedSharding(
                                        mesh, spec)), k))
        finally:
            jcast.SR_BITS_IMPL = saved
        m = Decoder(tiny_config(**DEC))
        v = _jax_tree(flax_vars(DEC, 0))
        emu = initialize(m, v, (jnp.asarray(dec_tokens("ones")),),
                         training_algo="hybrid")
        opt = optax.sgd(0.01)

        def loss_fn(apply_fn, p, batch):
            logits = apply_fn(p, batch[:, :-1])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, batch[:, 1:]).mean()

        step = jax.jit(make_train_step(emu, opt, loss_fn))
        mesh = make_mesh(**SEQ_MESH)
        sh = shard_params(v, mesh, DECODER_PARAM_RULES)
        for which in TOKENS:
            toks = jnp.asarray(dec_tokens(which))
            p, _, loss = step(v, init_train_state(opt, v), toks,
                              jax.random.key(3))
            q = p["params"]["layer_0"]["attn"]["q_proj"]["kernel"]
            out[f"step/replicated/{which}"] = (float(loss), np.asarray(
                q, np.float32))
            with mesh:
                p, _, loss = step(sh, init_train_state(opt, sh),
                                  jax.device_put(toks, NamedSharding(
                                      mesh, P("data", "seq"))),
                                  jax.random.key(3))
            q = p["params"]["layer_0"]["attn"]["q_proj"]["kernel"]
            out[f"step/sharded/{which}"] = (float(loss), np.asarray(
                q, np.float32))
        _JAX["7c"] = out
    return _JAX["7c"]


def _by_coords(res):
    """{(data, seq, model): the rank's results} of the 7c mesh."""
    return {tuple(int(c) for c in r["7c/coords"]): r for r in res}


def _port_step(res, which):
    """(loss, the global q_proj kernel) of the port's sharded step: every
    rank's loss equal, the kernel's model blocks from data 0, seq 0."""
    by = _by_coords(res)
    loss = float(by[(0, 0, 0)][f"7c/jax-step/{which}/loss"])
    for r in res:
        assert float(r[f"7c/jax-step/{which}/loss"]) == loss
    q = np.concatenate([by[(0, 0, m)][f"7c/jax-step/{which}/q"]
                        for m in range(SEQ_MESH["model"])], axis=1)
    for (d, s, m), r in by.items():
        key = f"7c/jax-step/{which}/q"
        np.testing.assert_array_equal(r[key], by[(0, 0, m)][key])
    return loss, q.astype(np.float32)


def _step_gap(a, b):
    """(relative loss gap, q correlation, max |q difference|)."""
    (la, qa), (lb, qb) = a, b
    return (abs(la - lb) / abs(lb),
            float(np.corrcoef(qa.ravel(), qb.ravel())[0, 1]),
            float(np.abs(qa - qb).max()))


def _sr_blocks(res, lay, key):
    """The ranks' SR blocks put together into the global tensor."""
    x2, x3 = sr_inputs()
    if lay == "2":
        out = np.zeros(x2.shape, np.float32)
        for r, rr in enumerate(res):
            d, m = r // 4, r % 4
            out[d * 8:(d + 1) * 8, m * 16:(m + 1) * 16] = rr[key]
        return out
    out = np.zeros(x3.shape, np.float32)
    for (d, s, m), rr in _by_coords(res).items():
        out[d * 2:(d + 1) * 2, s * 8:(s + 1) * 8, m * 32:(m + 1) * 32] = \
            rr[key]
    return out


@pytest.mark.parametrize("impl", SR_IMPLS)
@pytest.mark.parametrize("stream", SR_STREAMS)
@pytest.mark.parametrize("lay", ["2", "3"])
def test_7c_sr_of_a_split_tensor_is_the_single_cast(world, lay, stream,
                                                    impl):
    """tests/test_parallel.py:44-63's promise: an e4m3 SR cast of a tensor
    split over data x model (2 x 4, the JAX test's (16, 64)) or over data x
    seq x model (2 x 2 x 2, a (4, 16, 64) tensor), each rank's block cast
    with its Block (every element's bits at its global row-major index),
    is the single-process cast bit for bit, the JAX package's single-device
    cast, and JAX's GSPMD cast."""
    from fp8tpu_torch.numerics import cast
    from fp8tpu_torch.numerics.prng import key
    from fp8tpu_torch.quant.fakequant import fake_quant
    got = _sr_blocks(world.results(), lay, f"sr/{lay}/{stream}/{impl}")
    x = sr_inputs()[0 if lay == "2" else 1]
    saved = cast.SR_BITS_IMPL
    try:
        cast.SR_BITS_IMPL = stream
        single = fake_quant(torch.from_numpy(x), sr_cfg(impl), key(7)).numpy()
    finally:
        cast.SR_BITS_IMPL = saved
    j = jax_7c()
    for want in (single, j[f"sr/{lay}/{stream}/{impl}/single"],
                 j[f"sr/{lay}/{stream}/{impl}/sharded"]):
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # the blocks are not one range: a contiguous offset would differ
    assert (got != x).any()


@pytest.mark.parametrize("which", ["replicated", "sharded"])
def test_7c_step_meets_the_jax_gates(world, which):
    """tests/test_parallel.py:159-190 on the port: one hybrid step with SGD
    0.01 over data 2 x model 2 x seq 2, the all-ones (4, 16) tokens split
    over (data, seq) after the shift (chunks of 8 and 7), key(3), against
    JAX's replicated and GSPMD steps: loss within 1%, q_proj correlation
    > 0.9999, atol 2e-3."""
    gap, corr, diff = _step_gap(_port_step(world.results(), "ones"),
                                jax_7c()[f"step/{which}/ones"])
    print(f"7c step against JAX's {which} step: loss {gap:.3e} relative, "
          f"q_proj corr {corr:.9f}, max|diff| {diff:.3e}")
    assert gap < 0.01 and corr > 0.9999 and diff <= 2e-3, (gap, corr, diff)


def test_7c_step_on_drawn_tokens_within_jax_s_own_spread(world):
    """Drawn tokens (trap 89's rule): the port's sharded step meets the
    JAX test's gates against JAX's replicated step, and lies no farther
    from it than twice JAX's own GSPMD step does, loss and q_proj alike
    (correlation within twice JAX's own 1 - corr)."""
    j = jax_7c()
    ref = j["step/replicated/draw"]
    gap, corr, diff = _step_gap(_port_step(world.results(), "draw"), ref)
    own = _step_gap(j["step/sharded/draw"], ref)
    print(f"7c step (drawn tokens) against JAX's replicated step: loss "
          f"{gap:.3e}, corr {corr:.9f}, max|diff| {diff:.3e}; JAX's GSPMD "
          f"step: {own[0]:.3e}, {own[1]:.9f}, {own[2]:.3e}")
    assert gap < 0.01 and corr > 0.9999 and diff <= 2e-3
    assert gap <= 2 * own[0] and diff <= 2 * own[2]
    assert 1 - corr <= 2 * (1 - own[1])


def test_7c_step_without_casts_is_the_single_process_step(world):
    """No casts, f32 compute and master: the sharded step (SGD 0.01,
    drawn tokens) is the port's single-process step within
    ``NOCAST_TOL`` relative (loss, and parameters of max|leaf|)."""
    for r in world.results():
        loss, _, rel, scales = r["7c/free/none"]
        print(f"7c without casts: loss {loss:.3e}, parameters {rel:.3e} "
              f"relative (limit {NOCAST_TOL})")
        assert loss <= NOCAST_TOL and rel <= NOCAST_TOL and scales == 1


def test_7c_stochastic_engine_operand_of_a_split_tensor(world):
    """A stochastic engine operand split over data x model (2 x 4) is cast
    at each element's global index on the engine's own SR stream (K2's
    pre-pass block route on the card): through an identity it is the
    rank's block of the whole operand's engine product, bit for bit, on
    the bit pipeline and the hw route."""
    assert [int(r["sr/engine"]) for r in world.results()] == [0] * WORLD


def test_7c_calibration_sweep_records_the_whole_tensors(world):
    """``collect_stats_fn(mesh=)`` over data 2 x seq 2 x model 2: every
    module's iact / oact min, max and absmax are the single-process
    sweep's, on every rank."""
    for r in world.results():
        n_got, n_want, bad = r["7c/stats"]
        assert n_got == n_want > 10 and bad == 0, (n_got, n_want, bad)


def test_7c_step_over_model_4_with_gathered_kv_heads(world):
    """Model 4 splits no whole KV head of the decoder (2 KV heads): k / v
    are gathered for the rank's query heads, and the backward sums the
    ranks' parts of their gradient.  Without casts, f32, over data 2 x
    model 4: the single-process step within ``NOCAST_TOL``."""
    for r in world.results():
        loss, rel = r["7c/free-model4/none"]
        print(f"7c over data 2 x model 4 without casts: loss {loss:.3e}, "
              f"parameters {rel:.3e} relative (limit {NOCAST_TOL})")
        assert loss <= NOCAST_TOL and rel <= NOCAST_TOL


@pytest.mark.parametrize("algo", CALL_ALGOS)
def test_7c_backward_casts_call_by_call(world, algo):
    """Every cast of a sharded step (forward, igrad, ograd, wtgrad, master
    requant), fed the rank's block of the single-process call's input,
    gives the block of its output bit for bit, and its own input (all
    upstream fed) lies within ``IN_TOL`` of max|input| of that block."""
    for r, res in enumerate(world.results()):
        bad, worst, calls, roles = res[f"7c/calls/{algo}"]
        if r == 0:
            print(f"7c {algo} call by call: {int(calls)} calls, {int(bad)} "
                  f"differing bits, own inputs {worst:.3e} of max (limit "
                  f"{IN_TOL})")
        assert bad == 0 and worst <= IN_TOL, (r, bad, worst)
        assert calls > 50 and roles == 3, (r, calls, roles)


@pytest.mark.parametrize("plant", TRAIN_PLANTS)
def test_7c_planted_fault_fails_the_call_check(world, plant):
    """SR bits at a contiguous offset of a column block, a column input's
    gradient cast before the model sum, a rank-local amax in an ograd
    cast: each fails the call-by-call check on some rank."""
    res = world.results()
    got = [res[r][f"7c/plant/{plant}"] for r in range(WORLD)]
    bad = sum(int(g[0]) for g in got)
    worst = max(float(g[1]) for g in got)
    print(f"7c planted {plant}: {bad} differing bits, own inputs "
          f"{worst:.3e} of max")
    assert bad > 0 or worst > IN_TOL


@pytest.mark.parametrize("algo", ("none",) + CALL_ALGOS)
def test_7c_free_running_against_the_single_process_step(world, algo):
    """The sharded step free running against the port's single-process
    step on drawn tokens (bf16 compute but "none"): the loss within
    ``FREE`` relative, every parameter within ``FREE`` of it, the loss
    scale's state equal."""
    lim = FREE[algo]
    for r, res in enumerate(world.results()):
        loss, worst, rel, scales = res[f"7c/free/{algo}"]
        if r == 0:
            print(f"7c {algo} free running: loss {loss:.3e} relative, "
                  f"parameters {worst:.3e} (max |difference|), {rel:.3e} "
                  f"of max|leaf|; limits {lim}")
        assert loss <= lim["loss"] and worst <= lim["param"] and scales, \
            (r, loss, worst)


@pytest.mark.parametrize("algo", HW_ALGOS)
def test_7c_hw_patched_step(world, algo):
    """With hw patching (the attention BatchMatmuls on the engine, each
    slice's rows over the seq group, its scale the whole slice's) the
    sharded step is the single-process hw-patched step within ``FREE``."""
    lim = FREE[algo]
    for r, res in enumerate(world.results()):
        loss, worst = res[f"7c/hw/{algo}"]
        if r == 0:
            print(f"7c {algo} hw-patched: loss {loss:.3e} relative, "
                  f"parameters {worst:.3e}; limits {lim}")
        assert loss <= lim["loss"] and worst <= lim["param"], (r, loss,
                                                                worst)


def test_7c_overflow_on_one_rank_skips_the_step_everywhere(world):
    """An inf planted in rank 5's shard of one gradient: the finite check
    is reduced over the world, so every rank skips the step (parameters
    untouched) and halves the loss scale."""
    for r, res in enumerate(world.results()):
        moved, scale, good = res["7c/overflow"]
        assert moved == 0 and scale == 2.0 ** 11 and good == 0, (r, moved,
                                                                   scale)


def test_7c_opt8_on_split_leaves_is_the_single_process_optimizer(world):
    """``adamw_8bit`` over the rank's shards for 2 steps fed the single
    step's gradients: the parameters, each rank's codes and every block's
    scales bit-equal to the single-process optimizer's (10 leaves' blocks
    cross ranks)."""
    for r, res in enumerate(world.results()):
        bad, crossing, count = res["7c/opt8"]
        assert bad == 0 and crossing == 10 and count == OPT8_STEPS, (
            r, bad, crossing, count)


def test_7c_checkpoints_round_trip(world):
    """A sharded run's checkpoint (the global tree) restores into a
    single-process run, and a single-process checkpoint into the shards,
    byte for byte (parameters, 8-bit moments, count, loss scale)."""
    for r, res in enumerate(world.results()):
        assert list(res["7c/checkpoint"]) == [0, 0], r


def test_7c_train_fp8_script_over_data_4_model_2(world):
    """``train_fp8.main`` over data 4 x model 2 (8-bit AdamW, e4m3
    embedding, remat) in the world against the single-process script:
    every rank's losses alike and within ``SCRIPT_LOSS`` relative, the
    loss scale's state equal."""
    from fp8tpu_torch.examples import train_fp8
    res = world.results()
    want = train_fp8.main(SCRIPT_TP + ["--remat"])
    ref = np.array(want["losses"])
    got = res[0]["script/losses"]
    for r in res:
        np.testing.assert_array_equal(r["script/losses"], got)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"train_fp8 over data 4 x model 2: losses {got}, single process "
          f"{ref}: {rel:.3e} relative (limit {SCRIPT_LOSS})")
    assert rel <= SCRIPT_LOSS
    assert list(res[0]["script/scale"]) == [want["loss_scale"].scale,
                                            want["loss_scale"].good_steps]


# -- what stays raising ------------------------------------------------------------

@pytest.mark.parametrize("what", ["direct", "int4", "moe", "sr-model-split",
                                  "fine-grained-model-split"])
def test_unported_paths_under_a_mesh_raise(what):
    """7f's serving routes (direct, int4, MoE) and fine-grained scaling of
    a model-split tensor raise; SR of a model-split tensor, 7c's, is
    ported and checked here for its value instead."""
    import dataclasses
    from fp8tpu_torch.parallel import make_mesh
    from fp8tpu_torch.parallel.data import BatchShard, TensorShard
    from fp8tpu_torch.quant.config import TensorQuantConfig
    from fp8tpu_torch.quant.fakequant import fake_quant
    from fp8tpu_torch.numerics.prng import key as prng_key
    from fp8tpu_torch.serve import (ServeConfig, random_serve_params,
                                    shard_serve_params)
    mesh = make_mesh(model=4)
    if what in ("direct", "int4", "moe"):
        kw = dict(ENG, n_experts=4) if what == "moe" else ENG
        cfg = torch_cfg(kw)
        fmt = "int4" if what == "int4" else "e4m3"
        scfg = ServeConfig(model=cfg, weight_fmt=fmt)
        if what == "direct":
            scfg = dataclasses.replace(scfg, matmul_impl="direct")
        params = random_serve_params(cfg, fmt, device="cpu")
        with pytest.raises(NotImplementedError, match="item 7f"):
            shard_serve_params(params, scfg, mesh)
        return
    x = torch.randn(8, 16)
    shard = TensorShard(None, BatchShard(None, 1, 4), 1)
    if what == "sr-model-split":
        # ported (ROADMAP 7c): the rank's column block of a (8, 64) tensor
        # takes the whole tensor's SR bits at their global indices
        cfg = TensorQuantConfig("e5m2", "stochastic")
        full = torch.randn(8, 64)
        got = fake_quant(full[:, 16:32].contiguous(), cfg, prng_key(0),
                         shard)
        want = fake_quant(full, cfg, prng_key(0))[:, 16:32]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        cfg = TensorQuantConfig("e4m3", "rne", "fine-grained", group_size=4)
        with pytest.raises(NotImplementedError, match="model group"):
            fake_quant(x, cfg, None, shard)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
