"""Tensor parallelism inside the decoder across the cards of one host: the
TP PTQ forward and TP serving over a model axis of every rank, against
the unsharded paths on rank 0.

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m fp8tpu_torch.tools.bench_tp [--out FILE]
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m fp8tpu_torch.tools.bench_tp --device cpu --tiny   # a rehearsal
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m fp8tpu_torch.tools.bench_tp --parts train   # the train step

At ``bench.py``'s width (16 layers, d_model 4096, 32 / 8 heads, d_ff
11008, vocabulary 32768) unless ``--tiny``; every rank draws the same
model from one seed and keeps its shards (``parallel.local_shards``,
``serve.shard_serve_params``):

  ptq     ``quantized_apply(mesh=)`` of the emulation Decoder's TP form
          (e4m3 PTQ, bf16, 4 x 128 tokens) against the unsharded forward
          on rank 0: max |logit difference| over max|logit|, argmax
          agreement, wall ms of a warm call on each side; then both
          forwards without the casts, in f32 and in bf16 (what the
          sharding's summation order alone moves);
  step    a ring decode step at batch 8 from prefilled prompts, sharded
          and unsharded: its logits against the unsharded step's, wall ms
          a step (chunks of 32 greedy steps, host clock), one step's
          device ms and launches under torch.profiler (NCCL's kernels
          apart; rank 0's);
  engine  8 requests x 16 tokens through ``ServingEngine(mesh=)`` (ring)
          against the unsharded engine on rank 0: requests whose tokens
          are equal, and seconds.
  train   the model-parallel training step (``--mesh``: model over
          every rank, or data 2 x model N/2) at the large preset's width
          (12 layers, d_model 768, 12 / 4 heads, d_ff 2304, vocabulary 256;
          batch 8 x 256 tokens) against the unsharded step on rank 0, in
          three recipes: ``train_fp8 --training-algo hybrid-gemm
          --master-fmt fp16 --opt8 --emb-fmt e4m3`` for 3 steps;
          tests/test_parallel.py's step (hybrid, SGD 0.01, one step; its
          gates: loss 1%, q_proj correlation 0.9999); and that step
          without casts in f32 (what the sharding alone moves).  Each: the
          loss of each step (relative), ``layer_0/attn/q_proj/kernel``
          after them (correlation, max |difference|), wall ms a step.

``--parts`` picks the parts (default: all).  Rank 0 prints one JSON
object with the card's name and power limit; ``--out`` appends it to a
file.  Every collective has a 300 s timeout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch
import torch.distributed as dist


def _config(tiny: bool):
    from fp8tpu_torch.models import DecoderConfig, tiny_config
    if tiny:
        return tiny_config(n_layers=2, d_model=128, n_heads=8, n_kv_heads=8,
                           d_ff=256, vocab_size=256, max_seq_len=512)
    return DecoderConfig(vocab_size=32768, d_model=4096, n_layers=16,
                         n_heads=32, n_kv_heads=8, d_ff=11008,
                         max_seq_len=1024)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()


def _wall_ms(fn, dev, reps: int = 3) -> float:
    fn()
    _sync(dev)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t) / reps * 1e3


def _profile(fn, dev):
    """One call of ``fn`` under torch.profiler: (device ms, launches, NCCL
    device ms, NCCL launches); zeros on the CPU."""
    if dev.type != "cuda":
        fn()
        return 0.0, 0, 0.0, 0
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize(dev)
    ms = n = nccl_ms = nccl_n = 0
    for e in p.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = (getattr(e, "device_time", None) or e.cuda_time) / 1e3
        ms, n = ms + t, n + 1
        if "nccl" in e.name.lower():
            nccl_ms, nccl_n = nccl_ms + t, nccl_n + 1
    return ms, n, nccl_ms, nccl_n


def bench_ptq(cfg, mesh, dev, rank):
    from fp8tpu_torch.models.transformer import Decoder, decoder
    from fp8tpu_torch.parallel import DECODER_PARAM_RULES, local_shards
    from fp8tpu_torch.quant import interceptor as icp
    from fp8tpu_torch.quant.policy import e4m3_inference_policy
    pol = e4m3_inference_policy()
    gen = torch.Generator(dev).manual_seed(21)
    full = decoder(cfg, dev, gen)
    toks = torch.randint(0, cfg.vocab_size, (4, 128), device=dev,
                         generator=gen)
    sd = {k: v.detach() for k, v in full.state_dict().items()}
    table = icp.build_module_table(full)
    local = local_shards(sd, mesh, DECODER_PARAM_RULES, table)
    with torch.device("meta"):
        tpm = Decoder(cfg, mesh=mesh)
    if rank != 0:
        del full, sd
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def tp():
        with torch.no_grad():
            return icp.quantized_apply(tpm, pol, toks, params=local,
                                       mesh=mesh)

    got = tp()
    out = {"tp_wall_ms": _wall_ms(tp, dev)}
    if rank == 0:
        with torch.no_grad():
            want = icp.quantized_apply(full, pol, toks, params=sd)
        t = time.perf_counter()
        with torch.no_grad():
            for _ in range(3):
                icp.quantized_apply(full, pol, toks, params=sd)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["unsharded_wall_ms"] = (time.perf_counter() - t) / 3 * 1e3
        out["logit_rel"] = float((got - want).abs().max()
                                 / want.abs().max())
        out["argmax_agree"] = float((got.argmax(-1) == want.argmax(-1))
                                    .float().mean())
        del want
    # the same forwards without the casts, in f32 and in bf16: what the
    # sharding alone moves (the casts' per-tensor scales amplify it)
    from torch.func import functional_call
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dt)
        with torch.device("meta"):
            m_tp = Decoder(c, mesh=mesh)
            m_full = Decoder(c)
        with torch.no_grad():
            got = functional_call(m_tp, local, (toks,))
            if rank == 0:
                want = functional_call(m_full, sd, (toks,))
                out[f"uncast_{dt}_rel"] = float((got - want).abs().max()
                                                / want.abs().max())
    if rank == 0:
        del full, sd
    dist.barrier()
    return out


def bench_serve(cfg, mesh, dev, rank):
    from fp8tpu_torch.serve import (Request, RingKVCache, ServeConfig,
                                    ServingEngine, decode_step, decode_steps,
                                    prefill_batch, random_serve_params,
                                    shard_serve_params)
    from fp8tpu_torch.serve.model import local_heads
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8")
    params = random_serve_params(cfg, "e4m3", seed=0, device=dev)
    sp = shard_serve_params(params, scfg, mesh)
    B, S, L = 8, 512, cfg.n_layers
    gen = torch.Generator(dev).manual_seed(22)
    prompts = torch.randint(1, cfg.vocab_size, (B, 32), device=dev,
                            generator=gen, dtype=torch.int32)
    lengths = torch.randint(8, 33, (B,), device=dev, generator=gen,
                            dtype=torch.int32)
    slots = torch.arange(B, device=dev, dtype=torch.int32)
    zf = torch.zeros(B, device=dev)
    zi = torch.zeros(B, device=dev, dtype=torch.int32)
    out, logits = {}, {}
    steps = 32
    for label, prm in (("tp", sp), ("unsharded", params)):
        # the unsharded path issues no collective: rank 0 runs it alone
        if label == "unsharded" and rank != 0:
            continue
        ring = RingKVCache.create(L, B, S, local_heads(prm, cfg)[1],
                                  cfg.head_dim, "int8", device=dev)
        _, ring, toks, pos = prefill_batch(prm, ring, prompts, slots,
                                           lengths, None, zf, None, None,
                                           zi, zi, scfg)
        logits[label], _ = decode_step(
            prm, RingKVCache(ring.kv8.clone(), ring.sc.clone(),
                             ring.head.clone()), toks, pos, scfg)

        def chunk(n, prm=prm, ring=ring, toks=toks, pos=pos):
            return decode_steps(prm, ring, toks, pos, None, zf, n, scfg,
                                greedy_only=True)

        chunk(2)
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else (lambda: None)
        sync()
        t = time.perf_counter()
        chunk(steps)
        sync()
        step_ms = (time.perf_counter() - t) / steps * 1e3
        dms, n, nccl_ms, nccl_n = _profile(lambda: chunk(1), dev)
        out[label] = {"step_ms": step_ms, "device_ms": dms, "launches": n,
                      "nccl_ms": nccl_ms, "nccl_launches": nccl_n}
    if rank == 0:
        want = logits["unsharded"]
        out["step_logit_rel"] = float((logits["tp"] - want).abs().max()
                                      / want.abs().max())
    dist.barrier()
    reqs = [Request(uid=i, prompt=[3 + i, 5, 8, 13 + i], max_new_tokens=16)
            for i in range(8)]
    t = time.perf_counter()
    got = ServingEngine(sp, scfg, n_slots=B, max_seq=S, chunk_size=16,
                        mesh=mesh, device=dev).run(
        [dataclasses.replace(r) for r in reqs])
    out["engine_s"] = time.perf_counter() - t
    if rank == 0:
        t = time.perf_counter()
        want = ServingEngine(params, scfg, n_slots=B, max_seq=S,
                             chunk_size=16, device=dev).run(reqs)
        out["engine_unsharded_s"] = time.perf_counter() - t
        out["engine_equal_requests"] = sum(got[u] == want[u] for u in want)
    dist.barrier()
    return out


def _lm_config(tiny: bool):
    """The train part's decoder: the JAX package's large preset (the
    ``train_lm`` cell's), or a tiny one."""
    from fp8tpu_torch.models import DecoderConfig, tiny_config
    if tiny:
        return tiny_config(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                           d_ff=128, vocab_size=256, max_seq_len=32)
    return DecoderConfig(vocab_size=256, d_model=768, n_layers=12,
                         n_heads=12, n_kv_heads=4, d_ff=2304,
                         max_seq_len=256)


def trainer(cfg, dev, mesh=None, seed: int = 0,
            algo: Optional[str] = "hybrid-gemm",
            emb: Optional[str] = "e4m3", lr: float = 1e-3, hw: bool = False,
            sgd: bool = False):
    """``train_fp8``'s setup: a random decoder from ``seed`` (its TP form
    holding this rank's shards with ``mesh``), ``initialize(algo, master
    fp16, emb)`` (``algo`` None: no casts and an f32 master), ``adamw_8bit``
    over the rank's shards (plain SGD with ``sgd``, as the JAX test's
    step) and a step with loss scale 2^12 on ``training.mpt.lm_loss`` (its
    batches from ``lm_batch(tokens, mesh)``).  Returns (emulator, params,
    optimizer, step, state)."""
    from fp8tpu_torch import initialize
    from fp8tpu_torch.models.transformer import Decoder, decoder
    from fp8tpu_torch.parallel import DECODER_PARAM_RULES, local_shards
    from fp8tpu_torch.quant.config import ModuleQuantConfig
    from fp8tpu_torch.quant.interceptor import build_module_table
    from fp8tpu_torch.quant.policy import QuantPolicy
    from fp8tpu_torch.training import (adamw_8bit, init_train_state,
                                       make_train_step)
    from fp8tpu_torch.training.mpt import lm_loss
    model = decoder(cfg, dev, torch.Generator(dev).manual_seed(seed))
    if mesh is not None:
        sd = {k: v.detach() for k, v in model.state_dict().items()}
        table = build_module_table(model)
        with torch.device(dev):
            tpm = Decoder(cfg, mesh=mesh)
        tpm.load_state_dict(local_shards(sd, mesh, DECODER_PARAM_RULES,
                                         table))
        del model, sd
        model = tpm
    emu = initialize(model, training_algo=algo or "hybrid",
                     master_fmt="fp16" if algo else "fp32", emb_fmt=emb,
                     device=dev, mesh=mesh)
    if algo is None:
        emu = dataclasses.replace(emu, policy=QuantPolicy(
            default=ModuleQuantConfig(), whitelist=()))
    if hw:
        emu = dataclasses.replace(emu, policy=emu.policy.with_hw_patching())
    params = dict(model.named_parameters())
    opt = (torch.optim.SGD(params.values(), lr=lr) if sgd
           else adamw_8bit(params, lr, module_table=emu.module_table,
                           shards=emu.shards))
    return (emu, params, opt, make_train_step(emu, lm_loss),
            init_train_state(opt))


def lm_tokens(cfg, batch: int, seed: int, dev):
    """(batch, max_seq_len) tokens of the LM-gate corpus."""
    from fp8tpu_torch.data.synthetic import mixed_lm_corpus
    return torch.from_numpy(mixed_lm_corpus(
        batch, cfg.max_seq_len, cfg.vocab_size, seed=seed)).long().to(dev)


def run_steps(step, params, state, batches, key, sync):
    """The steps: (params, state, losses, wall seconds a step)."""
    from fp8tpu_torch.numerics import prng
    losses, secs = [], []
    for i, b in enumerate(batches):
        sync()
        t = time.perf_counter()
        params, state, loss = step(params, state, b, prng.fold_in(key, i))
        sync()
        secs.append(time.perf_counter() - t)
        losses.append(float(loss))
    return params, state, losses, secs


# the train part's recipes: (trainer arguments, compute dtype, steps)
RECIPES = {
    "train_fp8": (dict(), None, 3),       # hybrid-gemm, 8-bit AdamW, e4m3 emb
    # tests/test_parallel.py's step: hybrid, SGD 0.01, one step
    "jax_test_step": (dict(algo="hybrid", emb=None, lr=0.01, sgd=True),
                      None, 1),
    # the same without casts in f32: what the sharding alone moves (trap 93)
    "uncast_f32": (dict(algo=None, emb=None, lr=0.01, sgd=True),
                   "float32", 1),
}


def bench_train(cfg, mesh, dev, rank, batch: int = 8):
    """Each of :data:`RECIPES` over ``mesh`` and, on rank 0, unsharded:
    losses, step ms and ``layer_0/attn/q_proj/kernel`` after the steps
    (correlation, max |difference| and its share of max|q|)."""
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.quant.interceptor import to_flax_layout
    from fp8tpu_torch.quant.policy import LayerKind
    from fp8tpu_torch.training.mpt import lm_batch
    from fp8tpu_torch.utils import global_params
    out = {"mesh": dict(mesh.shape)}
    q = "layer_0.attn.q_proj.weight"
    key = prng.key(1)
    sync = (lambda: torch.cuda.synchronize(dev)) \
        if dev.type == "cuda" else (lambda: None)
    for name, (kw, dtype, steps) in RECIPES.items():
        c = cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)
        toks = [lm_tokens(c, batch, i, dev) for i in range(steps)]
        emu, params, opt, step, state = trainer(c, dev, mesh, **kw)
        _, state, losses, secs = run_steps(
            step, params, state, [lm_batch(t, mesh) for t in toks], key,
            lambda: _sync(dev))
        full_q = global_params({q: params[q]}, emu.shards,
                               emu.module_table)[q]
        rec = {"losses": losses, "step_ms": [1e3 * t for t in secs],
               "loss_scale": [state[1].scale, state[1].good_steps]}
        del emu, params, opt, step
        if rank == 0:
            emu, params, opt, step, ustate = trainer(c, dev, **kw)
            _, ustate, ulosses, usecs = run_steps(
                step, params, ustate, [lm_batch(t) for t in toks], key, sync)
            a = to_flax_layout(full_q, LayerKind.DENSE).float().flatten()
            b = to_flax_layout(params[q].detach(), LayerKind.DENSE
                               ).float().flatten()
            rec.update(
                unsharded_losses=ulosses,
                unsharded_step_ms=[1e3 * t for t in usecs],
                unsharded_loss_scale=[ustate[1].scale, ustate[1].good_steps],
                loss_rel=[abs(x - y) / abs(y)
                          for x, y in zip(losses, ulosses)],
                q_corr=float(torch.corrcoef(torch.stack([a, b]))[0, 1]),
                q_max_diff=float((a - b).abs().max()),
                q_rel=float((a - b).abs().max() / b.abs().max()))
            del emu, params, opt, step
        out[name] = rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", default="ptq,serve,train")
    ap.add_argument("--mesh", default="model,data2",
                    help="the train part's meshes: 'model' (model over "
                         "every rank) and / or 'data2' (data 2 x model "
                         "N/2)")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    from fp8tpu_torch.parallel import init_world, make_mesh
    dev = init_world(args.device, timeout=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(model=world)
    cfg = _config(args.tiny)
    record = {"world": world, "model": world}
    if "ptq" in parts:
        record["ptq"] = bench_ptq(cfg, mesh, dev, rank)
    if "serve" in parts:
        record["serve"] = bench_serve(cfg, mesh, dev, rank)
    if "train" in parts:
        meshes = {"model": mesh,
                  "data2": make_mesh(data=2, model=world // 2)}
        record["train"] = [bench_train(_lm_config(args.tiny), meshes[m],
                                       dev, rank)
                           for m in args.mesh.split(",")]
    if rank == 0:
        from fp8tpu_torch.tools import card_line
        record["card"] = card_line() if dev.type == "cuda" else "cpu"
        line = json.dumps(record)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
