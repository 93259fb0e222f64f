"""FP8 mixed-precision training of a decoder, the port of the JAX package's
``examples/train_fp8.py`` (the reference's ResNet/BERT training recipes,
examples/training/resnet/main_amp.py flow):

  ``initialize(...)`` with --training-algo {direct, hybrid, bfloat16, ...},
  FP16 master weights stochastically requantized each step, optional FP8
  embeddings with per-row block-norm scales (K1 on the card), the 8-bit
  AdamW (``--opt8``: P3, one launch a step), checkpoint / resume.

    python -m fp8tpu_torch.examples.train_fp8 --opt8 --emb-fmt e4m3
    python -m fp8tpu_torch.examples.train_fp8 --device cpu --steps 3

Batches are ``randint(fold_in(key(0), step), (batch, seq), 0, vocab)``,
bit-equal to the JAX script's.

``--data-parallel N`` runs as N processes, one a card (NCCL), or on the CPU
(gloo) with ``--device cpu``::

    python -m torch.distributed.run --nproc-per-node 2 \
        -m fp8tpu_torch.examples.train_fp8 --data-parallel 2 --device cpu

Every rank draws the global batch and trains on its rows; the step is the
global step (``training.make_train_step(shard=...)``: global per-tensor
scales and SR bits, the loss over the global batch, gradients summed
before the wtgrad casts), so every rank holds the same parameters.  Rank 0
logs and checkpoints.

``--model-parallel N`` (alone, or with ``--data-parallel M``: M x N
processes) splits the decoder over a (data, model) mesh by
``DECODER_PARAM_RULES``, as the JAX script's ``make_mesh(data=, model=)``
does: each rank holds its shards of the parameters and of the optimizer
state, and the step is the global step (``initialize(mesh=)``)::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m fp8tpu_torch.examples.train_fp8 --data-parallel 2 \
        --model-parallel 2 --device cpu

A checkpoint of such a run holds the global tree, as the JAX script's
does, and restores into a run of any layout.  Sequence parallelism is
reached through the API (``make_mesh(seq=)``,
``training.mpt.lm_batch``), as the JAX script has no flag for it.  MoE
under a mesh waits for the MoE decoder under ``MOE_PARAM_RULES`` and
raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fp8tpu_torch import initialize
from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.examples._common import (MOE_PARALLEL, Log,
                                           add_device_flag, from_flax,
                                           random_decoder, sync)
from fp8tpu_torch.models import variables_from_flax, variables_to_flax
from fp8tpu_torch.models.transformer import DecoderConfig, moe_aux_loss
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.training import (adamw_8bit, init_train_state,
                                   make_train_step)
from fp8tpu_torch.training.mpt import lm_batch, lm_loss
from fp8tpu_torch.utils import (MetricLogger, global_params, local_params,
                                restore_checkpoint, save_checkpoint)


CHECKPOINT_EVERY = 25     # steps between checkpoints, as the JAX script


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # hybrid-gemm (fp8 on the dense / conv GEMM streams only) is the
    # recommended recipe; the whole-whitelist recipes are the reference's.
    p.add_argument("--training-algo", default="hybrid-gemm",
                   choices=["direct", "direct-scaled", "hybrid",
                            "hybrid-scaled", "hybrid-gemm", "bfloat16"])
    p.add_argument("--master-fmt", default="fp16",
                   choices=["fp32", "fp16", "e5m2"])
    p.add_argument("--emb-fmt", default=None,
                   choices=[None, "e5m2", "e4m3", "e3m4"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--data-parallel", type=int, default=1)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--n-experts", type=int, default=0,
                   help="MoE FFN with this many experts (0 = dense MLP)")
    p.add_argument("--opt8", action="store_true",
                   help="8-bit Adam moments (int8 m / e4m3 v, "
                        "per-block scales): 4x less optimizer memory")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize decoder layers "
                        "(torch.utils.checkpoint)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume-step", type=int, default=None)
    add_device_flag(p)
    return p.parse_args(argv)


def config(args) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=2048, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(4, args.d_model // 64),
        d_ff=args.d_model * 3, max_seq_len=args.seq_len,
        n_experts=args.n_experts, remat=args.remat)


def batch_of(key, step: int, args, vocab: int, device):
    """The JAX script's batch of ``step``, bit for bit."""
    return prng.randint(prng.fold_in(key, step), 0, vocab,
                        (args.batch_size, args.seq_len), device=device)


def loss_of(model, moe: bool, global_tokens: Optional[int] = None):
    """The script's loss: the mean cross entropy, or with ``global_tokens``
    (data parallelism) this rank's tokens' sum over the global count, its
    share of the global batch's mean."""
    def loss_fn(apply_fn, params, batch):
        logits = apply_fn(params, batch[:, :-1])
        logits, labels = logits.reshape(-1, logits.shape[-1]), \
            batch[:, 1:].reshape(-1)
        if global_tokens is not None:
            # a tensor divisor: one correctly rounded divide (trap 80)
            return F.cross_entropy(logits, labels, reduction="sum") / \
                torch.tensor(float(global_tokens), device=logits.device)
        ce = F.cross_entropy(logits, labels)
        # Switch-style load balancing: without it capacity routing
        # collapses onto a few experts and silently drops tokens.
        return ce + 0.01 * moe_aux_loss(model) if moe else ce
    return loss_fn


def data_parallel(args, device):
    """(this rank's ``BatchShard`` or None, its ``Mesh`` or None, its rank)
    for ``--data-parallel M`` and ``--model-parallel N``: the world must be
    M x N processes (torchrun's), raising before any process group is made
    when it is not; a ``BatchShard`` for data parallelism alone (PR 20's
    step), a (data, model) mesh with N > 1; (None, None, 0) for one
    process."""
    dp, mp = args.data_parallel, args.model_parallel
    n = dp * mp
    if n == 1:
        return None, None, 0
    if args.n_experts:
        raise NotImplementedError(
            "--data-parallel / --model-parallel with --n-experts: "
            + MOE_PARALLEL)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    flags = f"--data-parallel {dp}" + (
        f" --model-parallel {mp}" if mp > 1 else "")
    if world != n:
        raise ValueError(
            f"{flags} runs as {n} processes (this world has {world}): "
            f"python -m torch.distributed.run --nproc-per-node {n} -m "
            f"fp8tpu_torch.examples.train_fp8 {flags}")
    if args.batch_size % dp:
        raise ValueError(f"--batch-size {args.batch_size} does not split "
                         f"over {dp} ranks")
    from fp8tpu_torch.parallel import BatchShard, init_world, make_mesh
    init_world(device)
    if mp == 1:
        shard = BatchShard.of(make_mesh(data=n).group("data"))
        return shard, None, shard.index
    return None, make_mesh(data=dp, model=mp), dist.get_rank()


def _adamw_tree(opt: torch.optim.AdamW, params: Dict):
    """torch.optim.AdamW's moments as a checkpoint tree keyed by parameter
    name (zeros where the optimizer holds no state yet: a template)."""
    tree = {"mu": {}, "nu": {}, "count": {}}
    for n, p in params.items():
        st = opt.state.get(p, {})
        tree["mu"][n] = st.get("exp_avg", torch.zeros_like(p))
        tree["nu"][n] = st.get("exp_avg_sq", torch.zeros_like(p))
        tree["count"][n] = torch.as_tensor(st.get("step", 0.0),
                                           dtype=torch.float32)
    return tree


def _load_adamw(opt: torch.optim.AdamW, tree, params: Dict):
    for n, p in params.items():
        opt.state[p] = {"exp_avg": tree["mu"][n].to(p.device),
                        "exp_avg_sq": tree["nu"][n].to(p.device),
                        "step": tree["count"][n].to(torch.float32)}


def tp_model(model, mesh):
    """The tensor-parallel form of ``model`` over ``mesh``, holding this
    rank's shards of its parameters (``parallel.local_shards``)."""
    from fp8tpu_torch.models.transformer import Decoder
    from fp8tpu_torch.parallel import DECODER_PARAM_RULES, local_shards
    from fp8tpu_torch.quant.interceptor import build_module_table
    dev = next(model.parameters()).device
    with torch.device(dev):
        tpm = Decoder(model.cfg, mesh=mesh)
    tpm.load_state_dict(local_shards(
        {k: v.detach() for k, v in model.state_dict().items()}, mesh,
        DECODER_PARAM_RULES, build_module_table(model)))
    return tpm


def _opt_tree(args, optimizer, params, emulator):
    """The optimizer's part of a checkpoint: the global tree under a mesh
    (collective: every rank calls it)."""
    if args.opt8:
        return (optimizer if emulator.mesh is None
                else optimizer.global_chain_state())
    tree = _adamw_tree(optimizer, params)
    if emulator.mesh is not None:
        for k in ("mu", "nu"):
            tree[k] = global_params(tree[k], emulator.shards,
                                    emulator.module_table)
    return tree


def _params_tree(params, emulator):
    if emulator.mesh is None:
        return params
    return global_params(params, emulator.shards, emulator.module_table)


def save(args, step, params, optimizer, opt_state, emulator, rank):
    """A checkpoint of the global state, written by rank 0 (every rank
    takes part in gathering it under a mesh)."""
    tree = _params_tree(params, emulator)
    inner = _opt_tree(args, optimizer, params, emulator)
    if rank == 0:
        save_checkpoint(args.checkpoint_dir, step,
                        variables_to_flax(tree, emulator.module_table),
                        (inner, opt_state[1]), policy=emulator.policy)


def resume(args, params, optimizer, opt_state, emulator):
    """The state of ``args.resume_step`` loaded into this rank's
    parameters and optimizer (its blocks of the global tree under a
    mesh); returns (opt_state, step)."""
    inner = _opt_tree(args, optimizer, params, emulator)
    out = restore_checkpoint(args.checkpoint_dir, args.resume_step, {
        "params": variables_to_flax(_params_tree(params, emulator),
                                    emulator.module_table),
        "opt_state": (inner, opt_state[1])})
    full = variables_from_flax(out["state"]["params"])
    if emulator.mesh is not None:
        full = local_params(full, emulator.shards, emulator.module_table)
    with torch.no_grad():
        for n, t in full.items():
            params[n].copy_(t)
    got = out["state"]["opt_state"][0]
    if not args.opt8:
        if emulator.mesh is not None:
            for k in ("mu", "nu"):
                got[k] = local_params(got[k], emulator.shards,
                                      emulator.module_table)
        _load_adamw(optimizer, got, params)
    elif emulator.mesh is not None:
        optimizer.load_global_chain_state(got)
    return (optimizer, out["state"]["opt_state"][1]), out["meta"]["step"]


def main(argv=None, variables: Optional[Dict] = None) -> Dict:
    args = parse(argv)
    device = resolve_device(args.device)
    shard, mesh, rank = data_parallel(args, device)
    if (shard is not None or mesh is not None) and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    log_line = Log(quiet=rank != 0)
    cfg = config(args)
    model = from_flax(random_decoder(cfg, device, seed=0), variables)
    if mesh is not None:
        model = tp_model(model, mesh)

    emulator = initialize(model, training_algo=args.training_algo,
                          master_fmt=args.master_fmt, emb_fmt=args.emb_fmt,
                          device=device, mesh=mesh)
    params = dict(model.named_parameters())
    if args.opt8:
        optimizer = adamw_8bit(params, args.lr,       # int8 / e4m3 moments
                               module_table=emulator.module_table,
                               shards=emulator.shards)
    else:
        optimizer = torch.optim.AdamW(params.values(), lr=args.lr,
                                      weight_decay=1e-4)
    rows = args.batch_size // args.data_parallel
    if mesh is not None:
        step_fn = make_train_step(emulator, lm_loss)
    else:
        step_fn = make_train_step(
            emulator, loss_of(model, args.n_experts > 0,
                              None if shard is None
                              else args.batch_size * (args.seq_len - 1)),
            shard=shard)
    opt_state = init_train_state(optimizer)

    start_step = 0
    if args.checkpoint_dir and args.resume_step is not None:
        opt_state, start_step = resume(args, params, optimizer, opt_state,
                                       emulator)
        log_line(f"resumed from step {start_step}")

    key = prng.key(0)
    log = MetricLogger()
    losses, step_s = [], []
    for step in range(start_step, args.steps):
        batch = batch_of(key, step, args, cfg.vocab_size, device)
        if shard is not None:
            batch = batch[rank * rows:(rank + 1) * rows]
        elif mesh is not None:
            batch = lm_batch(batch, mesh)
        sync(device)
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, batch,
                                          prng.fold_in(key, step))
        loss = float(loss)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        log.update(loss=loss, tokens_per_s=args.batch_size * args.seq_len
                   / step_s[-1])
        if step % 10 == 0:
            log_line(f"step {step}: {log}")
        if args.checkpoint_dir and step and step % CHECKPOINT_EVERY == 0:
            save(args, step, params, optimizer, opt_state, emulator, rank)
    log_line(f"final: {log}")
    tokens = args.batch_size * args.seq_len
    return {"lines": log_line.lines, "losses": losses, "step_s": step_s,
            "tokens_per_s": [tokens / s for s in step_s],
            "loss_scale": opt_state[1], "params": params,
            "optimizer": optimizer, "emulator": emulator}


if __name__ == "__main__":
    main()
