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
logs and checkpoints.  Model parallelism (>1) and MoE under data
parallelism wait for tensor parallelism inside the models and raise.
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
from fp8tpu_torch.examples._common import (PARALLEL, Log, add_device_flag,
                                           from_flax, random_decoder, sync)
from fp8tpu_torch.models import variables_from_flax, variables_to_flax
from fp8tpu_torch.models.transformer import DecoderConfig, moe_aux_loss
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.training import (adamw_8bit, init_train_state,
                                   make_train_step)
from fp8tpu_torch.utils import (MetricLogger, restore_checkpoint,
                                save_checkpoint)


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
    """(this rank's ``BatchShard``, its rank) for ``--data-parallel N``:
    the world must be N processes (torchrun's), raising before any process
    group is made when it is not; (None, 0) for N = 1."""
    n = args.data_parallel
    if n == 1:
        return None, 0
    if args.n_experts:
        raise NotImplementedError(
            "--data-parallel with --n-experts: capacity routing over the "
            "global batch needs the MoE decoder under MOE_PARAM_RULES "
            "(ROADMAP §1 item 7d)")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world != n:
        raise ValueError(
            f"--data-parallel {n} runs as {n} processes (this world has "
            f"{world}): python -m torch.distributed.run --nproc-per-node "
            f"{n} -m fp8tpu_torch.examples.train_fp8 --data-parallel {n}")
    if args.batch_size % n:
        raise ValueError(f"--batch-size {args.batch_size} does not split "
                         f"over {n} ranks")
    from fp8tpu_torch.parallel import BatchShard, init_world, make_mesh
    init_world(device)
    shard = BatchShard.of(make_mesh(data=n).group("data"))
    return shard, shard.index


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


def main(argv=None, variables: Optional[Dict] = None) -> Dict:
    args = parse(argv)
    if args.model_parallel > 1:
        raise NotImplementedError("--model-parallel > 1 needs " + PARALLEL)
    device = resolve_device(args.device)
    shard, rank = data_parallel(args, device)
    if shard is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    log_line = Log(quiet=rank != 0)
    cfg = config(args)
    model = from_flax(random_decoder(cfg, device, seed=0), variables)

    emulator = initialize(model, training_algo=args.training_algo,
                          master_fmt=args.master_fmt, emb_fmt=args.emb_fmt,
                          device=device)
    params = dict(model.named_parameters())
    if args.opt8:
        optimizer = adamw_8bit(params, args.lr,       # int8 / e4m3 moments
                               module_table=emulator.module_table)
    else:
        optimizer = torch.optim.AdamW(params.values(), lr=args.lr,
                                      weight_decay=1e-4)
    rows = args.batch_size // args.data_parallel
    step_fn = make_train_step(
        emulator, loss_of(model, args.n_experts > 0,
                          None if shard is None
                          else args.batch_size * (args.seq_len - 1)),
        shard=shard)
    opt_state = init_train_state(optimizer)

    start_step = 0
    if args.checkpoint_dir and args.resume_step is not None:
        inner = optimizer if args.opt8 else _adamw_tree(optimizer, params)
        out = restore_checkpoint(args.checkpoint_dir, args.resume_step, {
            "params": variables_to_flax(params, emulator.module_table),
            "opt_state": (inner, opt_state[1])})
        with torch.no_grad():
            for n, t in variables_from_flax(out["state"]["params"]).items():
                params[n].copy_(t)
        if not args.opt8:
            _load_adamw(optimizer, out["state"]["opt_state"][0], params)
        opt_state = (optimizer, out["state"]["opt_state"][1])
        start_step = out["meta"]["step"]
        log_line(f"resumed from step {start_step}")

    key = prng.key(0)
    log = MetricLogger()
    losses, step_s = [], []
    for step in range(start_step, args.steps):
        batch = batch_of(key, step, args, cfg.vocab_size, device)
        if shard is not None:
            batch = batch[rank * rows:(rank + 1) * rows]
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
        if (args.checkpoint_dir and step and step % CHECKPOINT_EVERY == 0
                and rank == 0):
            inner = optimizer if args.opt8 else _adamw_tree(optimizer, params)
            save_checkpoint(args.checkpoint_dir, step,
                            variables_to_flax(params, emulator.module_table),
                            (inner, opt_state[1]), policy=emulator.policy)
    log_line(f"final: {log}")
    tokens = args.batch_size * args.seq_len
    return {"lines": log_line.lines, "losses": losses, "step_s": step_s,
            "tokens_per_s": [tokens / s for s in step_s],
            "loss_scale": opt_state[1], "params": params,
            "optimizer": optimizer, "emulator": emulator}


if __name__ == "__main__":
    main()
