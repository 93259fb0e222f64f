"""Perplexity parity harness: delta-PPL of FP8 emulation against full
precision for the decoder family; the port of the JAX package's
``examples/eval_ppl.py``.  Teacher-forced PPL over token sequences for the
fp32 model and each requested quantization policy (``quantize_model``;
its casts run on K1 on the card).

A delta-PPL gate means something only on a trained model, so by default
the decoder first trains (torch.optim.AdamW, a cosine schedule from 3e-3)
on the bundled structured corpus (order-2 Markov + induction,
``fp8tpu_torch.data``):

    python -m fp8tpu_torch.examples.eval_ppl --dtypes e4m3 e3m4 hybrid \\
        --train 1000

``--train 0 --tokens_npz data.npz`` evaluates your own data; ``--ckpt DIR
STEP`` loads trained weights written by ``utils.save_checkpoint`` (the
JAX package's checkpoints load too).
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fp8tpu_torch import quantize_model
from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.data import mixed_lm_corpus
from fp8tpu_torch.examples._common import (Clock, Log, add_device_flag,
                                           from_flax, random_decoder)
from fp8tpu_torch.models import tiny_config


def ppl_of(apply_fn, tokens: torch.Tensor, batch: int = 8) -> float:
    """exp(mean next-token cross-entropy) under teacher forcing."""
    tot, n = 0.0, 0
    with torch.no_grad():
        for i in range(0, tokens.shape[0], batch):
            tb = tokens[i:i + batch]
            logits = apply_fn(tb[:, :-1])
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 tb[:, 1:].reshape(-1), reduction="sum")
            tot += float(ce)
            n += tb[:, 1:].numel()
    return float(np.exp(tot / max(n, 1)))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtypes", nargs="+", default=["e4m3", "hybrid"])
    ap.add_argument("--tokens_npz", default=None)
    ap.add_argument("--ckpt", nargs=2, metavar=("DIR", "STEP"),
                    default=None, help="load trained params")
    ap.add_argument("--train", type=int, default=800,
                    help="bf16 training steps before eval (0 = skip; "
                         "untrained delta-PPL is structurally meaningless)")
    ap.add_argument("--num_seqs", type=int, default=64)
    ap.add_argument("--seq_len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--exempt-head", action="store_true", default=True)
    add_device_flag(ap)
    return ap.parse_args(argv)


def train(model, train_toks: np.ndarray, steps: int, device, log) -> None:
    """AdamW (b2 0.98, weight decay 0.01) under a cosine decay from 3e-3
    to 0 over ``steps`` (optax's ``cosine_decay_schedule``), on batches of
    32 sequences drawn by ``default_rng(0)``, as the JAX script does."""
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3, betas=(0.9, 0.98),
                            eps=1e-8, weight_decay=0.01)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 0.5 * (1 + math.cos(math.pi * min(t, steps) / steps)))
    rng = np.random.default_rng(0)
    model.train()
    for i in range(steps):
        idx = rng.integers(0, len(train_toks), 32)
        batch = torch.from_numpy(train_toks[idx]).long().to(device)
        logits = model(batch[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch[:, 1:].reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if (i + 1) % max(steps // 4, 1) == 0:
            log(f"train {i+1}/{steps} loss {float(loss.detach()):.4f}")
    model.eval()


def main(argv=None, variables: Optional[Dict] = None) -> Dict:
    args = parse(argv)
    device = resolve_device(args.device)
    log = Log()
    vocab = 64 if args.tokens_npz is None else 2048
    cfg = tiny_config(n_layers=args.layers, d_model=args.d_model,
                      n_heads=8, n_kv_heads=4, d_ff=args.d_model * 3,
                      vocab_size=vocab, max_seq_len=args.seq_len)

    if args.tokens_npz:
        tokens_np = np.load(args.tokens_npz)["tokens"]
        train_toks = tokens_np
    else:
        tokens_np = mixed_lm_corpus(args.num_seqs, args.seq_len, vocab,
                                    seed=777)
        train_toks = mixed_lm_corpus(8192, args.seq_len, vocab, seed=0)
    tokens = torch.from_numpy(np.asarray(tokens_np)).long().to(device)

    model = from_flax(random_decoder(cfg, device, seed=1), variables)
    model.eval()
    # tokens a second: trained on, and scored by each policy's eval
    rates: Dict[str, float] = {}
    scored = tokens.shape[0] * (tokens.shape[1] - 1)
    if args.ckpt:
        from fp8tpu_torch.models import variables_from_flax, variables_to_flax
        from fp8tpu_torch.quant.interceptor import build_module_table
        from fp8tpu_torch.utils.checkpoint import restore_checkpoint
        template = variables_to_flax(dict(model.named_parameters()),
                                     build_module_table(model))
        restored = restore_checkpoint(args.ckpt[0], int(args.ckpt[1]),
                                      {"params": template})["state"]
        model.load_state_dict({k: v.to(device) for k, v in
                               variables_from_flax(restored["params"])
                               .items()})
        log(f"loaded checkpoint {args.ckpt[0]} step {args.ckpt[1]}")
    elif args.train > 0:
        with Clock(device) as clock:
            train(model, train_toks, args.train, device, log)
        rates["train"] = (args.train * 32 * (train_toks.shape[1] - 1)
                          / clock.seconds)
    else:
        log("WARNING: evaluating RANDOM weights — ΔPPL will be "
            "structurally negligible; pass --train or --ckpt")

    with Clock(device) as clock:
        base = ppl_of(model, tokens)
    rates["fp32"] = scored / clock.seconds
    log(f"{'policy':10s} {'ppl':>10s} {'Δppl':>8s}")
    log(f"{'fp32':10s} {base:10.4f} {0.0:8.4f}")
    result = {"lines": log.lines, "ppl": {"fp32": base}, "model": model,
              "tokens_per_s": rates}

    calib = [tokens[:8, :-1]]
    exempt = ("embed",) if args.exempt_head else ()
    for dtype in args.dtypes:
        qm = quantize_model(model, (tokens[:1],), dtype=dtype,
                            calibration_batches=calib,
                            list_exempt_layers=exempt, device=device)
        with Clock(device) as clock:
            p = ppl_of(qm, tokens)
        rates[dtype] = scored / clock.seconds
        log(f"{dtype:10s} {p:10.4f} {p - base:8.4f}")
        result["ppl"][dtype] = p
    return result


if __name__ == "__main__":
    main()
