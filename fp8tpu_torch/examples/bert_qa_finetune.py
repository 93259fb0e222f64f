"""BERT QA FP8 fine-tuning, the port of the JAX package's
``examples/bert_qa_finetune.py`` (the reference's accelerate-based SQuAD
flow, examples/training/bert/run_qa_no_trainer.py:810-930): initialize
the FP8 emulator after the optimizer, exempt the qa_outputs head, and
fuse the attention-score matmul outputs; train through ``make_train_step``
with ``torch.optim.AdamW`` at optax's ``adamw`` defaults (b1 0.9, b2
0.999, eps 1e-8, weight decay 1e-4).

Data is synthetic but learnable: the answer span's tokens are drawn from
a distinct half of the vocabulary (NumPy draws seeded from
``randint(fold_in(fold_in(key(0), step), 1))``, the JAX script's batches),
so the model learns to point at the marked region and the SQuAD EM / F1
(``utils.metrics.squad_em_f1``) rise above chance.  ``--squad_json`` with
``--vocab`` fine-tunes on a SQuAD file's doc-span features and reports
string-level EM / F1 through ``fp8tpu_torch.data.squad``.

    python -m fp8tpu_torch.examples.bert_qa_finetune --steps 30
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from fp8tpu_torch import initialize
from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.examples._common import (Log, add_device_flag, from_flax,
                                           sync)
from fp8tpu_torch.models.bert import (BERT_OUTPUT_FUSED, BERT_QA_EXEMPT,
                                      bert_for_qa, tiny_bert)
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.training import init_train_state, make_train_step
from fp8tpu_torch.utils import MetricLogger
from fp8tpu_torch.utils.metrics import beam_search_spans, squad_em_f1


def make_batch(key, batch_size: int, seq_len: int, vocab_size: int):
    """Context tokens from [0, V/2); the answer span from [V/2, V): the
    JAX script's NumPy draws from the seed ``randint(key, (), 0,
    2^31 - 1)``.  Returns (ids, starts, ends) as int64 arrays."""
    rng = np.random.default_rng(prng.randint(key, 0, 2 ** 31 - 1))
    ids = rng.integers(0, vocab_size // 2, (batch_size, seq_len))
    starts = rng.integers(0, seq_len - 8, batch_size)
    lengths = rng.integers(1, 6, batch_size)
    ends = np.minimum(starts + lengths, seq_len - 1)
    for b in range(batch_size):
        ids[b, starts[b]:ends[b] + 1] = rng.integers(
            vocab_size // 2, vocab_size, ends[b] - starts[b] + 1)
    return ids, starts, ends


def xent(logits, labels):
    """optax's ``softmax_cross_entropy_with_integer_labels``, op for op:
    ``jax.nn.logsumexp`` (the log of the sum of exp of the logits less
    their constant max, plus the max) less the label's logit; one value a
    row."""
    top = logits.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - top).sum(-1)) + top[..., 0]
    return lse - torch.take_along_dim(logits, labels[..., None], -1)[..., 0]


def loss_fn(apply_fn, params, batch):
    ids, mask, types, starts, ends = batch
    s_logits, e_logits = apply_fn(params, ids, mask, types)
    return (xent(s_logits, starts).mean() + xent(e_logits, ends).mean()) / 2


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--training-algo", default="hybrid",
                   choices=["direct", "hybrid", "bfloat16"])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--squad_json", default=None,
                   help="real SQuAD v1.1/v2 train JSON (needs --vocab): "
                        "fine-tune on doc-span features and report "
                        "string-level EM/F1 via the official decode")
    p.add_argument("--vocab", default=None)
    add_device_flag(p)
    args = p.parse_args(argv)
    if args.squad_json and not args.vocab:
        p.error("--squad_json needs --vocab")
    return args


def main(argv=None, variables: Optional[Dict] = None) -> Dict:
    args = parse(argv)
    device = resolve_device(args.device)
    log_line = Log()

    squad = None
    if args.squad_json:
        # The reference flow end to end (run_qa_no_trainer.py): JSON ->
        # WordPiece doc-span features -> fine-tune -> answer-string decode
        # -> official EM/F1.
        from fp8tpu_torch.data.squad import (WordPieceTokenizer,
                                             convert_examples_to_features,
                                             parse_squad_json)
        tokenizer = WordPieceTokenizer(args.vocab)
        examples = parse_squad_json(args.squad_json)
        feats = convert_examples_to_features(
            examples, tokenizer, max_seq_length=args.seq_len,
            doc_stride=max(args.seq_len // 4, 16),
            max_query_length=min(64, args.seq_len // 2))
        squad = (examples, feats)
        vocab_size = len(tokenizer.vocab)
        log_line(f"{len(examples)} examples → {feats.input_ids.shape[0]} "
                 f"features (vocab {vocab_size})")
        cfg = tiny_bert(max_position=args.seq_len, vocab_size=vocab_size)
    else:
        cfg = tiny_bert(max_position=args.seq_len)
    model = from_flax(bert_for_qa(cfg, device,
                                  torch.Generator(device).manual_seed(0)),
                      variables)

    emulator = initialize(model, training_algo=args.training_algo,
                          exempt_layers=BERT_QA_EXEMPT, device=device)
    emulator = dataclasses.replace(
        emulator, policy=emulator.policy.with_output_fused(*BERT_OUTPUT_FUSED))
    params = dict(model.named_parameters())
    optimizer = torch.optim.AdamW(params.values(), lr=args.lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)

    def on_device(*arrays):
        return tuple(torch.from_numpy(np.asarray(a)).to(device)
                     for a in arrays)

    def features(f, idx):
        """(ids, mask, types) of the features ``idx``."""
        return on_device(f.input_ids[idx].astype(np.int64),
                         f.attention_mask[idx].astype(bool),
                         f.token_type_ids[idx].astype(np.int64))

    def get_batch(i, k):
        if squad is not None:
            _, f = squad
            rng = np.random.default_rng(i)
            idx = rng.integers(0, f.input_ids.shape[0], args.batch_size)
            return features(f, idx) + on_device(f.start[idx].astype(np.int64),
                                                f.end[idx].astype(np.int64))
        ids, starts, ends = make_batch(prng.fold_in(k, 1), args.batch_size,
                                       args.seq_len, cfg.vocab_size)
        return on_device(ids, np.ones(ids.shape, bool), np.zeros_like(ids),
                         starts, ends)

    step_fn = make_train_step(emulator, loss_fn)
    opt_state = init_train_state(optimizer)
    key = prng.key(0)
    log = MetricLogger()
    losses, step_s = [], []
    for i in range(args.steps):
        k = prng.fold_in(key, i)
        batch = get_batch(i, k)
        sync(device)
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, batch, k)
        loss = float(loss)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        log.update(loss=loss)
        if i % 10 == 0:
            log_line(f"step {i}: {log}")
    log_line(f"final: {log}")
    result = {"lines": log_line.lines, "losses": losses, "step_s": step_s,
              "sequences_per_s": [args.batch_size / s for s in step_s],
              "params": params, "emulator": emulator}

    if squad is not None:
        # Answer-string decode + official EM/F1 over the fine-tuned set
        # (compute_predictions_logits + evaluate-v1.1 semantics).
        from fp8tpu_torch.data.squad import (decode_answers,
                                             squad_string_em_f1)
        examples, f = squad
        sls, els = [], []
        n = f.input_ids.shape[0]
        with torch.no_grad():
            for j in range(0, n, args.batch_size):
                sl, el = model(*features(f, slice(j, j + args.batch_size)))
                sls.append(sl.cpu().numpy())
                els.append(el.cpu().numpy())
        preds = decode_answers(f, examples, np.concatenate(sls),
                               np.concatenate(els))
        m = squad_string_em_f1(preds, examples)
        log_line(f"SQuAD string metrics: exact_match {m['exact_match']:.2f}"
                 f" f1 {m['f1']:.2f}")
        result["squad"] = m
        return result

    # SQuAD-style evaluation (run_qa_no_trainer.py's `squad` metric at
    # span level): argmax spans and n-best beam-searched spans (the
    # run_qa_beam_search_no_trainer.py decode, valid-pair constrained).
    ps, pe, bs_, be, gs, ge = [], [], [], [], [], []
    with torch.no_grad():
        for j in range(8):
            ids, starts, ends = make_batch(prng.fold_in(key, 10_000 + j),
                                           args.batch_size, args.seq_len,
                                           cfg.vocab_size)
            s_logits, e_logits = model(torch.from_numpy(ids).to(device))
            ps.append(s_logits.argmax(-1).cpu().numpy())
            pe.append(e_logits.argmax(-1).cpu().numpy())
            b_s, b_e = beam_search_spans(s_logits, e_logits, n_best=20,
                                         max_answer_len=8)
            bs_.append(b_s)
            be.append(b_e)
            gs.append(starts)
            ge.append(ends)
    m = squad_em_f1(np.concatenate(ps), np.concatenate(pe),
                    np.concatenate(gs), np.concatenate(ge))
    mb = squad_em_f1(np.concatenate(bs_), np.concatenate(be),
                     np.concatenate(gs), np.concatenate(ge))
    log_line(f"eval argmax: exact_match {m['exact_match']:.2f} "
             f"f1 {m['f1']:.2f}")
    log_line(f"eval beam:   exact_match {mb['exact_match']:.2f} "
             f"f1 {mb['f1']:.2f}")
    result["eval"] = {"argmax": m, "beam": mb}
    return result


if __name__ == "__main__":
    main()
