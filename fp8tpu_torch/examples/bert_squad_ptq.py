"""BERT question-answering PTQ inference, the port of the JAX package's
``examples/bert_squad_ptq.py`` (the reference's run_squad.py flow,
examples/inference/bert/run_squad.py:436-489): a QA model whose attention
matmuls and residual adds are wrapper modules (modeling_bert.py:251-252,
370, 450) is quantized at eval time with

  * the QA output head exempt (run_squad.py:436-441), and
  * the attention-score matmul outputs left uncast
    (attn_scores_matmul fusion list, run_squad.py:442-466),

then evaluated span-prediction style.  Synthetic tokens by default
(``randint(key(0), ...)``, bit-equal to the JAX script's); ``--data_npz``
takes {input_ids, attention_mask, start, end}, and ``--squad_json`` with
``--vocab`` a SQuAD file through ``fp8tpu_torch.data.squad``.  On the
card the casts run on K1.

    python -m fp8tpu_torch.examples.bert_squad_ptq --dtype hybrid
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from fp8tpu_torch import quantize_model
from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.examples._common import Log, add_device_flag, from_flax
from fp8tpu_torch.models.bert import (BERT_OUTPUT_FUSED, BERT_QA_EXEMPT,
                                      bert_for_qa, tiny_bert)
from fp8tpu_torch.numerics import prng


def exact_match(start_logits, end_logits, start, end) -> float:
    ps, pe = start_logits.argmax(-1), end_logits.argmax(-1)
    return float(((ps == start) & (pe == end)).float().mean() * 100)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="hybrid",
                    choices=["e4m3", "e3m4", "hybrid", "e5m2"])
    ap.add_argument("--seq_len", type=int, default=128)
    ap.add_argument("--num_samples", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--data_npz", default=None)
    ap.add_argument("--squad_json", default=None,
                    help="real SQuAD v1.1/v2 JSON (needs --vocab)")
    ap.add_argument("--vocab", default=None,
                    help="BERT vocab.txt for --squad_json")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.squad_json and not args.vocab:
        ap.error("--squad_json needs --vocab")
    return args


def load_inputs(args, vocab_size: int, device):
    """(input_ids, attention_mask, start, end) on ``device``."""
    if args.data_npz:
        d = np.load(args.data_npz)
        ids = torch.from_numpy(d["input_ids"].astype(np.int64))
        mask = torch.from_numpy(d["attention_mask"].astype(np.int64))
        start = torch.from_numpy(np.asarray(d["start"]).astype(np.int64))
        end = torch.from_numpy(np.asarray(d["end"]).astype(np.int64))
    else:
        ids = prng.randint(prng.key(0), 0, vocab_size,
                           (args.num_samples, args.seq_len))
        mask = torch.ones_like(ids)
        start = prng.randint(prng.key(1), 0, args.seq_len,
                             (args.num_samples,))
        end = start + 1
    return tuple(t.to(device) for t in (ids, mask, start, end))


def main(argv=None, variables: Optional[Dict] = None) -> Dict:
    args = parse(argv)
    device = resolve_device(args.device)
    log_line = Log()
    if args.squad_json:
        # Real SQuAD through the native feature pipeline (run_squad.py:
        # 699-706 semantics) -> the same npz tensors.
        from fp8tpu_torch.data.squad import squad_to_npz
        fd, args.data_npz = tempfile.mkstemp(suffix=".npz")
        os.close(fd)
        n = squad_to_npz(args.squad_json, args.vocab, args.data_npz,
                         max_seq_length=args.seq_len, doc_stride=128)
        log_line(f"converted {n} features from {args.squad_json}")

    cfg = tiny_bert(n_layers=args.layers)
    model = from_flax(bert_for_qa(cfg, device,
                                  torch.Generator(device).manual_seed(2)),
                      variables).eval()
    ids, mask, start, end = load_inputs(args, cfg.vocab_size, device)
    if args.squad_json:
        os.remove(args.data_npz)

    with torch.no_grad():
        s0, e0 = model(ids, mask)
    em_fp32 = exact_match(s0, e0, start, end)

    # The reference policy: exempt the qa_outputs head; fuse (leave
    # uncast) the attention-score matmul outputs of every layer.
    qm = quantize_model(model, (ids[:1], mask[:1]), dtype=args.dtype,
                        calibration_batches=[(ids[:16], mask[:16])],
                        list_exempt_layers=BERT_QA_EXEMPT,
                        list_layers_output_fused=BERT_OUTPUT_FUSED,
                        device=device)
    with torch.no_grad():
        s1, e1 = qm(ids, mask)
    em_q = exact_match(s1, e1, start, end)

    drift = float((s1 - s0).abs().mean())
    log_line(f"fp32 EM {em_fp32:.2f} | {args.dtype} EM {em_q:.2f} | "
             f"mean |Δ start-logit| {drift:.4f}")
    return {"lines": log_line.lines, "em": {"fp32": em_fp32,
                                            args.dtype: em_q},
            "drift": drift, "logits": {"fp32": (s0, e0),
                                       args.dtype: (s1, e1)},
            "sequences": ids.shape[0]}


if __name__ == "__main__":
    main()
